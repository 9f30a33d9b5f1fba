"""The world-2 jobs of tests/test_torch_parallel.py: each rank of a gloo
group, in a process the test spawns, runs every job and returns its
results. It imports the port only (torch, numpy), never JAX: the parent
computes the references.
"""

from __future__ import annotations

import tempfile

import numpy as np


def run(rank: int, world: int, init_method: str, jobs: list) -> dict:
    """Join the group, run ``jobs`` ((name, kwargs) pairs, the same on every
    rank, in order), leave the group; {name: result}."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        return {name: JOBS[name.split(":")[0]](**kwargs) for name, kwargs in jobs}
    finally:
        dist.destroy_process_group()


def dice(logits: np.ndarray, target: np.ndarray) -> dict:
    """The global-batch soft Dice of this rank's rows and their gradient."""
    import torch

    from csof_tpu_torch.ops.losses import soft_dice_loss
    from csof_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 1)
    rows = mesh.rows(len(logits))
    x = torch.from_numpy(logits[rows]).requires_grad_(True)
    loss = soft_dice_loss(x, torch.from_numpy(target[rows]), batch_dice=True, mesh=mesh)
    loss.backward()
    return {"loss": loss.item(), "grad": x.grad.numpy(), "rows": (rows.start, rows.stop)}


def capture_grads(trainer) -> dict:
    """{name: the gradient Optimizer.step sees (after DDP's average), None
    where there is none}, filled at each step."""
    grads: dict = {}
    step = trainer.optimizer.step

    def capturing_step():
        grads.update({n: None if p.grad is None else p.grad.detach().clone().numpy()
                      for n, p in trainer.model.named_parameters()})
        step()

    trainer.optimizer.step = capturing_step
    return grads


def train_step(config, batch: dict, plans=None, num_classes=None, params=None,
               mesh_kw: dict | None = None) -> dict:
    """One Trainer step on the global batch: the loss, the gradients and the
    parameters after the update. ``mesh_kw`` builds the mesh (else the
    Trainer builds it from the config); ``params`` (a flax tree) replace the
    drawn weights."""
    from csof_tpu_torch.compat.flax_import import load_flax_params
    from csof_tpu_torch.parallel.mesh import make_mesh
    from csof_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        mesh = None if mesh_kw is None else make_mesh(**mesh_kw)
        tr = Trainer(config, tmp, plans=plans, num_classes=num_classes, device="cpu",
                     mesh=mesh).initialize()
        if params is not None:
            load_flax_params(tr.model, params)
        return step_results(tr, batch)


def step_results(trainer, batch: dict) -> dict:
    """One step of ``trainer``: the loss, its Dice statistics (where the loss
    has them), the gradients and the parameters after the update."""
    grads = capture_grads(trainer)
    loss, aux = trainer.run_iteration(batch)
    return {"loss": loss, "grads": grads, "mesh": trainer.mesh.shape,
            "stats": {k: aux[k].numpy() for k in ("tp", "fp", "fn") if k in aux},
            "params": {n: p.detach().numpy() for n, p in trainer.model.named_parameters()}}


def train_run(config, out: str, plans, batches: list, val_batches: list) -> dict:
    """run_training into the folder ``out`` shared by the ranks."""
    from csof_tpu_torch.training.trainer import Trainer

    tr = Trainer(config, out, plans=plans, device="cpu").initialize()
    hist = tr.run_training(iter(batches), iter(val_batches), tensorboard=True)
    return {"train": hist.train_losses, "val": hist.val_losses, "dice": hist.eval_metrics,
            "main": tr.is_main_process, "saved": tr.save_checkpoint("model_extra.pt") is not None}


def predict(net_kw: dict, params, cfg_kw: dict, image: np.ndarray, tiles: np.ndarray) -> dict:
    """predict_sharded of a GenericUNet over the group, and
    sharded_tile_predict of ``tiles``."""
    from csof_tpu_torch.compat.flax_import import load_flax_params
    from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor
    from csof_tpu_torch.models.unet import GenericUNet
    from csof_tpu_torch.parallel.mesh import make_mesh
    from csof_tpu_torch.parallel.spmd_inference import sharded_tile_predict

    net = GenericUNet(**net_kw).eval()
    load_flax_params(net, params)
    pred = SlidingWindowPredictor(net, PredictorConfig(**cfg_kw), device="cpu")
    mesh = make_mesh(2, 1)
    seg, probs = pred.predict_sharded(image, mesh)
    return {"seg": seg, "probs": probs,
            "tile_probs": sharded_tile_predict(net, tiles, mesh, device="cpu")}


JOBS = {"dice": dice, "train_step": train_step, "train_run": train_run, "predict": predict}

"""One data-parallel training step of a tiny SegFlow on n processes: the
port's counterpart of ``__graft_entry__.dryrun_multichip``.

It runs the production ``Trainer`` on a ``(data = n, model = 1)`` mesh: the
batch split by rank, DDP's gradient average, rank-0 IO. Tiny shapes
(16^2, T = 2, d_model 8, float32): it checks that the sharded step runs,
not the flagship's geometry.
"""

from __future__ import annotations

import multiprocessing
import tempfile
from pathlib import Path

import numpy as np


def tiny_segflow_config():
    """The JAX dry run's configuration (``__graft_entry__._flagship(tiny=True)``)."""
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, SegFlowModelConfig

    segflow = SegFlowModelConfig(out_encoder_dims=(4, 8), d_model=8, bottleneck_heads=2,
                                 dim_feedforward=16, corr_radius=(1, 1), corr_stride=(1, 1),
                                 dtype="float32")
    return ExperimentConfig(model="segflow", segflow=segflow,
                            data=DataConfig(video_length=2, batch_size=1, crop_size=16),
                            max_num_epochs=1, num_batches_per_epoch=1,
                            num_val_batches_per_epoch=1)


def _rank_step(rank: int, world: int, init_method: str, device_type: str) -> float:
    """The step on one rank: join the group, train once on the global batch
    of ``world`` videos, leave the group. Returns the loss (the ranks' mean)."""
    import torch
    import torch.distributed as dist

    from csof_tpu_torch.parallel.mesh import make_mesh
    from csof_tpu_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    cuda = device_type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        if cuda:
            torch.cuda.set_device(device)
        rng = np.random.RandomState(0)
        b, t, hw = world, 2, 16
        batch = {"video": rng.rand(b, t, hw, hw, 1).astype(np.float32),
                 "seg": np.zeros((b, t, hw, hw), np.int32),
                 "labeled_mask": np.ones((b, t), np.float32)}
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(tiny_segflow_config(), tmp, num_classes=4, device=device,
                              mesh=make_mesh(world, 1, device)).initialize(batch)
            loss, _ = trainer.run_iteration(batch)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}")
        return loss
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cpu") -> float:
    """One sharded training step on ``n_devices`` processes it spawns: gloo
    on the CPU, or NCCL with one card a rank under ``device="cuda"`` (one
    card: world 1). Returns the step's loss; raises if a rank fails or the
    ranks' losses differ."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "store").as_uri()
        with ctx.Pool(n_devices) as pool:
            losses = pool.starmap(_rank_step, [(r, n_devices, init, device)
                                               for r in range(n_devices)])
    if len(set(losses)) != 1:
        raise RuntimeError(f"the ranks' losses differ: {losses}")
    return losses[0]

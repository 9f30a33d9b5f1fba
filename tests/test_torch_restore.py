"""Restoring a JAX-trained folder in the port (``training/restore.py``,
``compat/flax_import.py`` ``load_flax_train_state``, the msgpack triad in
``training/checkpoint.py``): a JAX ``Trainer`` on a small SegFlow and a
small U-Net takes a step and saves its checkpoint and sidecars; the port's
``restore_trainer`` reads them and gives the same forward (float32, within
1e-5). Then the next step, augmentation off, for AdamW under the warm-up
cosine and for SGD-Nesterov under poly:

- the restored optimizer state continues as optax does: the same JAX
  gradient into both optimizers gives the same parameters (each tensor
  within 1e-5 of its largest entry);
- a whole step on each side (``run_iteration``): the gradients agree
  (within 1e-4 of each tensor's largest entry + 1e-6, float32 reduction
  order),
  and under SGD the parameters too (1e-5 as above). Under AdamW the
  parameters of a whole step are not compared entry by entry: AdamW
  divides each entry's gradient by its own running magnitude, so rounding
  noise in a gradient that is small or zero in exact arithmetic (a bias
  right ahead of a normalisation has none) becomes a step of up to the
  learning rate, in either package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_unet import _plans

from csof_tpu.config import experiment as jexp
from csof_tpu.config import plans as jplans
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.training import restore as jrestore
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.compat.flax_import import flax_to_torch_arrays
from csof_tpu_torch.training import checkpoint as ckpt
from csof_tpu_torch.training.restore import (
    load_pretrained_weights,
    restore_trainer,
    save_trainer_sidecar,
)

torch_threads.pin()

FWD_TOL = 1e-5  # float32 forward: the same math, summed in another order
STEP_TOL = 1e-5  # next-step parameters, relative to each tensor's largest entry
#: gradients of a whole step: within 1e-4 of each tensor's largest entry + 1e-6
#: (a gradient that is zero in exact arithmetic is rounding noise on both sides)
GRAD_TOL = 1e-4
SMALL = jexp.SegFlowModelConfig(out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2,
                                dim_feedforward=32, corr_radius=(2, 2), corr_stride=(2, 1),
                                dtype="float32")
# AdamW at the config's default learning rate, SGD at nnU-Net's
OPTIM = {"adamw": dict(optimizer="adamw", scheduler="cosine", initial_lr=1e-4),
         "sgd": dict(optimizer="sgd", scheduler="poly", initial_lr=1e-2, weight_decay=3e-5)}


def _config(model: str, optim: str) -> jexp.ExperimentConfig:
    return jexp.ExperimentConfig(model=model, segflow=SMALL, max_num_epochs=1,
                                 num_batches_per_epoch=10, optim=jexp.OptimConfig(**OPTIM[optim]),
                                 loss_weights=jexp.LossWeights(segmentation=1.0),
                                 data=jexp.DataConfig(do_data_aug=False))


def _batch(model: str, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    if model == "segflow":
        seg = rng.randint(0, 4, (1, 3, 16, 16)).astype(np.int32)
        seg[:, 1] = -1  # an unlabelled frame
        return {"video": rng.rand(1, 3, 16, 16, 1).astype(np.float32), "seg": seg,
                "labeled_mask": np.array([[1.0, 0.0, 1.0]], np.float32)}
    spatial = (8, 16, 16) if model == "unet3d" else (32, 32)
    seg = rng.randint(0, 3, (2, *spatial)).astype(np.int32)
    return {"data": (rng.randn(2, *spatial, 1) + seg[..., None]).astype(np.float32), "seg": seg}


def _filled_params(model, example):
    """The model's variables: the shapes of its init (traced, not run),
    filled from a seed (kernels N(0, 1/fan_in), scales near 1, biases near 0)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *example)
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((name == "scale") + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _plans3d():
    """Small 3D plans (remat on with save_conv, as every 3D plan's U-Net in
    JAX): base 8, pools (1, 2, 2), (2, 2, 2), 8x16x16 patches, 3 classes."""
    plans = _plans(jplans, patch=(16, 16))
    stage = plans.plans_per_stage[0]
    stage.patch_size, stage.current_spacing = (8, 16, 16), (2.0, 1.25, 1.25)
    stage.original_spacing = stage.current_spacing
    stage.pool_op_kernel_sizes = [[1, 2, 2], [2, 2, 2]]
    stage.conv_kernel_sizes = [[1, 3, 3], [3, 3, 3], [3, 3, 3]]
    return plans


def _jax_folder(tmp_path, model: str, optim: str):
    """A JAX results folder after one train step: sidecars and the msgpack
    triad's final checkpoint. Returns the JAX trainer."""
    config = _config(model, optim)
    cls = JaxSegFlow if model == "segflow" else JaxUNet
    # the U-Net of small 2D plans: base 8, two pools, 32^2 patches, 3 classes
    plans = (None if model == "segflow" else _plans3d() if model == "unet3d"
             else _plans(jplans, patch=(32, 32)))
    example = _batch(model, 0)
    first = example["video"][0] if model == "segflow" else example["data"][:1]
    with pytest.MonkeyPatch.context() as mp:
        for var in ("CSOF_CONV2D_IMPL", "CSOF_FUSED_NORM"):
            mp.delenv(var, raising=False)
        # the eager flax init of the model takes most of a minute on the CPU;
        # the trainer gets the same tree's shapes filled from a seed instead
        params = _filled_params(jtrainer.build_model(config, plans, num_classes=4), (first,))
        mp.setattr(cls, "init", lambda self, rng, *x: params)
        tr = jtrainer.Trainer(config, tmp_path, plans=plans, num_classes=4, example_batch=example)
    tr.run_iteration(_batch(model, 1))
    tr.save_checkpoint(jtrainer.ckpt.FINAL)
    jrestore.save_trainer_sidecar(tmp_path, config, plans,
                                  4 if plans is None else plans.num_classes_with_background)
    return tr


_JITTED = {}  # (model, what) -> jitted function, shared by the optimizer cases


def _jitted(tr, model: str, what: str):
    if (model, what) not in _JITTED:
        if what == "grad":
            fn = jax.grad(lambda p, b: tr.loss_fn(p, b)[0])
        elif model == "segflow":
            fn = lambda p, v: jax.vmap(lambda x: tr.model.apply(p, x))(v)  # noqa: E731
        else:
            fn = tr.model.apply
        _JITTED[model, what] = jax.jit(fn)
    return _JITTED[model, what]


def _jax_forward(tr, model: str, batch: dict):
    fwd = _jitted(tr, model, "forward")
    if model == "segflow":
        out = fwd(tr.state.params, jnp.asarray(batch["video"]))
        return {k: np.asarray(out[k]) for k in ("seg_logits", "cum_flow", "registered")}
    out = fwd(tr.state.params, jnp.asarray(batch["data"]))
    return {"logits": np.moveaxis(np.asarray(out[0]), -1, 1)}


def _port_forward(trainer, model: str, batch: dict):
    with torch.no_grad():
        if model == "segflow":
            out = trainer.model(torch.from_numpy(batch["video"]))
            return {k: out[k].numpy() for k in ("seg_logits", "cum_flow", "registered")}
        out = trainer.model(torch.from_numpy(batch["data"]).movedim(-1, 1).contiguous())
        return {"logits": out[0].numpy()}


@pytest.mark.parametrize("optim", ["adamw", "sgd"])
def test_a_jax_folder_restores_and_trains_on_in_the_port(optim, tmp_path):
    check_restore("segflow", optim, tmp_path)


def check_restore(model: str, optim: str, tmp_path, grad_tol: float = GRAD_TOL) -> None:
    """The checks of the module docstring for one model and optimizer (the
    U-Net's cases are in test_torch_restore_unet.py); ``grad_tol`` bounds
    the whole step's gradients."""
    tr = _jax_folder(tmp_path, model, optim)
    port = restore_trainer(tmp_path, device="cpu", for_training=True)
    assert port.checkpoint_format == "msgpack" and port.optimizer.count == 1
    assert port.epoch == tr.epoch and port.config.optim.optimizer == optim

    # the restored forward
    probe = _batch(model, 2)
    got, ref = _port_forward(port, model, probe), _jax_forward(tr, model, probe)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], atol=FWD_TOL, rtol=FWD_TOL, err_msg=key)

    # the next step from the same gradient: the restored optimizer state
    batch = _batch(model, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = _jitted(tr, model, "grad")(tr.state.params, jbatch)
    want = _torch_arrays(port.model, jgrads)
    for name, p in port.model.named_parameters():
        p.grad = torch.from_numpy(want[name].copy())
    port.optimizer.step()
    _assert_params(port.model, tr.state.apply_gradients(grads=jgrads).params)

    # a whole step on each side, from the checkpoint again
    port.load_checkpoint()
    assert port.optimizer.count == 1
    tr.run_iteration(batch)
    port.run_iteration(batch)
    assert port.optimizer.count == int(tr.state.step) == 2
    for name, p in port.model.named_parameters():
        ref = want[name]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= grad_tol * np.abs(ref).max() + 1e-6, f"gradient of {name}: error {err:.2e}"
    if optim == "sgd":
        _assert_params(port.model, tr.state.params)


def _torch_arrays(module, tree):
    return flax_to_torch_arrays(module, jax.tree_util.tree_map(np.asarray, tree["params"]))


def _assert_params(module, jax_params):
    want = _torch_arrays(module, jax_params)
    for name, p in module.named_parameters():
        ref = want[name]
        err = np.abs(p.detach().numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= STEP_TOL, f"{name}: relative error {err:.2e}"


def test_the_pt_format_wins_at_each_name_and_the_fallback_order_holds(tmp_path):
    # final.msgpack beside latest.pt: final comes first; at one name .pt
    # comes before .msgpack
    for name in ("model_final_checkpoint.msgpack", "model_latest.pt", "model_best.pt"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.find_checkpoint(tmp_path) == (tmp_path / "model_final_checkpoint.msgpack",
                                             "msgpack")
    (tmp_path / "model_final_checkpoint.pt").write_bytes(b"")
    assert ckpt.find_checkpoint(tmp_path) == (tmp_path / "model_final_checkpoint.pt", "pt")
    assert ckpt.find_checkpoint(tmp_path, "model_best") == (tmp_path / "model_best.pt", "pt")
    assert ckpt.find_checkpoint(tmp_path, "model_final_checkpoint.msgpack")[1] == "msgpack"
    with pytest.raises(FileNotFoundError):
        ckpt.find_checkpoint(tmp_path, "model_other")


def test_the_sidecars_are_the_jax_bytes(tmp_path):
    from csof_tpu_torch.config import experiment as texp
    from csof_tpu_torch.config.plans import Plans, task002_heart_2d

    plans = task002_heart_2d(num_classes=2)
    config = texp.ExperimentConfig(model="unet2d", fold=3)
    save_trainer_sidecar(tmp_path / "port", config, plans, 3)
    jconfig = jexp.ExperimentConfig.from_dict(dataclasses.asdict(config))
    plans.to_json(tmp_path / "plans.json")
    jrestore.save_trainer_sidecar(tmp_path / "jax", jconfig,
                                  jplans.Plans.from_json(tmp_path / "plans.json"), 3)
    for name in ("config.yaml", "plans.json", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert Plans.from_json(tmp_path / "jax" / "plans.json") == plans


def test_load_pretrained_weights_copies_where_path_and_shape_match():
    fresh = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1)}
    old = {"a": torch.ones(2, 3), "b": torch.ones(5), "d": torch.ones(1)}
    merged, loaded, kept = load_pretrained_weights(fresh, old)
    assert (loaded, kept) == (1, 2)
    assert torch.equal(merged["a"], old["a"]) and torch.equal(merged["b"], fresh["b"])
    assert torch.equal(merged["c"], fresh["c"]) and set(merged) == set(fresh)

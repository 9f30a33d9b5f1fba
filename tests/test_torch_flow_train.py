"""Training RAFT and VoxelMorph in the port, on the CPU: the losses of both
RAFT routes (the sequence loss with a ground-truth flow, the NCC +
smoothness of the last flow without) and of VoxelMorph, with every
gradient, against the JAX package's ``make_raft_loss`` /
``make_voxelmorph_loss`` on the same parameters and batch; then
``csof_torch_train`` on synthetic cines for both kinds: the batches it
feeds the models are the JAX entry's (RAFT: frame 0 and the last frame;
VoxelMorph: moving = the last frame, fixed = frame 0), the losses are
finite, the folder holds the sidecars and the checkpoint triad.

Tolerances: the loss within 1e-5 relative, each gradient within 2e-3 of its
largest entry + 1e-6 (float32, the same sums in another order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_raft import random_params

from csof_tpu.config import experiment as jexp
from csof_tpu.models.raft import FeatureEncoder as JaxFeatureEncoder
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.cli import main as cli
from csof_tpu_torch.compat.flax_import import flax_to_torch_arrays, load_flax_params
from csof_tpu_torch.config import experiment as texp
from csof_tpu_torch.data.loaders import VideoChunkLoader
from csof_tpu_torch.data.video_dataset import build_video_datasets, split_videos
from csof_tpu_torch.training import trainer
from csof_tpu_torch.utils import yaml_subset
from csof_tpu_torch.utils.logging import read_training_logs

torch_threads.pin()

RAFT_SMALL = dict(feature_dim=32, hidden_dim=16, context_dim=16, iters=2, corr_levels=2,
                  corr_radius=2, dtype="float32")
VXM_SMALL = dict(enc_features=(4, 8, 8), dec_features=(8, 8, 8, 4), int_steps=4,
                 dtype="float32")
#: csof_torch_train's configs: 2 steps + 1 validation batch of 2 pairs of
#: 32^2 crops (augmentation on in the config: RAFT and VoxelMorph are not
#: augmented, as in JAX)
TRAIN_CFG = {
    "raft": {"model": "raft", "max_num_epochs": 1, "num_batches_per_epoch": 2,
             "num_val_batches_per_epoch": 1, "raft": RAFT_SMALL,
             "data": {"video_length": 3, "batch_size": 2, "crop_size": 32}},
    "voxelmorph": {"model": "voxelmorph", "max_num_epochs": 1, "num_batches_per_epoch": 2,
                   "num_val_batches_per_epoch": 1,
                   "voxelmorph": {**VXM_SMALL, "enc_features": [4, 8, 8],
                                  "dec_features": [8, 8, 8, 4]},
                   "data": {"video_length": 3, "batch_size": 2, "crop_size": 32}},
}


_PARAMS = {}


def _check_loss_and_grads(kind: str, batch: dict, seed: int, weights: dict | None = None,
                          skip: str | None = None):
    """The loss, its metrics and every gradient but those of the submodule
    ``skip`` against JAX; returns the port's model (gradients kept), the
    JAX parameters and the JAX gradients in the port's layout."""
    jcfg, tcfg = (pkg.ExperimentConfig(model=kind, raft=pkg.RaftModelConfig(**RAFT_SMALL),
                                       voxelmorph=pkg.VoxelMorphModelConfig(**VXM_SMALL),
                                       loss_weights=pkg.LossWeights(**(weights or {})))
                  for pkg in (jexp, texp))
    jmodel = jtrainer.build_model(jcfg)
    first = ((batch["image1"][0], batch["image2"][0]) if kind == "raft"
             else (batch["moving"], batch["fixed"]))
    key = (kind, seed) + tuple(x.shape for x in first)
    if key not in _PARAMS:  # both RAFT routes share one model: one trace of its init
        _PARAMS[key] = random_params(jmodel, *map(jnp.asarray, first), seed=seed)
    params = _PARAMS[key]
    jloss = jtrainer.make_loss_fn(jcfg, jmodel)
    (ref, ref_aux), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = trainer.build_model(tcfg)
    load_flax_params(model, params)
    loss, aux = trainer.make_loss_fn(tcfg)(model, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    loss.backward()
    assert sorted(aux) == sorted(ref_aux)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=1e-5, err_msg=k)
    want = flax_to_torch_arrays(model, jax.tree_util.tree_map(np.asarray, ref_grads["params"]))
    for name, p in model.named_parameters():
        if skip is None or not name.startswith(skip + "."):
            _close(p.grad.numpy(), want[name], 2e-3, name)
    return model, params, want


def _close(got, ref, frac, name):
    np.testing.assert_allclose(got, ref, atol=frac * float(np.abs(ref).max()) + 1e-6, rtol=0,
                               err_msg=name)


def _images(rng, n=2, hw=32):
    yy, xx = np.mgrid[:hw, :hw] / hw
    base = np.sin(6 * yy + rng.rand(n, 1, 1)) * np.cos(5 * xx + rng.rand(n, 1, 1))
    return (0.5 + 0.4 * base + 0.05 * rng.rand(n, hw, hw))[..., None].astype(np.float32)


@jax.jit
def _jax_encoder_vjp(params, x, g):
    """The JAX FeatureEncoder's parameter gradient for output gradient g,
    per sample (the pairs batched); one trace for both routes."""
    enc = JaxFeatureEncoder(RAFT_SMALL["feature_dim"])
    return jax.vjp(lambda q: enc.apply({"params": q}, x), params)[1](g)[0]


@pytest.mark.parametrize("route", ["supervised", "unsupervised"])
def test_raft_loss_and_gradients_match_jax(route):
    """Supervised: the ground truth a smooth flow of up to 3 pixels, with one
    pixel past max_flow (left out by the validity mask).

    image1's feature encoder ends in the correlation, and its weight
    gradients are sums over pixels that nearly cancel. The JAX package's own
    float32 backward of that encoder (XLA on the CPU), fed the port's
    gradient of its output, is 2.4e-4 of the stem's largest entry off a
    float64 backward at one iteration and 2e-3 or more at two; the port's is
    3e-6 off. So that encoder's gradients are held to 1e-4 against a float64
    backward of the same output gradient, and against JAX's to 2e-3 plus
    twice the JAX backward's own measured deviation from that float64
    backward, tensor by tensor."""
    rng = np.random.RandomState(0 if route == "supervised" else 1)
    a = _images(rng)
    batch = {"image1": a, "image2": np.roll(a, (1, 2), axis=(1, 2))}
    if route == "supervised":
        yy, xx = np.mgrid[:32, :32] / 32
        gt = np.stack([2 * np.sin(3 * yy), 3 * np.cos(2 * xx)], -1)[None].repeat(2, 0)
        gt[0, 5, 7] = 500.0
        batch["flow_gt"] = gt.astype(np.float32)
    model, params, want = _check_loss_and_grads("raft", batch, seed=2, skip="FeatureEncoder_0")
    # image1's encoder: the gradient of its output, then its backward in
    # float64 (the port's layers in double) and in JAX's float32
    out_grad = {}

    def keep_output_grad(module, inputs, output):
        output.register_hook(lambda g: out_grad.setdefault("g", g.clone()))

    enc = model.FeatureEncoder_0
    hook = enc.register_forward_hook(keep_output_grad)
    model.zero_grad()
    trainer.make_loss_fn(texp.ExperimentConfig(
        model="raft", raft=texp.RaftModelConfig(**RAFT_SMALL)))(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})[0].backward()
    hook.remove()
    g_out = out_grad["g"]
    enc64 = copy.deepcopy(enc).double()
    for mod in enc64.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    enc64(torch.from_numpy(a).movedim(-1, 1).double()).backward(g_out.double())
    ref64 = {n: p.grad.numpy() for n, p in enc64.named_parameters()}
    jax_same = _jax_encoder_vjp(params["FeatureEncoder_0"], a,
                                g_out.permute(0, 2, 3, 1).numpy())
    jax_same = flax_to_torch_arrays(enc, jax.tree_util.tree_map(np.asarray, jax_same))
    for name, p in enc.named_parameters():
        r = ref64[name]
        _close(p.grad.double().numpy(), r, 1e-4, name)
        jax_err = float(np.abs(jax_same[name] - r).max() / max(np.abs(r).max(), 1e-30))
        _close(p.grad.numpy(), want[f"FeatureEncoder_0.{name}"], 2e-3 + 2 * jax_err, name)


def test_voxelmorph_loss_and_gradients_match_jax():
    rng = np.random.RandomState(3)
    a = _images(rng, n=3)
    _check_loss_and_grads("voxelmorph", {"moving": np.roll(a, 2, axis=2), "fixed": a}, seed=4,
                          weights=dict(image_flow_global=0.7, regularization_xy=0.3))


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    root = tmp_path_factory.mktemp("flow_train")
    cli.convert_acdc_entry(["-o", str(root / "task"), "--synthetic", "2"])
    return root / "task"


@pytest.mark.parametrize("kind", ["raft", "voxelmorph"])
def test_csof_torch_train_trains_the_flow_models(kind, task, tmp_path, monkeypatch):
    seen = []
    run_iteration = trainer.Trainer.run_iteration

    def record(self, batch, train=True):
        seen.append({k: np.array(v) for k, v in batch.items()})
        return run_iteration(self, batch, train)

    monkeypatch.setattr(trainer.Trainer, "run_iteration", record)
    (tmp_path / "exp.yaml").write_text(yaml_subset.safe_dump(TRAIN_CFG[kind]))
    cli.train_entry(["-c", str(tmp_path / "exp.yaml"), "-p", str(tmp_path), "-t", str(task),
                     "-o", str(tmp_path / "out"), "--device", "cpu"])
    fold = tmp_path / "out" / "fold_0"
    for name in ("config.yaml", "meta.json", "model_final_checkpoint.pt", "model_best.pt"):
        assert (fold / name).is_file(), name
    assert texp.load_experiment_config(fold / "config.yaml").model == kind
    (log,) = read_training_logs(fold)
    assert log[0].startswith("epoch 1: train ") and " val " in log[0]
    # the JAX entry's batches: frames of the loader's first chunk
    videos = build_video_datasets(task)
    tr_videos, _ = split_videos(videos, 0)
    first = next(VideoChunkLoader(tr_videos, video_length=3, batch_size=2, crop_size=32,
                                  seed=texp.ExperimentConfig().seed))["video"]
    want = ({"image1": first[:, 0], "image2": first[:, -1]} if kind == "raft"
            else {"moving": first[:, -1], "fixed": first[:, 0]})
    assert len(seen) == 3 and sorted(seen[0]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(seen[0][k], v, err_msg=k)
    state = torch.load(fold / "model_final_checkpoint.pt", weights_only=False)
    assert state["step"] == 2
    assert all(torch.isfinite(v).all() for v in state["model"].values())

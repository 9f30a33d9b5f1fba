"""Data-parallel training and sharded serving of the PyTorch port over
``torch.distributed`` against the JAX package on a 2-device mesh, on the
CPU: gloo at world 2 in two spawned processes (``torch_parallel_worker``,
which imports the port only), every world-2 job of this module run by one
spawn in a module fixture; the references (JAX, and the port at world 1)
are computed here. Small sizes: the 2D U-Net of base 8 on 64^2 patches,
the SegFlow of test_torch_train.py on 16^2 videos, float32.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker
import torch_threads
from test_torch_unet import _plans
from test_torch_unet_train import (
    GRAD_TOL,
    LOSS_RTOL,
    NET,
    PATCH,
    SGD,
    _flax_params,
    _seg_batch,
    _torch_layout,
)

from csof_tpu.config import experiment as jexp
from csof_tpu.config import plans as jplans
from csof_tpu.inference.predictor import PredictorConfig as JaxPredictorConfig
from csof_tpu.inference.predictor import SlidingWindowPredictor as JaxPredictor
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.ops import losses as jL
from csof_tpu.parallel.mesh import make_mesh as jax_make_mesh
from csof_tpu.parallel.mesh import shard_batch as jax_shard_batch
from csof_tpu.parallel.spmd_inference import sharded_tile_predict as jax_sharded_tile_predict
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config import experiment as texp
from csof_tpu_torch.config import plans as tplans
from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor
from csof_tpu_torch.models.unet import GenericUNet
from csof_tpu_torch.ops.losses import soft_dice_loss
from csof_tpu_torch.parallel import mesh as tmesh
from csof_tpu_torch.parallel.dryrun import dryrun_multichip
from csof_tpu_torch.training import checkpoint as ckpt
from csof_tpu_torch.training.trainer import Trainer
from csof_tpu_torch.utils.logging import read_training_logs

torch_threads.pin()

#: world 2 against world 1 of the port: the same float32 math, the batch
#: split over two processes (per-rank convolutions of half the batch, a
#: mean of two means): reduction order only
W1_LOSS_RTOL, W1_GRAD_TOL = 1e-5, 1e-4
#: predict_sharded against predict and against JAX: tiles forwarded in
#: other batch compositions, the same Gaussian aggregation in tile order
PROBS_ATOL = 2e-5
SEGFLOW = dict(out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2, dim_feedforward=32,
               corr_radius=(2, 2), corr_stride=(2, 1), corr_fuse="concat", dtype="float32")
PRED_NET = dict(num_classes=2, base_num_features=4, pool_kernel_sizes=((2, 2),),
                conv_kernel_sizes=((3, 3), (3, 3)), deep_supervision=False)
PRED_CFG = dict(patch_size=(16, 16), num_classes=2, do_mirroring=True, tile_batch=4)


def _unet_config(**kw):
    return texp.ExperimentConfig(model="unet2d", optim=texp.OptimConfig(**SGD),
                                 data=texp.DataConfig(do_data_aug=False), **kw)


def _segflow_config():
    return texp.ExperimentConfig(segflow=texp.SegFlowModelConfig(**SEGFLOW),
                                 optim=texp.OptimConfig(), data=texp.DataConfig())


def _segflow_batch(b=4, t=3, hw=16, seed=21):
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, 4, (b, t, hw, hw)).astype(np.int32)
    mask = np.zeros((b, t), np.float32)
    mask[:, [0, -1]] = 1
    seg[mask == 0] = -1
    return {"video": rng.rand(b, t, hw, hw, 1).astype(np.float32), "seg": seg,
            "labeled_mask": mask, "distance": rng.rand(b, t).astype(np.float32)}


def _dice_inputs(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 6, 5, 3).astype(np.float32) * 2,
            rng.randint(0, 3, (4, 6, 5)).astype(np.int32))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pred_params():
    x = jax.ShapeDtypeStruct((1, 16, 16, 1), jnp.float32)
    shapes = jax.eval_shape(JaxUNet(**PRED_NET).init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(7)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)


def _pred_image():
    return np.random.RandomState(0).rand(1, 40, 52).astype(np.float32)


def _pred_tiles():
    """Five tiles, channels first: an odd batch pads one zero tile."""
    return np.random.RandomState(1).rand(5, 1, 16, 16).astype(np.float32)


def _io_batches(n, seed):
    rng = np.random.RandomState(seed)
    return [dict(_seg_batch(seed=int(rng.randint(1 << 20)), b=2)) for _ in range(n)]


@pytest.fixture(scope="module")
def inputs():
    return {"params": _numpy_tree(_flax_params()), "unet_batch": _seg_batch(b=2),
            "clamp_batch": _seg_batch(seed=4, b=3), "segflow_batch": _segflow_batch(),
            "pred_params": _numpy_tree(_pred_params())}


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    """[rank 0's results, rank 1's] of every world-2 job, one spawn of two
    gloo processes rendezvousing through a file store."""
    tmp = tmp_path_factory.mktemp("world2")
    plans = _plans(tplans, pools=((2, 2),) * 3)
    io_cfg = dataclasses.replace(_unet_config(), max_num_epochs=2, num_batches_per_epoch=2,
                                 num_val_batches_per_epoch=1)
    jobs = [
        ("dice", dict(zip(("logits", "target"), _dice_inputs()))),
        ("train_step:unet2d", dict(config=_unet_config(), batch=inputs["unet_batch"],
                                   plans=plans, params=inputs["params"],
                                   mesh_kw=dict(n_data=2, n_model=1))),
        ("train_step:segflow", dict(config=_segflow_config(), batch=inputs["segflow_batch"],
                                    num_classes=4)),
        ("train_step:clamp", dict(config=_unet_config(), batch=inputs["clamp_batch"],
                                  plans=plans, mesh_kw=dict(n_data=2, n_model=1))),
        ("train_step:model2", dict(config=_unet_config(mesh_model=2),
                                   batch=inputs["unet_batch"], plans=plans)),
        ("train_run", dict(config=io_cfg, out=str(tmp / "io"), plans=plans,
                           batches=_io_batches(4, 5), val_batches=_io_batches(2, 6))),
        ("predict", dict(net_kw=dict(in_channels=1, **PRED_NET),
                         params=inputs["pred_params"]["params"], cfg_kw=PRED_CFG,
                         image=_pred_image(), tiles=_pred_tiles())),
    ]
    init = (tmp / "store").as_uri()
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        results = pool.starmap(torch_parallel_worker.run, [(r, 2, init, jobs) for r in range(2)])
    return results, tmp


def _port_world1(config, batch, **kw) -> dict:
    """The port's step at world 1 (no process group): loss, gradients,
    parameters after the update."""
    tr = Trainer(config, kw.pop("out"), device="cpu", **kw).initialize()
    return torch_parallel_worker.step_results(tr, batch)


def _same_step(got: dict, ref: dict, loss_rtol: float, grad_tol: float) -> None:
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=loss_rtol)
    assert set(got["stats"]) == set(ref["stats"])
    for k, r in ref["stats"].items():  # the global batch's, counted once
        np.testing.assert_allclose(got["stats"][k], r, rtol=loss_rtol, err_msg=k)
    assert set(got["grads"]) == set(ref["grads"])
    for name, r in ref["grads"].items():
        g = got["grads"][name]
        if r is None:  # the zero-weight head: no gradient on any rank
            assert g is None, name
            continue
        np.testing.assert_allclose(g, r, atol=grad_tol * float(np.abs(r).max()) + 1e-7, rtol=0,
                                   err_msg=name)


# -- the mesh ------------------------------------------------------------------


def test_mesh_at_world_one_and_its_rows():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    grid = tmesh.Mesh(2, world=4, rank=3)
    assert grid.shape == {"data": 2, "model": 2} and grid.data_index == 1
    assert grid.rows(6) == slice(3, 6)
    assert tmesh.fit_batch(tmesh.Mesh(4, world=4), 6).n_data == 2
    assert tmesh.fit_batch(tmesh.Mesh(2, world=2), 3).n_data == 1
    batch = {"x": np.arange(6), "none": None}
    assert tmesh.shard_batch(batch, tmesh.Mesh(2, world=2, rank=1))["x"].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="do not split"):
        tmesh.Mesh(3, world=4)
    with pytest.raises(ValueError, match="more than 1 ranks"):
        tmesh.make_mesh(2, 1)
    tp, fp, fn = (torch.arange(6.0).reshape(3, 2) + i for i in range(3))
    for got, want in zip(tmesh.global_batch_dice_stats(tp, fp, fn), (tp, fp, fn)):
        assert torch.equal(got, want.sum(0))


# -- the global-batch Dice -----------------------------------------------------


def test_global_batch_dice_and_its_gradient_match_jax_on_the_whole_batch(world2):
    """Each rank's loss is JAX's soft_dice_loss(batch_dice=True) of the whole
    batch; its gradient, divided by the world size as DDP's average divides
    it, is JAX's gradient of its rows."""
    logits, target = _dice_inputs()
    ref_loss, ref_grad = jax.value_and_grad(
        lambda x: jL.soft_dice_loss(x, jnp.asarray(target), batch_dice=True))(jnp.asarray(logits))
    (r0, r1), _ = world2
    for r in (r0["dice"], r1["dice"]):
        np.testing.assert_allclose(r["loss"], float(ref_loss), rtol=1e-6)
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["grad"] / 2, np.asarray(ref_grad)[lo:hi], rtol=1e-5,
                                   atol=1e-8)
    assert (r0["dice"]["rows"], r1["dice"]["rows"]) == ((0, 2), (2, 4))
    # world 1: the plain sum over the batch
    x = torch.from_numpy(logits)
    np.testing.assert_allclose(soft_dice_loss(x, torch.from_numpy(target), batch_dice=True,
                                              mesh=tmesh.make_mesh()).item(), float(ref_loss),
                               rtol=1e-6)


# -- training ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_unet_step(inputs, tmp_path_factory):
    """The JAX Trainer on a 2-device mesh: its loss and SGD parameters after
    one step, and its loss's gradients on the sharded batch."""
    params, batch = inputs["params"], inputs["unet_batch"]
    jcfg = jexp.ExperimentConfig(model="unet2d", optim=jexp.OptimConfig(**SGD),
                                 data=jexp.DataConfig(do_data_aug=False))
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    tr = jtrainer.Trainer(jcfg, tmp_path_factory.mktemp("jax_unet"),
                          plans=_plans(jplans, pools=((2, 2),) * 3), mesh=mesh,
                          example_batch=batch)
    assert tr.mesh.shape == {"data": 2, "model": 1}
    rep, _ = tr._step_shardings
    tr.state = jax.device_put(tr.state.replace(params={"params": params}), rep)
    (_, aux), grads = jax.jit(jax.value_and_grad(tr.loss_fn, has_aux=True))(
        tr.state.params, jax_shard_batch(batch, mesh))
    loss, _ = tr.run_iteration(batch)
    return loss, _torch_layout(grads["params"]), _torch_layout(tr.state.params["params"])


def test_world2_unet_step_matches_the_jax_trainer_on_a_2_device_mesh(world2, jax_unet_step,
                                                                     inputs):
    """Loss, every all-reduced gradient and the parameters after one
    SGD-Nesterov step of the port at world 2 (one sample a rank, the batch
    Dice over both through the gather) against the JAX Trainer with its
    batch sharded over two devices."""
    ref_loss, ref_grads, ref_params = jax_unet_step
    (r0, r1), _ = world2
    for r in (r0["train_step:unet2d"], r1["train_step:unet2d"]):
        assert r["mesh"] == {"data": 2, "model": 1}
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=LOSS_RTOL)
        assert r["grads"]["seg_head_2.weight"] is None and not ref_grads["seg_head_2.weight"].any()
        p0 = _torch_layout(inputs["params"])
        factor = texp.OptimConfig(**SGD).initial_lr * (1 + texp.OptimConfig().sgd_momentum)
        for name, ref in ref_grads.items():
            g = r["grads"][name]
            if name != "seg_head_2.weight":
                np.testing.assert_allclose(g, ref, atol=GRAD_TOL * float(np.abs(ref).max())
                                           + 1e-6, rtol=0, err_msg=name)
            # the first update is -lr (1 + momentum) (g + decay p): within that
            # factor times the gradient tolerance
            tol = factor * (GRAD_TOL * float(np.abs(ref).max()) + 1e-6) + 2 * np.spacing(
                np.abs(p0[name]) + 1)
            got, want = r["params"][name] - p0[name], ref_params[name] - p0[name]
            assert (np.abs(got - want) <= tol).all(), name
            assert np.abs(want).max() > 0, name
    for name in r0["train_step:unet2d"]["params"]:  # DDP keeps the ranks' replicas equal
        assert np.array_equal(r0["train_step:unet2d"]["params"][name],
                              r1["train_step:unet2d"]["params"][name]), name


def test_world2_segflow_step_with_augmentation_equals_world1_on_the_whole_batch(
        world2, inputs, tmp_path):
    """Two videos a rank, each rank drawing its rows of the global batch's
    augmentation: the loss and every all-reduced gradient equal the port's
    world-1 step on all four (held against JAX by test_torch_train.py)."""
    (r0, r1), _ = world2
    ref = _port_world1(_segflow_config(), inputs["segflow_batch"], num_classes=4, out=tmp_path)
    for r in (r0["train_step:segflow"], r1["train_step:segflow"]):
        assert r["mesh"] == {"data": 2, "model": 1}
        _same_step(r, ref, W1_LOSS_RTOL, W1_GRAD_TOL)


@pytest.mark.parametrize("case", ["clamp", "model2"])
def test_clamped_and_model_axis_meshes_equal_world1(world2, inputs, tmp_path, case):
    """A global batch of 3 at world 2 (the data size cut to 1) and
    ``mesh_model=2`` at world 2: both ranks compute the whole batch, the
    batch Dice counts it once, and the step equals world 1's (SGD, so the
    parameters are compared too)."""
    batch = inputs["clamp_batch" if case == "clamp" else "unet_batch"]
    ref = _port_world1(_unet_config(), batch, plans=_plans(tplans, pools=((2, 2),) * 3),
                       out=tmp_path)
    (r0, r1), _ = world2
    for r in (r0[f"train_step:{case}"], r1[f"train_step:{case}"]):
        assert r["mesh"] == {"data": 1, "model": 2}
        _same_step(r, ref, W1_LOSS_RTOL, W1_GRAD_TOL)
        for name, p in ref["params"].items():
            np.testing.assert_allclose(r["params"][name], p, rtol=1e-5, atol=1e-7, err_msg=name)


def test_rank_zero_alone_writes_the_logs_figures_and_checkpoints(world2):
    (r0, r1), tmp = world2
    out = tmp / "io"
    a, b = r0["train_run"], r1["train_run"]
    assert a["main"] and not b["main"] and a["saved"] and not b["saved"]
    # every rank took the same losses, Dice and so the same decisions
    assert (a["train"], a["val"], a["dice"]) == (b["train"], b["val"], b["dice"])
    (log,) = read_training_logs(out)
    assert [line.split(":")[0] for line in log] == ["epoch 1", "epoch 2"]
    for name in (ckpt.BEST, ckpt.FINAL, "model_extra.pt"):
        assert (out / name).is_file() and (out / (name + ".json")).is_file()
    assert len(list((out / "tb").iterdir())) == 1 and (out / "progress.png").is_file()
    debug = json.loads((out / "debug.json").read_text())
    assert debug["mesh_shape"] == {"data": 2, "model": 1} and debug["devices"] == ["cpu", "cpu"]


# -- serving -------------------------------------------------------------------


def test_predict_sharded_and_sharded_tile_predict_match_jax_and_the_port(world2, inputs):
    (r0, r1), _ = world2
    image, params = _pred_image(), inputs["pred_params"]
    jnet = JaxUNet(**PRED_NET)
    jpred = JaxPredictor(lambda p, x: jnet.apply(p, x), JaxPredictorConfig(**PRED_CFG))
    jseg, jprobs = jpred.predict_sharded(params, image, jax_make_mesh(n_data=2,
                                                                      devices=jax.devices()[:2]))
    net = GenericUNet(in_channels=1, **PRED_NET).eval()
    load_flax_params(net, params["params"])
    seg, probs = SlidingWindowPredictor(net, PredictorConfig(**PRED_CFG), "cpu").predict(image)
    tiles = _pred_tiles()
    jtiles = jax_sharded_tile_predict(lambda p, x: jnet.apply(p, x), params,
                                      tiles.transpose(0, 2, 3, 1),
                                      jax_make_mesh(n_data=2, devices=jax.devices()[:2]))
    with torch.no_grad():
        local = torch.softmax(net(torch.from_numpy(tiles)), 1).numpy()
    for r in (r0["predict"], r1["predict"]):
        assert r["probs"].shape == probs.shape == jprobs.shape == (2, 40, 52)
        np.testing.assert_allclose(r["probs"], probs, atol=PROBS_ATOL)
        np.testing.assert_allclose(r["probs"], jprobs, atol=PROBS_ATOL)
        assert (r["seg"] == seg).all() and (r["seg"] == jseg).mean() > 0.999
        assert r["tile_probs"].shape == (5, 2, 16, 16)
        np.testing.assert_allclose(r["tile_probs"], local, atol=PROBS_ATOL)
        np.testing.assert_allclose(r["tile_probs"], jtiles.transpose(0, 3, 1, 2),
                                   atol=PROBS_ATOL)


def test_dryrun_multichip_two_gloo_processes():
    assert np.isfinite(dryrun_multichip(2))

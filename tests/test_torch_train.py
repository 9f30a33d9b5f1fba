"""The PyTorch port's SegFlow training slice against the JAX package, at a
small size: K2's plain version, the warp gradient, the losses, the
schedules and the optimizer, the whole training loss with every parameter
gradient, the loader, and the Trainer on the CPU. Inputs come from numpy
seeds and go through both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads
from test_torch_segflow import SMALL, small_params

from csof_tpu.config import experiment as jexp
from csof_tpu.data import loaders as jloaders
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.ops import losses as jL
from csof_tpu.ops.correlation import local_correlation_volume as jax_corr
from csof_tpu.ops.pallas import corr as pcorr
from csof_tpu.ops.warp import warp_image_cm as jax_warp
from csof_tpu.training import schedules as jsched
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config import experiment as texp
from csof_tpu_torch.data import loaders
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.ops import losses as L
from csof_tpu_torch.ops.kernels import corr as k1
from csof_tpu_torch.ops.warp import warp_image_cm
from csof_tpu_torch.training import checkpoint as ckpt
from csof_tpu_torch.training import schedules, trainer
from csof_tpu_torch.utils.logging import read_training_logs

torch_threads.pin()

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: summation order only. bf16: both round the same f32 sum, taken in
# another order, so a value may differ by one bf16 unit in the last place.
BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------------
# K2: the correlation backward
# --------------------------------------------------------------------------


def _corr_case(seed, b, c, h, w, radius, dtype):
    """q, m (B, C, H, W) and g (B, K^2, H, W) in both packages; JAX's
    backward kernels take them channels-last."""
    rng = np.random.RandomState(seed)
    q, m = rng.randn(2, b, c, h, w).astype(np.float32)
    g = rng.randn(b, (2 * radius + 1) ** 2, h, w).astype(np.float32)
    jd, td = DTYPES[dtype]
    jax_args = [jnp.asarray(a.transpose(0, 2, 3, 1), jd) for a in (q, m, g)]
    torch_args = [torch.from_numpy(a).to(td) for a in (q, m, g)]
    return jax_args, torch_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius,stride,hw", [(2, 1, (12, 12)), (4, 2, (14, 22)), (1, 2, (9, 13))])
def test_corr_bwd_plain_matches_pallas_v2(radius, stride, hw, dtype):
    (qj, mj, gj), (qt, mt, gt) = _corr_case(0, 2, 6, *hw, radius, dtype)
    dq_ref, dm_ref = pcorr._corr_bwd_pallas_v2(qj, mj, gj, radius, stride, interpret=True)
    dq, dm = k1.corr_bwd_plain(qt, mt, gt, radius, stride)
    assert dq.dtype == dm.dtype == qt.dtype
    atol, rtol = BWD_TOL[dtype]
    np.testing.assert_allclose(_np(dq.permute(0, 2, 3, 1)), _np(dq_ref), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(dm.permute(0, 2, 3, 1)), _np(dm_ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("radius,stride,hw", [(3, 1, (11, 17)), (2, 2, (16, 16))])
def test_corr_bwd_plain_matches_pallas_v1(radius, stride, hw):
    (qj, mj, gj), (qt, mt, gt) = _corr_case(1, 2, 5, *hw, radius, "float32")
    dq_ref, dm_ref = pcorr._corr_bwd_pallas(qj, mj, gj, radius, stride, interpret=True)
    dq, dm = k1.corr_bwd_plain(qt, mt, gt, radius, stride)
    np.testing.assert_allclose(_np(dq.permute(0, 2, 3, 1)), _np(dq_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(dm.permute(0, 2, 3, 1)), _np(dm_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius,stride,hw", [
    (1, 1, (10, 10)), (2, 2, (12, 20)), (3, 1, (13, 9)), (4, 1, (16, 16)), (4, 2, (19, 21)),
])
def test_corr_bwd_plain_matches_jax_vjp(radius, stride, hw, dtype):
    """Against jax.vjp of the jnp local correlation (JAX's autodiff)."""
    (qj, mj, gj), (qt, mt, gt) = _corr_case(2, 2, 8, *hw, radius, dtype)

    def fwd(q, m):
        return jax.vmap(lambda a, b: jax_corr(a, b, radius, stride, impl="jnp"))(q, m)

    _, vjp = jax.vjp(fwd, qj, mj)
    dq_ref, dm_ref = vjp(gj)
    dq, dm = k1.corr_bwd_plain(qt, mt, gt, radius, stride)
    atol, rtol = BWD_TOL[dtype]
    np.testing.assert_allclose(_np(dq.permute(0, 2, 3, 1)), _np(dq_ref), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(dm.permute(0, 2, 3, 1)), _np(dm_ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("radius,stride,hw", [(2, 1, (6, 7)), (1, 3, (8, 6))])
def test_corr_function_gradcheck(radius, stride, hw):
    """CorrFunction in float64 on the CPU: its forward and backward are the
    plain versions of K1 and K2, and they are each other's adjoints."""
    rng = np.random.RandomState(3)
    q, m = (torch.from_numpy(rng.randn(1, 2, *hw)).requires_grad_(True) for _ in range(2))
    assert torch.autograd.gradcheck(lambda a, b: k1.CorrFunction.apply(a, b, radius, stride),
                                    (q, m))
    k1.launches = k1.bwd_launches = 0
    k1.CorrFunction.apply(q, m, radius, stride).sum().backward()
    assert k1.launches == k1.bwd_launches == 0  # CPU tensors launch nothing


# --------------------------------------------------------------------------
# warp gradient
# --------------------------------------------------------------------------


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("hw", [(32, 32), (16, 16), (12, 20)])
def test_warp_flow_gradient_matches_jax(hw, padding):
    """grad of sum(warp * G) with respect to the flow. 32x32 = 1024 samples
    takes the JAX package's matmul sampler, the smaller ones its gather
    sampler (index clamp after floor); flows of up to 6 px send many
    samples off the grid and out of the image, and a band of samples sits
    within one pixel outside each border."""
    h, w = hw
    rng = np.random.RandomState(4)
    image = rng.rand(h, w, 3).astype(np.float32)
    flow = rng.uniform(-6, 6, (2, h, w)).astype(np.float32)
    flow[0, 0, :] = rng.uniform(-0.95, -0.05, w)       # y in (-1, 0)
    flow[1, :, -1] = rng.uniform(0.05, 0.95, h)        # x in (W-1, W)
    gout = rng.randn(h, w, 3).astype(np.float32)

    def jloss(f):
        return jnp.sum(jax_warp(jnp.asarray(image), f, padding=padding) * gout)

    ref_val, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(flow))
    ft = torch.from_numpy(flow)[None].requires_grad_(True)
    img_t = torch.from_numpy(image).permute(2, 0, 1)[None]
    val = (warp_image_cm(img_t, ft, padding=padding)[0].permute(1, 2, 0)
           * torch.from_numpy(gout)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-5)
    np.testing.assert_allclose(ft.grad[0].numpy(), np.asarray(ref_grad), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_ncc_loss_and_gradient_match_jax(reduction):
    rng = np.random.RandomState(5)
    pred, fixed = rng.rand(2, 3, 20, 18, 1).astype(np.float32)
    fixed = 0.6 * pred + 0.4 * fixed
    weights = rng.rand(3, 20, 18, 1).astype(np.float32)
    (pj, fj, wj), (pt, ft, wt) = _both(pred, fixed, weights)

    def jl(p):
        out = jL.ncc_loss(p, fj, reduction=reduction)
        return jnp.sum(out * wj) if reduction == "none" else out

    ref, ref_grad = jax.value_and_grad(jl)(pj)
    pt.requires_grad_(True)
    out = L.ncc_loss(pt, ft, reduction=reduction)
    val = (out * wt).sum() if reduction == "none" else out
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("kind,shape,channel_axis,reduction", [
    ("spatial", (3, 2, 9, 11), 1, "mean"), ("spatial", (3, 2, 9, 11), 1, "none"),
    ("spatial", (2, 9, 11, 2), -1, "mean"), ("temporal", (4, 2, 9, 11), -3, "mean"),
    ("temporal", (4, 1, 2, 9, 11), -3, "none"),
])
def test_flow_penalties_and_gradients_match_jax(kind, shape, channel_axis, reduction):
    rng = np.random.RandomState(6)
    (fj,), (ft,) = _both(rng.randn(*shape).astype(np.float32))
    jfn = {"spatial": jL.spatial_gradient_penalty, "temporal": jL.temporal_gradient_penalty}[kind]
    tfn = {"spatial": L.spatial_gradient_penalty, "temporal": L.temporal_gradient_penalty}[kind]
    ref_map = jfn(fj, reduction=reduction, channel_axis=channel_axis)
    wts = np.asarray(rng.rand(*ref_map.shape), np.float32)

    def jl(f):
        return jnp.sum(jfn(f, reduction=reduction, channel_axis=channel_axis) * wts)

    ref, ref_grad = jax.value_and_grad(jl)(fj)
    ft.requires_grad_(True)
    val = (tfn(ft, reduction=reduction, channel_axis=channel_axis)
           * torch.from_numpy(wts)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=1e-5)


def _seg_case(seed, shape=(3, 10, 12), c=4):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(*shape, c)).astype(np.float32)
    target = rng.randint(-1, c, shape).astype(np.int32)
    return logits, target


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_cross_entropy_matches_jax(ignore_index):
    logits, target = _seg_case(7)
    if ignore_index is None:
        target = np.clip(target, 0, None)
    (lj, tj), (lt, tt) = _both(logits, target)
    ref = jL.cross_entropy_loss(lj, tj, ignore_index=ignore_index)
    got = L.cross_entropy_loss(lt, tt, ignore_index=ignore_index)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_tp_fp_fn_tn_match_jax(masked):
    logits, target = _seg_case(8)
    target = np.clip(target, 0, None)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    mask = (np.random.RandomState(9).rand(3, 1, 1) > 0.3).astype(np.float32) if masked else None
    (pj, tj), (pt, tt) = _both(probs, target)
    ref = jL.get_tp_fp_fn_tn(pj, tj, mask=None if mask is None else jnp.asarray(mask))
    got = L.get_tp_fp_fn_tn(pt, tt, mask=None if mask is None else torch.from_numpy(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch_dice,masked,probs_input", [
    (False, False, False), (True, False, False), (True, True, False), (True, False, True),
])
def test_soft_dice_matches_jax(batch_dice, masked, probs_input):
    logits, target = _seg_case(10)
    target = np.clip(target, 0, None)
    if probs_input:
        logits = np.asarray(jax.nn.softmax(logits, -1))
    mask = np.array([1.0, 0.0, 1.0], np.float32)[:, None, None] if masked else None
    (lj, tj), (lt, tt) = _both(logits, target)
    ref = jL.soft_dice_loss(lj, tj, batch_dice=batch_dice, probs_input=probs_input,
                            mask=None if mask is None else jnp.asarray(mask))
    got = L.soft_dice_loss(lt, tt, batch_dice=batch_dice, probs_input=probs_input,
                           mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# --------------------------------------------------------------------------
# schedules and the optimizer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cosine", "cosine_short_warmup", "poly"])
def test_schedules_match_optax_at_every_step(kind):
    total = 40
    if kind == "poly":
        ref, got = jsched.poly_schedule(0.01, total), schedules.poly_schedule(0.01, total)
    else:
        warm = 0.1 if kind == "cosine" else 0.01
        ref = jsched.cosine_with_warmup(3e-4, total, warm, 1e-6)
        got = schedules.cosine_with_warmup(3e-4, total, warm, 1e-6)
    steps = range(total + 5) if kind != "poly" else range(total)  # cosine: the clamp too
    # optax computes in float32, the port in float64: they differ by up to
    # two float32 ulps of the peak (2^-22 relative)
    peak = 0.01 if kind == "poly" else 3e-4
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(ref(jnp.int32(s))) for s in steps], rtol=1e-6,
                               atol=2.0 ** -22 * peak)
    # update 0 runs at the count-0 value: initial_lr / 100 under the warm-up
    assert got(0) == pytest.approx(0.01 if kind == "poly" else 3e-6, rel=1e-12)


@pytest.mark.parametrize("optimizer,gscale", [("adamw", 1.0), ("adamw", 40.0), ("sgd", 40.0)])
def test_three_optimizer_steps_match_optax(optimizer, gscale):
    """Fixed gradients; gscale 40 puts the global norm above the clip of 12."""
    cfg = dict(optimizer=optimizer, initial_lr=0.05, weight_decay=0.02, warmup_percent=0.2)
    rng = np.random.RandomState(11)
    params = {"w": rng.randn(5, 7).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (gscale * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    assert np.sqrt(sum((g ** 2).sum() for g in grads[0].values())) > 12 or gscale == 1.0

    tx = jsched.build_optimizer(jexp.OptimConfig(**cfg), 10)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = schedules.build_optimizer(texp.OptimConfig(**cfg), 10, tp.values())
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == 3
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)


# --------------------------------------------------------------------------
# the training loss, every gradient, one step
# --------------------------------------------------------------------------

WEIGHTS = dict(image_flow_global=0.5, regularization_xy=1.0, regularization_z=0.7,
               seg_registered=0.3, segmentation=1.0)


def _train_batch(seed=12, b=2, t=3, hw=16):
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, 4, (b, t, hw, hw)).astype(np.int32)
    labeled = np.ones((b, t), np.float32)
    labeled[0, 1] = 0.0  # one unlabelled frame
    seg[0, 1] = -1
    return {
        "video": rng.rand(b, t, hw, hw, 1).astype(np.float32),
        "seg": seg,
        "labeled_mask": labeled,
        "distance": rng.rand(b, t).astype(np.float32),
        "loss_mask": (rng.rand(b, t, hw, hw) > 0.3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def slice_case():
    """JAX loss, metrics and gradient tree of the small SegFlow (f32,
    concat) at (2, 3, 16, 16, 1), every loss term on."""
    seg_cfg = jexp.SegFlowModelConfig(**dict(SMALL, corr_fuse="concat", dtype="float32"))
    config = jexp.ExperimentConfig(segflow=seg_cfg, loss_weights=jexp.LossWeights(**WEIGHTS))
    params = small_params(seg_cfg, seed=3)
    batch = _train_batch()
    loss_fn = jtrainer.make_segflow_loss(config, JaxSegFlow(cfg=seg_cfg, num_classes=4))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn({"params": p}, jbatch), has_aux=True))(params)
    return params, batch, float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _torch_config(**optim):
    return texp.ExperimentConfig(
        segflow=texp.SegFlowModelConfig(**dict(SMALL, corr_fuse="concat", dtype="float32")),
        loss_weights=texp.LossWeights(**WEIGHTS), optim=texp.OptimConfig(**optim),
        data=texp.DataConfig(do_data_aug=False))


def test_training_loss_and_every_gradient_match_jax(slice_case):
    params, batch, ref_loss, ref_metrics, ref_grads = slice_case
    config = _torch_config()
    model = SegFlow(config.segflow, 4)
    load_flax_params(model, params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = trainer.make_segflow_loss(config)(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), ref_metrics[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert ref_metrics["seg_registered"] > 0 and ref_metrics["smooth_t"] > 0

    scratch = SegFlow(config.segflow, 4)  # the JAX gradient tree in torch layout
    load_flax_params(scratch, jax.tree_util.tree_map(np.asarray, ref_grads))
    ref = dict(scratch.named_parameters())
    for name, p in model.named_parameters():
        r = ref[name].detach().numpy()
        tol = 2e-3 * float(np.abs(r).max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy(), r, atol=tol, rtol=0, err_msg=name)


def test_one_optimizer_step_matches_jax(slice_case):
    """One full step: the JAX optax chain on the JAX gradients against the
    port's optimizer on the port's, compared as updates p - p0 element by
    element. Adam's first update is -lr(0) g / (|g| + eps), about -lr(0)
    sign(g), so where the reference gradient is rounding noise (biases ahead
    of a GroupNorm: |g| below 1e-5 max|g| over the whole model) the two may
    step in opposite directions; there the update is only held to its size.
    Everywhere else it must match to 1e-3 of itself plus one float32 ulp of
    the parameter (the rounding of p0 + update), so a reversed or shrunken
    update fails. The rule holds 99.6 % of the elements here."""
    params, batch, _, _, ref_grads = slice_case
    config = _torch_config()
    tx = jsched.build_optimizer(jexp.OptimConfig(), config.max_num_epochs
                                * config.num_batches_per_epoch)
    updates, _ = jax.jit(tx.update)(ref_grads, tx.init(params), params)
    ref_params = optax.apply_updates(params, updates)

    model = SegFlow(config.segflow, 4)
    load_flax_params(model, params)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    total = config.max_num_epochs * config.num_batches_per_epoch
    opt = schedules.build_optimizer(config.optim, total, model.parameters())
    loss, _ = trainer.make_segflow_loss(config)(model, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
    loss.backward()
    opt.step()
    lr0 = opt.schedule(0)
    assert lr0 > 0

    def torch_layout(tree):
        scratch = SegFlow(config.segflow, 4)
        load_flax_params(scratch, jax.tree_util.tree_map(np.asarray, tree))
        return {k: v.detach().numpy() for k, v in scratch.named_parameters()}

    ref, ref_g = torch_layout(ref_params), torch_layout(ref_grads)
    g_floor = 1e-5 * max(float(np.abs(g).max()) for g in ref_g.values())
    n_held = n_all = 0
    for name, p in model.named_parameters():
        p0 = initial[name].numpy()
        got, want = p.detach().numpy() - p0, ref[name] - p0
        ulp = np.spacing(np.maximum(np.abs(p0), np.abs(ref[name])))
        held = np.abs(ref_g[name]) >= g_floor
        n_held, n_all = n_held + int(held.sum()), n_all + held.size
        err = np.abs(got - want)
        assert (err <= 1e-3 * np.abs(want) + ulp)[held].all(), (name, float(err[held].max()))
        assert (np.abs(got) <= 1.001 * lr0 + ulp).all(), name
        assert not torch.equal(p.detach(), initial[name]), name
    assert n_held > 0.99 * n_all, (n_held, n_all)


# --------------------------------------------------------------------------
# the loader and the trainer
# --------------------------------------------------------------------------


def _cines(seed=13, n=3, t=9, depth=2, hw=(20, 22)):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(n):
        frames = (100 * rng.rand(t, depth, *hw)).astype(np.float32)
        seg = rng.randint(0, 4, (t, depth, *hw))
        out[f"patient{i:03d}"] = {"frames": frames, "seg": None if i == 2 else seg,
                                  "ed": i, "es": (i + 4) % t}
    return out


def test_sample_video_chunk_matches_jax():
    for seed in range(6):
        for args in ((9, 0, 4, 6), (9, 7, 2, 5), (12, 3, 3, 4)):
            ref = jloaders.sample_video_chunk(*args, np.random.RandomState(seed), seed % 2 == 1)
            got = loaders.sample_video_chunk(*args, np.random.RandomState(seed), seed % 2 == 1)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)


def test_video_loader_matches_jax():
    cines = _cines()
    ref_it = jloaders.VideoChunkLoader(cines, video_length=5, batch_size=3, crop_size=16, seed=4)
    got_it = loaders.VideoChunkLoader(cines, video_length=5, batch_size=3, crop_size=16, seed=4)
    for _ in range(3):
        ref, got = next(ref_it), next(got_it)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        np.testing.assert_allclose(got["video"], ref["video"], atol=1e-6)
        for k in ("seg", "labeled_mask", "distance"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_minmax_normalize_matches_numpy_branch():
    x = np.random.RandomState(14).rand(4, 6, 7).astype(np.float32) * 50 - 3
    got = loaders.minmax_normalize(x.copy())
    flat = x.reshape(4, -1)
    ref = ((flat - flat.min(1, keepdims=True))
           / (flat.max(1, keepdims=True) - flat.min(1, keepdims=True) + 1e-8)).reshape(x.shape)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_trainer_runs_an_epoch_and_writes_the_checkpoint_triad(tmp_path):
    config = dataclasses.replace(_torch_config(), max_num_epochs=1, num_batches_per_epoch=2,
                                 seed=5)
    config.data.video_length, config.data.batch_size, config.data.crop_size = 3, 2, 16
    loader = loaders.VideoChunkLoader(_cines(), 3, 2, 16, seed=0)
    tr = trainer.Trainer(config, tmp_path, device="cpu")
    tr.checkpoint_every = 1
    tr.initialize()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    hist = tr.run_training(loader, val_iter=loaders.VideoChunkLoader(_cines(), 3, 2, 16, seed=1))
    assert len(hist.train_losses) == len(hist.val_losses) == 1 and len(hist.step_times) == 2
    assert np.isfinite(hist.train_losses[0])
    assert tr.optimizer.count == 2
    changed = [k for k, v in tr.model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(changed) == len(before)
    for name in (ckpt.BEST, ckpt.LATEST, ckpt.FINAL):
        assert (tmp_path / name).is_file() and (tmp_path / (name + ".json")).is_file()
    trained = {k: v.clone() for k, v in tr.model.state_dict().items()}
    fresh = trainer.Trainer(config, tmp_path, device="cpu")
    meta = fresh.load_checkpoint()  # final first
    assert meta["epoch"] == 1 and fresh.epoch == 1 and fresh.optimizer.count == 2
    assert all(torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items())
    (log,) = read_training_logs(tmp_path)
    assert log[0].startswith("epoch 1:")
    assert {"debug.json", "network_architecture.txt", "progress.png"} <= {
        f.name for f in tmp_path.iterdir()}


def test_trainer_defaults_to_the_card_and_refuses_what_is_not_ported(tmp_path):
    """What the trainer still refuses: fused_cm (K3 has no backward, in the
    JAX package either) and unknown model kinds. Augmentation, every other
    corr_fuse mode, deep supervision, the linear decoder and remat train, and
    every model kind of the JAX trainer builds (RAFT since it was ported)."""
    assert trainer.Trainer(_torch_config(), tmp_path).device.type == "cuda"
    aug = _torch_config()
    aug.data.do_data_aug = True
    trainer.Trainer(aug, tmp_path, device="cpu")
    cfg = dataclasses.replace(_torch_config(), segflow=dataclasses.replace(
        _torch_config().segflow, corr_fuse="fused_cm"))
    with pytest.raises(NotImplementedError, match="not ported"):
        trainer.Trainer(cfg, tmp_path, device="cpu")
    assert type(trainer.build_model(dataclasses.replace(_torch_config(), model="raft"))
                ).__name__ == "RAFT"
    with pytest.raises(ValueError, match="unknown model kind"):
        trainer.build_model(dataclasses.replace(_torch_config(), model="swin"))
    for seg_kw in (dict(corr_fuse="split", fuse_q_hoist=True, remat=True),
                   dict(corr_fuse="project", dec_upsample="linear"),
                   dict(corr_fuse="mean1", deep_supervision=True)):
        cfg = dataclasses.replace(_torch_config(), segflow=dataclasses.replace(
            _torch_config().segflow, **seg_kw))
        trainer.Trainer(cfg, tmp_path, device="cpu")


def test_nan_guard_raises_on_a_non_finite_loss(tmp_path):
    tr = trainer.Trainer(_torch_config(), tmp_path, device="cpu").initialize()
    batch = _train_batch()
    batch["video"][0, 0, 0, 0, 0] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.run_iteration(batch)


def test_momentum_rescue_fires_after_the_epoch_numbered_from_zero(tmp_path):
    """SGD rescue: weights drawn anew, momentum lowered, schedule position
    kept, once the epoch numbered momentum_rescue_epoch from zero has
    finished (self.epoch == momentum_rescue_epoch + 1 epochs done), as
    nnU-Net's on_epoch_end fires: fault F5 repaired on the port's side (the
    JAX trainer fires one epoch earlier; tests/test_torch_unet_train.py
    shows both)."""
    config = _torch_config(optimizer="sgd", momentum_rescue_epoch=2)
    tr = trainer.Trainer(config, tmp_path, device="cpu").initialize()
    tr.optimizer.count = 7
    tr.history.eval_metrics = [0.0]
    weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for epoch in (1, 2, 4):
        tr.epoch = epoch
        assert not tr._maybe_momentum_rescue(log_fn=lambda m: None)
    tr.epoch = 3
    tr.history.eval_metrics = [0.5]
    assert not tr._maybe_momentum_rescue(log_fn=lambda m: None)
    tr.history.eval_metrics = [0.0]
    assert tr._maybe_momentum_rescue(log_fn=lambda m: None)
    assert tr.config.optim.sgd_momentum == 0.95 and tr.optimizer.count == 7
    assert tr.optimizer.inner.param_groups[0]["momentum"] == 0.95
    fresh = trainer.build_model(config, 4, torch.Generator().manual_seed(config.seed + 3))
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in tr.model.state_dict().items())
    assert any(not torch.equal(v, weights[k]) for k, v in tr.model.state_dict().items())

"""The nnU-Net 2D training step of the PyTorch port against the JAX package
on the CPU: K6's backward (``Conv3x3Function``), the deep-supervision
Dice + CE, ``make_seg_loss`` with every parameter gradient, one SGD step
against optax, the patch loader and its dataset files, the Trainer, and the
faults the port handles (F5, F8, and the optimizer's update of a parameter
without a gradient). Small sizes: base 8, 3 pools, 64 x 64 patches, so that
K6's route (an input at least 32 wide) is taken at levels 0 and 1.
"""

from __future__ import annotations

import dataclasses
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_unet import _plans, _same_props, _write_case

from csof_tpu.config import experiment as jexp
from csof_tpu.config import plans as jplans
from csof_tpu.data import cropping as jcrop
from csof_tpu.data import dataset as jdataset
from csof_tpu.data import loaders as jloaders
from csof_tpu.data.preprocessing import Preprocessor as JaxPreprocessor
from csof_tpu.models.blocks import PallasConv
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.ops import losses as jL
from csof_tpu.ops.pallas.conv import conv3x3_cols
from csof_tpu.parallel.mesh import make_mesh
from csof_tpu.training import schedules as jsched
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config import experiment as texp
from csof_tpu_torch.config import plans as tplans
from csof_tpu_torch.config.plans import task002_heart_2d
from csof_tpu_torch.data import cropping, dataset, loaders
from csof_tpu_torch.data.preprocessing import Preprocessor
from csof_tpu_torch.models.unet import GenericUNet, unet_from_plans
from csof_tpu_torch.ops import losses as L
from csof_tpu_torch.ops.kernels import conv as k6
from csof_tpu_torch.training import checkpoint as ckpt
from csof_tpu_torch.training import schedules, trainer
from csof_tpu_torch.utils.logging import read_training_logs

NET = dict(num_classes=3, base_num_features=8, pool_kernel_sizes=((2, 2),) * 3,
           conv_kernel_sizes=((3, 3),) * 4)
PATCH = (64, 64)
# K6's dx: the same float32 tap sums in another order (f32), or the same
# bf16 roundings of dy and the weight and one of the sum (bf16); dw and db:
# a library reduction over N*H*W terms against XLA's, rounded once in bf16
DX_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
DW_REL = {"float32": 1e-5, "bfloat16": 1e-2}
#: float32 loss (relative) and gradients (|diff| <= GRAD_TOL max|leaf| + 1e-6
#: per leaf): the same math summed in another order
LOSS_RTOL, GRAD_TOL = 1e-5, 2e-3
SGD = dict(optimizer="sgd", scheduler="poly", initial_lr=1e-2, weight_decay=3e-5)


def _flax_params(seed=0):
    x = jax.ShapeDtypeStruct((1, *PATCH, 1), jnp.float32)
    shapes = jax.eval_shape(JaxUNet(**NET).init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((name == "scale") + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _seg_batch(seed=1, b=2):
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, *PATCH), np.int32)
    yy, xx = np.mgrid[0:PATCH[0], 0:PATCH[1]]
    for i in range(b):  # two blobs, so that both foreground classes are present
        seg[i][(yy - 20 - 4 * i) ** 2 + (xx - 24) ** 2 < 150] = 1
        seg[i][(yy - 44) ** 2 + (xx - 40 + 3 * i) ** 2 < 80] = 2
    data = (rng.randn(b, *PATCH, 1) + seg[..., None]).astype(np.float32)
    return {"data": data, "seg": seg}


def _config(**optim):
    return texp.ExperimentConfig(model="unet2d", optim=texp.OptimConfig(**SGD, **optim),
                                 data=texp.DataConfig(do_data_aug=False))


def _port_net(params, conv_impl):
    net = GenericUNet(in_channels=1, conv_impl=conv_impl, **NET)
    load_flax_params(net, params)
    return net


def _torch_batch(batch):
    return {"data": torch.from_numpy(batch["data"]).movedim(-1, 1).contiguous(),
            "seg": torch.from_numpy(batch["seg"])}


def _torch_layout(tree):
    """A flax tree (the JAX gradients or parameters) in the port's names."""
    scratch = GenericUNet(in_channels=1, **NET)
    load_flax_params(scratch, jax.tree_util.tree_map(np.asarray, tree))
    return {k: v.detach().numpy() for k, v in scratch.named_parameters()}


@pytest.fixture(scope="module")
def seg_case():
    """JAX loss, Dice statistics and gradient tree of make_seg_loss, with the
    conv switch off (under the switch JAX cannot differentiate: F8)."""
    params, batch = _flax_params(), _seg_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("CSOF_CONV2D_IMPL", raising=False)
        mp.delenv("CSOF_FUSED_NORM", raising=False)
        loss_fn = jtrainer.make_seg_loss(jexp.ExperimentConfig(model="unet2d"), JaxUNet(**NET))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn({"params": p}, jbatch), has_aux=True))(params)
    aux = {k: np.asarray(v) for k, v in aux.items()}
    return params, batch, float(loss), aux, grads


# -- K6's backward ----------------------------------------------------------


def _conv_inputs(n, ci, co, h, w, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, ci, h, w).astype(np.float32)
    wt = (rng.randn(co, ci, 3, 3) / np.sqrt(9 * ci)).astype(np.float32)
    dy = rng.randn(n, co, h, w).astype(np.float32)
    return x, wt, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,ci,co,h,w", [(2, 5, 8, 12, 40), (1, 8, 3, 9, 33)])
def test_conv3x3_backward_matches_jax_vjp(n, ci, co, h, w, dtype):
    """dx and dw of Conv3x3Function (plain versions on the CPU) against
    jax.vjp of conv3x3_cols in interpret mode, with the weight in x's dtype
    as PallasConv passes it."""
    x, wt, dy = _conv_inputs(n, ci, co, h, w)
    jd = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, b: conv3x3_cols(a, b, True), jnp.asarray(
        x.transpose(0, 2, 3, 1), jd), jnp.asarray(wt.transpose(2, 3, 1, 0), jd))
    rdx, rdw = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1), jd))
    rdx = np.asarray(rdx, np.float32).transpose(0, 3, 1, 2)
    rdw = np.asarray(rdw, np.float32).transpose(3, 2, 0, 1)

    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    wp = torch.from_numpy(wt).requires_grad_(True)
    y = k6.conv3x3(xt, wp)
    assert y.dtype == td
    y.backward(torch.from_numpy(dy).to(td))
    assert xt.grad.dtype == td and wp.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.float().numpy(), rdx, atol=DX_TOL[dtype][0],
                               rtol=DX_TOL[dtype][1])
    tol = DW_REL[dtype] * float(np.abs(rdw).max())
    np.testing.assert_allclose(wp.grad.numpy(), rdw, atol=tol, rtol=DW_REL[dtype])


def test_conv3x3_function_gradcheck_in_float64():
    """The analytic VJP of Conv3x3Function against finite differences in
    float64, along random directions of the inputs and the outputs (the fast
    mode of gradcheck: the full Jacobian takes minutes at this shape)."""
    rng = np.random.RandomState(3)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (
        rng.randn(2, 3, 7, 34), rng.randn(4, 3, 3, 3), rng.randn(4))]
    assert torch.autograd.gradcheck(lambda x, w, b: k6.conv3x3(x, w, b), args, fast_mode=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_vjp_matches_pallas_conv_under_vmap(dtype):
    """F8's working side: under jax.vmap (as make_segflow_loss applies its
    loss per video) JAX differentiates PallasConv through conv3x3_cols's
    custom VJP; x, kernel and bias gradients against the port's K6."""
    b, n, ci, co, h, w = 2, 2, 4, 6, 10, 36
    x, wt, dy = _conv_inputs(b * n, ci, co, h, w, seed=4)
    bias = np.random.RandomState(5).randn(co).astype(np.float32)
    jd = jnp.dtype(dtype)
    conv = PallasConv(co, dtype=jd)
    xv = jnp.asarray(x.transpose(0, 2, 3, 1).reshape(b, n, h, w, ci))
    dyv = jnp.asarray(dy.transpose(0, 2, 3, 1).reshape(b, n, h, w, co), jd)
    params = {"kernel": jnp.asarray(wt.transpose(2, 3, 1, 0)), "bias": jnp.asarray(bias)}
    y, vjp = jax.vjp(lambda p, a: jax.vmap(lambda v: conv.apply({"params": p}, v))(a),
                     params, xv)
    rp, rdx = vjp(dyv)
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    wp, bp = (torch.from_numpy(a).requires_grad_(True) for a in (wt, bias))
    got = k6.conv3x3(xt, wp, bp)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(y, np.float32).reshape(b * n, h, w, co)
                               .transpose(0, 3, 1, 2), atol=DX_TOL[dtype][0],
                               rtol=DX_TOL[dtype][1])
    got.backward(torch.from_numpy(dy).to(td))
    rdx = np.asarray(rdx, np.float32).reshape(b * n, h, w, ci).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(xt.grad.float().numpy(), rdx, atol=DX_TOL[dtype][0],
                               rtol=DX_TOL[dtype][1])
    ref_db = np.asarray(rp["bias"])
    if dtype == "bfloat16":
        # JAX on the CPU sums the bf16 bias cotangent in bf16 partial sums
        # (0.9 apart from the exact sum here); the port sums in float32 and
        # rounds once, so it is held to the exact sum of the bf16 cotangent
        ref_db = torch.from_numpy(dy).to(td).double().sum((0, 2, 3)).numpy()
    for got_g, ref_g in ((wp.grad, np.asarray(rp["kernel"]).transpose(3, 2, 0, 1)),
                         (bp.grad, ref_db)):
        tol = DW_REL[dtype] * float(np.abs(ref_g).max())
        np.testing.assert_allclose(got_g.numpy(), ref_g, atol=tol, rtol=DW_REL[dtype])


def test_f8_jax_cannot_differentiate_its_pallas_conv_where_the_port_can(monkeypatch):
    """Under CSOF_CONV2D_IMPL=pallas, jax.grad of the JAX package's
    make_seg_loss fails (conv3x3_cols_vb's custom_vmap has no reverse-mode
    rule outside a vmap); the port's U-Net trains under the same switch."""
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    monkeypatch.delenv("CSOF_FUSED_NORM", raising=False)
    params, batch = _flax_params(), _seg_batch()
    loss_fn = jtrainer.make_seg_loss(jexp.ExperimentConfig(model="unet2d"), JaxUNet(**NET))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.jit(jax.grad(lambda p: loss_fn({"params": p}, jbatch)[0]))(params)
    net = unet_from_plans(_plans(tplans, pools=((2, 2),) * 3))
    assert all(b.conv_impl == "pallas" for b in net.modules() if hasattr(b, "uses_k6"))
    loss, _ = trainer.make_seg_loss(_config())(net, _torch_batch(batch))
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters() if p.grad is not None)


def test_k6_forward_and_dx_launches_per_step_from_the_modules(monkeypatch):
    """7 K6 forward and 6 K6 dx launches per Task002 2d step, counted from
    the modules; at the small size, the plain versions' calls in one CPU
    step equal the modules' counts."""
    net = unet_from_plans(task002_heart_2d(), conv_impl="pallas")
    assert net.kernel_launches((320, 256), backward=True) == {"K5": 0, "K6": 7, "K7": 0, "K6_dx": 6,
                                                       "K7_dx": 0}  # K7: on the card only
    calls = {"plain": 0, "dx": 0}
    plain, dx_plain = k6.conv3x3_plain, k6.conv3x3_dx_plain

    def counting_plain(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    def counting_dx(*a, **k):
        calls["dx"] += 1
        return dx_plain(*a, **k)

    monkeypatch.setattr(k6, "conv3x3_plain", counting_plain)
    monkeypatch.setattr(k6, "conv3x3_dx_plain", counting_dx)
    small = _port_net(_flax_params(), "pallas")
    loss, _ = trainer.make_seg_loss(_config())(small, _torch_batch(_seg_batch()))
    loss.backward()
    want = small.kernel_launches(PATCH, backward=True)
    assert want == {"K5": 0, "K6": 7, "K7": 0, "K6_dx": 6, "K7_dx": 0}  # levels 0, 1
    # every dx runs the plain forward once, on dy
    assert (calls["plain"] - calls["dx"], calls["dx"]) == (want["K6"], want["K6_dx"])


# -- the losses -------------------------------------------------------------


@pytest.mark.parametrize("batch_dice", [True, False])
def test_dice_and_ce_loss_matches_jax(batch_dice):
    rng = np.random.RandomState(6)
    logits = rng.randn(3, 12, 10, 4).astype(np.float32)
    target = rng.randint(0, 4, (3, 12, 10)).astype(np.int32)
    ref = jL.dice_and_ce_loss(jnp.asarray(logits), jnp.asarray(target), batch_dice=batch_dice)
    got = L.dice_and_ce_loss(torch.from_numpy(logits), torch.from_numpy(target),
                             batch_dice=batch_dice)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("n,mask_last", [(1, True), (2, True), (4, True), (6, True), (6, False)])
def test_deep_supervision_weights_and_loss_match_jax(n, mask_last):
    np.testing.assert_array_equal(L.deep_supervision_weights(n, mask_last),
                                  jL.deep_supervision_weights(n, mask_last))
    rng = np.random.RandomState(7)
    outs = [rng.randn(2, 16 >> i, 12 >> i, 3).astype(np.float32) for i in range(n)]
    segs = [rng.randint(0, 3, (2, 16 >> i, 12 >> i)).astype(np.int32) for i in range(n)]
    wts = jL.deep_supervision_weights(n, mask_last)
    ref = jL.deep_supervision_loss([jnp.asarray(o) for o in outs], [jnp.asarray(s) for s in segs],
                                   jL.dice_and_ce_loss, wts)
    got = L.deep_supervision_loss([torch.from_numpy(o) for o in outs],
                                  [torch.from_numpy(s) for s in segs], L.dice_and_ce_loss, wts)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("pools", [((2, 2),) * 3, ((2, 2), (1, 2), (2, 1))])
def test_downsample_seg_for_ds_matches_jax(pools):
    seg = np.random.RandomState(8).randint(0, 3, (2, 24, 20)).astype(np.int32)
    ref = jL.downsample_seg_for_ds(jnp.asarray(seg), pools)
    got = L.downsample_seg_for_ds(torch.from_numpy(seg), pools)
    assert len(got) == len(ref) == len(pools)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- make_seg_loss: loss, Dice statistics, every gradient --------------------


@pytest.mark.parametrize("conv_impl", ["pallas", "native"])
def test_make_seg_loss_and_every_gradient_match_jax(seg_case, conv_impl):
    params, batch, ref_loss, ref_aux, ref_grads = seg_case
    net = _port_net(params, conv_impl)
    loss, aux = trainer.make_seg_loss(_config())(net, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)
    for k in ("tp", "fp", "fn"):
        assert aux[k].shape == (3,)
        np.testing.assert_allclose(aux[k].detach().numpy(), ref_aux[k], rtol=1e-5, err_msg=k)
    assert ref_aux["tp"][1:].min() > 0  # both foreground classes present
    ref = _torch_layout(ref_grads)
    # the lowest head has weight 0: no gradient in the port, zeros in JAX
    assert net.seg_head_2.weight.grad is None and not ref["seg_head_2.weight"].any()
    for name, p in net.named_parameters():
        if name == "seg_head_2.weight":
            continue
        r = ref[name]
        np.testing.assert_allclose(p.grad.numpy(), r, atol=GRAD_TOL * float(np.abs(r).max())
                                   + 1e-6, rtol=0, err_msg=name)


def test_one_sgd_step_matches_optax_with_the_zero_weight_head(seg_case):
    """The update p - p0 of one SGD-Nesterov step (poly lr, decay 3e-5,
    clip 12), element by element, against optax on the JAX gradients: the
    first update is -lr (1 + momentum) (g + decay p), so it may differ by
    that factor times the gradient tolerance. The zero-weight head gets no
    gradient and must still decay as optax decays it (fault F1)."""
    params, batch, _, _, ref_grads = seg_case
    total = 10
    tx = jsched.build_optimizer(jexp.OptimConfig(**SGD), total)
    updates, _ = jax.jit(tx.update)(ref_grads, tx.init(params), params)
    ref_new = _torch_layout(optax.apply_updates(params, updates))
    ref_g = _torch_layout(ref_grads)

    net = _port_net(params, "pallas")
    p0 = {k: v.detach().clone().numpy() for k, v in net.named_parameters()}
    opt = schedules.build_optimizer(texp.OptimConfig(**SGD), total, net.parameters())
    loss, _ = trainer.make_seg_loss(_config())(net, _torch_batch(batch))
    loss.backward()
    opt.step()
    factor = opt.schedule(0) * (1 + texp.OptimConfig().sgd_momentum)
    for name, p in net.named_parameters():
        got, want = p.detach().numpy() - p0[name], ref_new[name] - p0[name]
        ulp = np.spacing(np.maximum(np.abs(p0[name]), np.abs(ref_new[name])))
        tol = factor * (GRAD_TOL * float(np.abs(ref_g[name]).max()) + 1e-6) + 2 * ulp
        assert (np.abs(got - want) <= tol).all(), name
        assert np.abs(want).max() > 0, name
    head = net.seg_head_2.weight.detach().numpy()
    np.testing.assert_allclose(head - p0["seg_head_2.weight"],
                               ref_new["seg_head_2.weight"] - p0["seg_head_2.weight"], rtol=1e-5)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_optimizer_updates_a_parameter_without_a_gradient_as_optax(optimizer):
    """Fault F1: a parameter autograd gave no gradient is updated with a
    zero one (decay and momentum), as optax updates every leaf."""
    cfg = dict(optimizer=optimizer, initial_lr=0.05, weight_decay=0.02)
    rng = np.random.RandomState(9)
    params = {"w": rng.randn(4, 3).astype(np.float32), "h": rng.randn(5).astype(np.float32)}
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    tx = jsched.build_optimizer(jexp.OptimConfig(**cfg), 10)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = schedules.build_optimizer(texp.OptimConfig(**cfg), 10, tp.values())
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g), "h": jnp.zeros(5)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        tp["w"].grad = torch.from_numpy(g)
        assert tp["h"].grad is None
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)
    assert not np.allclose(tp["h"].detach().numpy(), params["h"])


# -- dataset files, split, patch loader --------------------------------------


@pytest.mark.parametrize("n", [2, 5, 7, 12, 23])
def test_do_split_matches_jax(n, tmp_path):
    ids = [f"case_{i:03d}" for i in range(n)][::-1]
    for fold in range(min(5, n)):
        assert dataset.do_split(ids, fold) == jdataset.do_split(ids, fold)
    assert dataset.do_split(ids, "all") == jdataset.do_split(ids, "all")
    jdataset.do_split(ids, 0, splits_file=tmp_path / "splits.pkl")  # written by JAX
    assert dataset.do_split(ids, 1, splits_file=tmp_path / "splits.pkl") == \
        jdataset.do_split(ids, 1)


def _write_preprocessed(folder, n=3, shape=(4, 40, 36), seed=10):
    """Preprocessed cases as the preprocessor writes them: data and seg
    stacked in <case>.npz, properties with class_locations in <case>.pkl;
    the last case has no foreground."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        data = rng.randn(1, *shape).astype(np.float32)
        seg = np.zeros((1, *shape), np.float32)
        if i < n - 1:
            seg[0, 1:3, 10:20, 5 + i:15 + i] = 1
            seg[0, 2, 25:30, 20:30] = 2
        seg[0, :, :2] = -1  # outside the nonzero mask
        locs = {c: np.argwhere(seg[0] == c) for c in (1, 2)}
        np.savez_compressed(folder / f"c{i}.npz", data=np.vstack([data, seg]))
        with open(folder / f"c{i}.pkl", "wb") as f:
            pickle.dump({"class_locations": locs}, f)


@pytest.mark.parametrize("patch", [(24, 20), (3, 16, 16)])
def test_seg_patch_loader_matches_jax(tmp_path, patch):
    _write_preprocessed(tmp_path)
    dataset.unpack_dataset(tmp_path)
    ds, jds = dataset.load_dataset(tmp_path), jdataset.load_dataset(tmp_path)
    assert ds == jds and all(e["npy_file"].exists() for e in ds.values())
    got_it = loaders.SegPatchLoader(ds, patch, 5, seed=11)
    ref_it = jloaders.SegPatchLoader(jds, patch, 5, seed=11)
    for _ in range(4):
        got, ref = next(got_it), next(ref_it)
        for k in ("data", "seg"):
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["data"].shape == (5, *patch, 1) and got["seg"].min() >= 0


def test_patch_extraction_matches_the_numpy_branch():
    from csof_tpu.native.bindings import _extract_fallback

    src = np.random.RandomState(12).rand(2, 9, 11, 7).astype(np.float32)
    for patch, centers in (((4, 6, 5), [(0, 0, 0), (8, 10, 6), (4, 5, 3), (-9, 2, 2)]),
                           ((6, 8), [(0, 0), (10, 6), (5, 3)])):
        arr = src if len(patch) == 3 else src[:, 4]
        ref = _extract_fallback(arr, np.asarray(centers), np.asarray(patch),
                                np.empty((len(centers), 2, *patch), np.float32))
        np.testing.assert_array_equal(loaders.extract_patches(arr, centers, patch), ref)


def test_prefetcher_yields_the_loader_stream_and_raises_its_errors():
    it = iter(range(5))
    pf = loaders.Prefetcher(it, depth=2)
    assert [next(pf) for _ in range(5)] == list(range(5))
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    assert not pf.thread.is_alive()


def test_run_cropping_and_preprocessor_run_write_the_jax_files(tmp_path):
    cases = []
    for i in range(2):
        img, seg = _write_case(tmp_path, f"case{i}", seed=3 + i)
        cases.append((f"case{i}", [str(img)], str(seg)))
    plans_t, plans_j = _plans(tplans), _plans(jplans)
    cropping.run_cropping(cases, tmp_path / "crop_t")
    jcrop.run_cropping(cases, tmp_path / "crop_j", num_workers=1)
    assert Preprocessor(plans_t).run(tmp_path / "crop_t", tmp_path / "pre_t") == ["case0", "case1"]
    JaxPreprocessor(plans_j).run(tmp_path / "crop_j", tmp_path / "pre_j", num_workers=1)
    for sub in ("crop", "pre"):
        for c in ("case0", "case1"):
            a = np.load(tmp_path / f"{sub}_t" / f"{c}.npz")["data"]
            b = np.load(tmp_path / f"{sub}_j" / f"{c}.npz")["data"]
            np.testing.assert_array_equal(a, b)
            with open(tmp_path / f"{sub}_t" / f"{c}.pkl", "rb") as fa, \
                    open(tmp_path / f"{sub}_j" / f"{c}.pkl", "rb") as fb:
                _same_props(pickle.load(fa), pickle.load(fb))
    dataset.unpack_dataset(tmp_path / "pre_t")
    data, props = dataset.load_case(dataset.load_dataset(tmp_path / "pre_t")["case1"])
    ref, _ = jdataset.load_case(jdataset.load_dataset(tmp_path / "pre_j")["case1"])
    np.testing.assert_array_equal(data, ref)
    assert isinstance(data, np.memmap) and set(props["class_locations"]) == {1, 2}


# -- the Trainer --------------------------------------------------------------


def _small_plans():
    return _plans(tplans, pools=((2, 2),) * 3)


def test_unet_trainer_runs_two_epochs_writes_the_triad_and_reloads(tmp_path, monkeypatch):
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    monkeypatch.delenv("CSOF_FUSED_NORM", raising=False)
    _write_preprocessed(tmp_path / "pre", shape=(3, 70, 66))
    dataset.unpack_dataset(tmp_path / "pre")
    ds = dataset.load_dataset(tmp_path / "pre")
    config = dataclasses.replace(_config(), max_num_epochs=2, num_batches_per_epoch=2,
                                 num_val_batches_per_epoch=1, seed=5)
    out = tmp_path / "out"
    tr = trainer.Trainer(config, out, plans=_small_plans(), device="cpu")
    tr.checkpoint_every = 2
    tr.initialize()
    assert isinstance(tr.model, GenericUNet) and tr.model.num_pool == 3
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    hist = tr.run_training(loaders.SegPatchLoader(ds, PATCH, 2, seed=0),
                           val_iter=loaders.SegPatchLoader(ds, PATCH, 2, seed=1))
    assert len(hist.train_losses) == len(hist.val_losses) == len(hist.eval_metrics) == 2
    assert np.isfinite(hist.train_losses).all() and 0 <= hist.eval_metrics[-1] <= 1
    assert tr.optimizer.count == 4 and len(hist.step_times) == 4
    changed = [k for k, v in tr.model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(changed) == len(before)  # the zero-weight head decays too
    for name in (ckpt.BEST, ckpt.LATEST, ckpt.FINAL):
        assert (out / name).is_file() and (out / (name + ".json")).is_file()
    (log,) = read_training_logs(out)
    assert log[0].startswith("epoch 1:") and " fg-dice " in log[1]
    trained = {k: v.clone() for k, v in tr.model.state_dict().items()}
    fresh = trainer.Trainer(config, out, plans=_small_plans(), device="cpu")
    meta = fresh.load_checkpoint()
    assert meta["epoch"] == 2 and fresh.optimizer.count == 4
    assert all(torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items())


def test_unet_trainer_refuses_fused_norm_augmentation_and_3d(tmp_path, monkeypatch):
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    with pytest.raises(NotImplementedError, match="K5, which has no backward"):
        trainer.Trainer(_config(), tmp_path, plans=_small_plans(), device="cpu")
    monkeypatch.delenv("CSOF_FUSED_NORM")
    aug = _config()
    aug.data.do_data_aug = True  # augmentation trains since it was ported
    trainer.Trainer(aug, tmp_path, device="cpu")
    # the 3D U-Net trains since it was ported, with CSOF_FUSED_NORM=1 too (K5
    # never runs on its 5-D tensors), and so does VoxelMorph since it was
    # ported (it runs no K5); unknown kinds are refused
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    trainer.Trainer(dataclasses.replace(_config(), model="unet3d"), tmp_path, device="cpu")
    trainer.Trainer(dataclasses.replace(_config(), model="voxelmorph"), tmp_path, device="cpu")
    monkeypatch.delenv("CSOF_FUSED_NORM")
    with pytest.raises(NotImplementedError, match="not ported"):
        trainer.Trainer(dataclasses.replace(_config(), model="swin"), tmp_path, device="cpu")
    net = trainer.build_model(_config(), 3)  # the no-plans default: base 16, 4 pools
    assert net.num_pool == 4 and net.base_num_features == 16


def test_momentum_rescue_f5_on_both_sides(tmp_path):
    """Fault F5. nnU-Net compares its epoch counter before incrementing it,
    so the rescue fires once the epoch numbered momentum_rescue_epoch from
    zero has finished (momentum_rescue_epoch + 1 epochs done): the port's
    behaviour. The JAX trainer increments first and fires one epoch
    earlier."""
    config = _config(momentum_rescue_epoch=2)
    tr = trainer.Trainer(config, tmp_path, plans=_small_plans(), device="cpu").initialize()
    jcfg = jexp.ExperimentConfig(model="unet2d",
                                 optim=jexp.OptimConfig(**SGD, momentum_rescue_epoch=2))
    fired = {"port": [], "jax": []}
    for done in range(1, 5):
        tr.epoch, tr.history.eval_metrics = done, [0.0]
        if tr._maybe_momentum_rescue(log_fn=lambda m: None):
            fired["port"].append(done)
            tr.config = config
        stub = types.SimpleNamespace(
            config=jcfg, epoch=done, history=jtrainer.TrainerHistory(eval_metrics=[0.0]),
            state=types.SimpleNamespace(step=7), mesh=make_mesh(1, 1), _init_example=(),
            model=types.SimpleNamespace(init=lambda key: {"params": {"w": jnp.zeros(2)}},
                                        apply=None))
        if jtrainer.Trainer._maybe_momentum_rescue(stub, log_fn=lambda m: None):
            fired["jax"].append(done)
    assert fired == {"port": [3], "jax": [2]}


# -- the port stands alone ----------------------------------------------------


def test_unet_training_imports_no_jax_flax_yaml_or_sklearn(tmp_path):
    """A fresh interpreter with jax, flax, yaml, sklearn and the JAX package
    blocked imports the new modules and runs a U-Net train step through
    the Trainer on the CPU, K6 routed in both directions."""
    code = textwrap.dedent(f"""
        import sys
        for m in ("jax", "flax", "yaml", "sklearn", "csof_tpu", "optax"):
            sys.modules[m] = None
        import numpy as np, torch
        from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
        from csof_tpu_torch.data.dataset import do_split, load_dataset, unpack_dataset
        from csof_tpu_torch.data.loaders import Prefetcher, SegPatchLoader
        from csof_tpu_torch.data.cropping import run_cropping
        from csof_tpu_torch.data.preprocessing import Preprocessor
        from csof_tpu_torch.ops.kernels.conv import Conv3x3Function
        from csof_tpu_torch.ops.kernels.ncc import ncc_loss_kernel, ncc_map
        from csof_tpu_torch.training.trainer import Trainer, make_seg_loss
        from csof_tpu_torch.models.unet import GenericUNet
        train_ids, val_ids = do_split(["a", "b", "c", "d", "e"], 0)
        assert len(val_ids) == 1 and sorted(train_ids + val_ids) == list("abcde")
        cfg = ExperimentConfig(model="unet2d", max_num_epochs=1, num_batches_per_epoch=1,
                               optim=OptimConfig(optimizer="sgd", scheduler="poly",
                                                 initial_lr=1e-2),
                               data=DataConfig(do_data_aug=False))
        tr = Trainer(cfg, {str(tmp_path)!r}, num_classes=2, device="cpu").initialize()
        rng = np.random.RandomState(0)
        batch = {{"data": rng.randn(1, 64, 64, 1).astype(np.float32),
                  "seg": rng.randint(0, 2, (1, 64, 64)).astype(np.int32)}}
        loss, aux = tr.run_iteration(batch)
        assert np.isfinite(loss) and aux["tp"].shape == (2,)
        print("ok")
    """)
    env_code = "import os; os.environ['CSOF_CONV2D_IMPL'] = 'pallas'\n" + code
    res = subprocess.run([sys.executable, "-c", env_code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")

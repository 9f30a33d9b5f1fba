"""The port's 3D U-Net against the JAX package's on the CPU, at a small size:
base 4, pools (1, 2, 2), (2, 2, 2), kernels (1, 3, 3) then (3, 3, 3), input
(2, 1, 8, 32, 32), so that K6's route (an input at least 32 wide) is taken
at level 0, by the (1, 3, 3) encoder convs (one z tap) and the (3, 3, 3)
decoder convs (three).

- The forward in float32 and bfloat16 with the same flax parameters
  (``load_flax_params``), switches off: JAX's ``Conv3dVia2D`` against
  ``F.conv3d``.
- ``CSOF_CONV2D_IMPL=pallas``: JAX's Pallas conv in interpret mode (as its
  own tests run it) in every z tap against K6's plain version in the port's
  tap sum, and the port's ``kernel_launches`` equal to the Pallas calls JAX
  traces.
- ``CSOF_CONV3D_IMPL=native`` and ``CSOF_FUSED_NORM=1``: no K6 and no K5 on
  the 3D net, the same output.
- The loss and every gradient of one ``unet3d`` step (deep-supervision Dice
  + CE) under ``pallas`` (K6 and its dx, plain) against JAX with the switch
  off (F8: JAX cannot differentiate its Pallas conv here), with remat off,
  ``full`` and ``save_conv``; and the trainer builds and steps ``unet3d``
  with ``CSOF_FUSED_NORM=1`` set.

Tolerances: float32 differs by the order of float32 sums (1e-4 absolute on
logits); bfloat16 by a few bf16 ulps, rounded at other points (6e-2, 2e-2,
as the 2D U-Net's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_unet import UNET_TOL
from torch.profiler import ProfilerActivity, profile

import csof_tpu.ops.pallas.conv as jconv
import csof_tpu.ops.pallas.norm_act as jna
from csof_tpu.config import experiment as jexp
from csof_tpu.config import plans as jplans
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.models.unet import unet_from_plans as jax_unet_from_plans
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config import experiment as texp
from csof_tpu_torch.config import plans as tplans
from csof_tpu_torch.models import blocks
from csof_tpu_torch.models.unet import GenericUNet, unet_from_plans
from csof_tpu_torch.ops.kernels import conv as k6
from csof_tpu_torch.training import trainer
from csof_tpu_torch.utils import profiling

torch_threads.pin()

SMALL3D = dict(num_classes=3, base_num_features=4, pool_kernel_sizes=((1, 2, 2), (2, 2, 2)),
               conv_kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3)))
SHAPE = (2, 1, 8, 32, 32)  # (N, C, D, H, W)
#: routed convs of one forward at W = 32 (level 1 is 16 wide): the two
#: (1, 3, 3) encoder convs of level 0 one tap each, its two (3, 3, 3)
#: decoder convs three each; no dx for the first (its input is the data)
LAUNCHES = {"K5": 0, "K6": 8, "K7": 0}
LAUNCHES_DX = 7
#: float32 loss (relative) and gradients (|diff| <= GRAD_TOL max|leaf| + 1e-6
#: per leaf): the same math summed in another order
LOSS_RTOL, GRAD_TOL = 1e-5, 2e-3


def _plans(module):
    stage = module.StagePlans(batch_size=2, patch_size=SHAPE[2:],
                              current_spacing=(2.0, 1.25, 1.25),
                              original_spacing=(2.0, 1.25, 1.25),
                              pool_op_kernel_sizes=[list(p) for p in SMALL3D["pool_kernel_sizes"]],
                              conv_kernel_sizes=[list(k) for k in SMALL3D["conv_kernel_sizes"]])
    return module.Plans(task="Task002_Heart", num_modalities=1, num_classes=2,
                        all_classes=[1, 2], normalization_schemes={0: "zscore"},
                        use_mask_for_norm={0: False}, transpose_forward=(0, 1, 2),
                        transpose_backward=(0, 1, 2), base_num_features=4,
                        plans_per_stage={0: stage})


def _input(seed=3):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def _channels_last(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    n, _, d, h, w = SHAPE
    zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]
    seg = np.zeros((n, d, h, w), np.int32)
    for i in range(n):  # two blobs, so that both foreground classes are present
        seg[i][(zz - 3) ** 2 + (yy - 10 - 3 * i) ** 2 + (xx - 12) ** 2 < 40] = 1
        seg[i][(zz - 5) ** 2 + (yy - 22) ** 2 + (xx - 20 + 2 * i) ** 2 < 25] = 2
    data = (rng.randn(n, d, h, w, 1) + seg[..., None]).astype(np.float32)
    return {"data": data, "seg": seg}


@pytest.fixture(scope="module")
def params():
    """Flax parameters of the small 3D net: shapes from eval_shape of init,
    values from a seed, every leaf non-trivial."""
    x = jax.ShapeDtypeStruct((1, *SHAPE[2:], 1), jnp.float32)
    shapes = jax.eval_shape(JaxUNet(**SMALL3D).init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((name == "scale") + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_forward(params, x, dtype=jnp.float32, **env):
    """The JAX net's heads (channels first) under the environment ``env``
    (CSOF_* variables; unset otherwise), traced afresh so that the switches
    are read."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("CSOF_CONV2D_IMPL", "CSOF_CONV3D_IMPL", "CSOF_FUSED_NORM"):
            mp.delenv(var, raising=False)
        for var, value in env.items():
            mp.setenv(var, value)
        net = JaxUNet(**SMALL3D, dtype=dtype)
        out = jax.jit(lambda p, v: net.apply({"params": p}, v))(params, _channels_last(x))
    return [np.moveaxis(np.asarray(o, np.float32), -1, 1) for o in out]


def _port(params, dtype=torch.float32, **kw):
    net = GenericUNet(in_channels=1, dtype=dtype, **SMALL3D, **kw)
    load_flax_params(net, params)
    return net


def _assert_heads(got, ref, dtype: str):
    assert len(got) == len(ref) == 2
    atol, rtol = UNET_TOL[dtype]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().float().numpy(), r, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(params, dtype):
    x = _input()
    ref = _jax_forward(params, x, jnp.dtype(dtype))
    with torch.no_grad():
        got = _port(params, getattr(torch, dtype))(torch.from_numpy(x))
    _assert_heads(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_switch_runs_k6_in_the_z_taps_jax_routes(params, dtype, monkeypatch):
    calls = {"jax": 0, "port": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jconv, "conv3x3_cols_vb", counting("jax", jconv.conv3x3_cols_vb))
    x = _input()
    ref = _jax_forward(params, x, jnp.dtype(dtype), CSOF_CONV2D_IMPL="pallas")
    monkeypatch.setattr(blocks, "conv3x3", counting("port", blocks.conv3x3))
    net = _port(params, getattr(torch, dtype), conv_impl="pallas")
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _assert_heads(got, ref, dtype)
    assert calls["jax"] == calls["port"] == LAUNCHES["K6"]
    assert net.kernel_launches(SHAPE[2:]) == LAUNCHES
    assert net.kernel_launches(SHAPE[2:], backward=True)["K6_dx"] == LAUNCHES_DX


def test_conv3d_native_and_fused_norm_run_no_kernel_on_the_3d_net(params, monkeypatch):
    """CSOF_CONV3D_IMPL=native turns the Pallas switch off on 3D convs;
    CSOF_FUSED_NORM=1 never reaches a 5-D tensor: both packages run no
    kernel, and give the same output."""
    calls = {"jax": 0}

    def counting(fn):
        def wrapped(*a, **k):
            calls["jax"] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jconv, "conv3x3_cols_vb", counting(jconv.conv3x3_cols_vb))
    monkeypatch.setattr(jna, "instance_norm_leaky_relu_pallas",
                        counting(jna.instance_norm_leaky_relu_pallas))
    env = dict(CSOF_CONV2D_IMPL="pallas", CSOF_CONV3D_IMPL="native", CSOF_FUSED_NORM="1")
    x = _input()
    ref = _jax_forward(params, x, **env)
    assert calls["jax"] == 0
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    net = unet_from_plans(_plans(tplans))
    load_flax_params(net, params)
    assert net.kernel_launches(SHAPE[2:], backward=True) == {"K5": 0, "K6": 0, "K7": 0,
                                                             "K6_dx": 0, "K6_dw": 0, "K7_dx": 0}
    k6.launches = 0
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _assert_heads(got, ref, "float32")
    # the same plans in JAX: remat on with save_conv, as the port's default
    jnet = jax_unet_from_plans(_plans(jplans))
    assert (jnet.remat, jnet.remat_policy) == (net.remat, net.remat_policy) == (True, "save_conv")
    monkeypatch.setenv("CSOF_CONV3D_IMPL", "2d")
    assert unet_from_plans(_plans(tplans)).kernel_launches(SHAPE[2:]) == LAUNCHES


@pytest.fixture(scope="module")
def jax_step(params):
    """JAX loss, Dice statistics and gradients of make_seg_loss on the 3D
    net, switches off."""
    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        for var in ("CSOF_CONV2D_IMPL", "CSOF_CONV3D_IMPL", "CSOF_FUSED_NORM"):
            mp.delenv(var, raising=False)
        loss_fn = jtrainer.make_seg_loss(jexp.ExperimentConfig(model="unet3d"), JaxUNet(**SMALL3D))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn({"params": p}, jbatch), has_aux=True))(params)
    scratch = GenericUNet(in_channels=1, **SMALL3D)
    load_flax_params(scratch, jax.tree_util.tree_map(np.asarray, grads))
    want = {k: v.detach().numpy() for k, v in scratch.named_parameters()}
    return batch, float(loss), {k: np.asarray(v) for k, v in aux.items()}, want


@pytest.mark.parametrize("remat", ["off", "full", "save_conv"])
def test_unet3d_step_loss_and_every_gradient_match_jax(params, jax_step, remat, monkeypatch):
    batch, ref_loss, ref_aux, want = jax_step
    kw = {} if remat == "off" else dict(remat=True, remat_policy=remat)
    net = _port(params, conv_impl="pallas", **kw)
    monkeypatch.setattr(k6, "bwd_launches", 0)
    loss_fn = trainer.make_seg_loss(texp.ExperimentConfig(model="unet3d"))
    tb = {"data": torch.from_numpy(batch["data"]).movedim(-1, 1).contiguous(),
          "seg": torch.from_numpy(batch["seg"])}
    dx = {"n": 0, "dw": 0}
    real_dx, real_dw = k6.conv3x3_dx_plain, k6.conv3x3_dw_plain

    def counted_dx(*a):
        dx["n"] += 1
        return real_dx(*a)

    def counted_dw(*a):
        dx["dw"] += 1
        return real_dw(*a)

    monkeypatch.setattr(k6, "conv3x3_dx_plain", counted_dx)
    monkeypatch.setattr(k6, "conv3x3_dw_plain", counted_dw)
    loss, aux = loss_fn(net, tb)
    loss.backward()
    assert abs(loss.item() - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_allclose(aux[k].detach().numpy(), ref_aux[k], rtol=1e-4, atol=1e-3)
    for name, p in net.named_parameters():
        ref = want[name]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max() + 1e-6, f"{name}: {err:.2e}"
    assert dx["n"] == net.kernel_launches(SHAPE[2:], backward=True)["K6_dx"] == LAUNCHES_DX
    assert dx["dw"] == net.kernel_launches(SHAPE[2:], backward=True)["K6_dw"] == LAUNCHES["K6"]


@pytest.mark.parametrize("n,kernel,stride", [(1, (3, 3, 3), (1, 1, 1)), (1, (1, 3, 3), (1, 1, 1)),
                                               (2, (3, 3, 3), (2, 1, 1))])
def test_k6_taps_fold_any_batch_into_contiguous_planes(n, kernel, stride, monkeypatch):
    """The z-tap route hands K6 contiguous (N * D_out, Ci, H, W) planes (as
    the kernel requires; a batch of 1 folds without a copy otherwise) and
    gives a contiguous (N, Co, D_out, H, W) output equal to F.conv3d's."""
    block = blocks.ConvNormAct(3, 4, stride, "instance", kernel_size=kernel, conv_impl="pallas",
                               generator=torch.Generator().manual_seed(0))
    seen = []
    real = blocks.conv3x3

    def checked(x, w, b=None, out_f32=False):
        seen.append(x.is_contiguous() and w.is_contiguous() and x.dim() == 4)
        return real(x, w, b, out_f32)

    monkeypatch.setattr(blocks, "conv3x3", checked)
    x = torch.from_numpy(np.random.RandomState(4).randn(n, 3, 7, 12, 36).astype(np.float32))
    with torch.no_grad():
        got = block._k6_taps(x)
        ref = block.Conv_0(x)
    assert seen == [True] * kernel[0] and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_trainer_builds_and_steps_unet3d_with_fused_norm_set(tmp_path, monkeypatch):
    """unet3d trains (no augmentation, as in JAX); CSOF_FUSED_NORM=1 is not
    refused for it, since K5 never runs on its 5-D tensors; without plans
    the JAX package's default 3D net (base 16, 4 pools of 2, kernels of 3)."""
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    cfg = texp.ExperimentConfig(model="unet3d", data=texp.DataConfig(do_data_aug=True),
                                optim=texp.OptimConfig(optimizer="sgd", scheduler="poly",
                                                       initial_lr=1e-2))
    tr = trainer.Trainer(cfg, tmp_path, plans=_plans(tplans), device="cpu").initialize()
    assert tr.model.remat_policy == "save_conv" and tr.model.kernel_launches(SHAPE[2:])["K5"] == 0
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    loss, _ = tr.run_iteration(_batch(seed=5))
    assert np.isfinite(loss) and tr.optimizer.count == 1
    assert any(not torch.equal(v, before[k]) for k, v in tr.model.state_dict().items())
    net = trainer.build_model(cfg, 3)
    assert net.num_pool == 4 and net.base_num_features == 16
    assert net.conv_kernel_sizes == [(3, 3, 3)] * 5 and not net.remat


def _spans(prof) -> list:
    """(name, start, end) of the csof: spans of a profile."""
    return [(e.name[len(profiling.SPAN_PREFIX):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]


def _inside(spans: list, name: str, outer: str) -> int:
    """How many ``name`` spans lie inside an ``outer`` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return sum(any(lo <= s and e <= hi for lo, hi in outs) for n, s, e in spans if n == name)


@pytest.mark.parametrize("remat", [True, False], ids=["save_conv", "remat_off"])
def test_a_3d_train_step_opens_the_ztaps_and_norm_act_spans(tmp_path, monkeypatch, remat):
    """Under pallas, each routed 3D block opens block3d.ztaps and every 3D
    block block3d.norm_act inside train.forward; save_conv (the plans'
    default) opens block3d.norm_act once more a block inside train.backward,
    in its recompute. An evaluation and a forward without grad open none."""
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    cfg = texp.ExperimentConfig(model="unet3d", data=texp.DataConfig(do_data_aug=False))
    tr = trainer.Trainer(cfg, tmp_path, plans=_plans(tplans), device="cpu").initialize()
    convs = [m for m in tr.model.modules() if isinstance(m, blocks.ConvNormAct)]
    for m in convs:
        m.remat_norm_act = remat
    routed = 4  # level 0's two encoder and two decoder blocks; level 1 is 16 wide
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = tr.run_iteration(_batch())
    spans = _spans(prof)
    assert np.isfinite(loss)
    assert sum(n == "block3d.ztaps" for n, _, _ in spans) == routed
    assert _inside(spans, "block3d.ztaps", "train.forward") == routed
    assert _inside(spans, "block3d.norm_act", "train.forward") == len(convs) == 10
    assert _inside(spans, "block3d.norm_act", "train.backward") == (len(convs) if remat else 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run_iteration(_batch(), train=False)
        with torch.no_grad():
            tr.model(torch.from_numpy(_input()))
    assert _spans(prof) == []

"""The JAX package's two kernel switches on SegFlow, against the port:
``CSOF_CONV2D_IMPL=pallas`` (the JAX Pallas conv, in interpret mode as its
own tests run it, against kernel K6's plain version: the same convs routed,
the same outputs, the same ``concat`` gradients), ``CSOF_FUSED_NORM=1`` with
``norm="instance"`` (the Pallas InstanceNorm + LeakyReLU against K5's plain
version) and ``CSOF_CONV2D_IMPL=tapsum`` (a TPU form of the native conv:
SegFlow and the U-Net both). Frames 64 wide with dims (8, 16), so that both
levels route (the JAX rule wants an input at least 32 wide); batch 1, T = 3,
``scan_unroll`` > T so that JAX traces each frame's step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_segflow import SMALL, TOL, _video, small_params
from test_torch_unet import SMALL as UNET_SMALL
from test_torch_unet import UNET_TOL, _flax_params

import csof_tpu.ops.pallas.conv as jconv
import csof_tpu.ops.pallas.norm_act as jna
from csof_tpu.config.experiment import SegFlowModelConfig as JaxConfig
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.models import blocks
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.models.unet import GenericUNet
from csof_tpu_torch.ops.kernels import conv as k6
from csof_tpu_torch.ops.kernels import norm_act as k5

torch_threads.pin()

T, HW = 3, 64
#: routed convs of one forward at (8, 16) on 64-wide frames, T = 3 (level
#: 1 and the bottleneck are 32 wide): the query encoder's level-0 convs and
#: level 1's second, the same for the memory encoder each frame, the decoder
#: level's two convs (the seg decoder once, the flow decoder each full
#: frame), the step's ConvNormAct_0 each frame, and the concat skip fuse at
#: level 0 (full frames) and level 1 (every frame); concat_cm routes no skip
#: fuse
_COMMON = 3 + 2 + 3 * 3 + 2 * 2 + 3
ROUTED = {"concat": _COMMON + 2 + 3, "concat_cm": _COMMON, "project": _COMMON + 2 + 3}


def _counting(calls, key, fn):
    def wrapped(*a, **k):
        calls[key] += 1
        return fn(*a, **k)
    return wrapped


def _scalar(seg, flow, cum, reg):
    """A loss of every output, the same expression in both frameworks."""
    return (seg ** 2).mean() + (cum ** 2).mean() + reg.mean() + (flow * 0.5).mean()


@pytest.mark.parametrize("mode", ["concat", "concat_cm", "project"])
def test_pallas_switch_routes_the_convs_jax_routes(mode, monkeypatch):
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    cfg_kw = dict(SMALL, corr_fuse=mode, dtype="float32", scan_unroll=8)
    params = small_params(JaxConfig(**cfg_kw), seed=1)
    video = _video(seed=11, b=1, t=T, hw=HW)
    calls = {"jax": 0, "port": 0, "port_dx": 0, "port_dw": 0}
    monkeypatch.setattr(jconv, "conv3x3_cols_vb",
                        _counting(calls, "jax", jconv.conv3x3_cols_vb))
    jmodel = JaxSegFlow(cfg=JaxConfig(**cfg_kw))

    def jloss(p):
        out = jax.vmap(lambda x: jmodel.apply({"params": p}, x))(jnp.asarray(video))
        return _scalar(out["seg_logits"], out["flow"], out["cum_flow"], out["registered"]), out

    if mode == "concat":  # the gradients too (JAX's Pallas conv VJP, under vmap)
        (ref_loss, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    else:
        ref_loss, ref = jax.jit(jloss)(params)
    assert calls["jax"] == ROUTED[mode]

    monkeypatch.setattr(blocks, "conv3x3", _counting(calls, "port", blocks.conv3x3))
    monkeypatch.setattr(k6, "conv3x3_dx_plain", _counting(calls, "port_dx",
                                                          k6.conv3x3_dx_plain))
    monkeypatch.setattr(k6, "conv3x3_dw_plain", _counting(calls, "port_dw",
                                                          k6.conv3x3_dw_plain))
    model = SegFlow(SegFlowModelConfig(**cfg_kw), 4)  # the switch read from the environment
    load_flax_params(model, params)
    k6.launches = k6.bwd_launches = 0
    out = model(torch.from_numpy(video))
    loss = _scalar(out["seg_logits"], out["flow"], out["cum_flow"], out["registered"])
    loss.backward()
    assert k6.launches == k6.bwd_launches == 0  # CPU tensors: the plain versions
    counts = model.kernel_launches(T, HW, backward=True)
    assert calls["port"] == counts["K6"] == ROUTED[mode]
    # dx for every routed conv but the query encoder's first (the video) and
    # the memory encoder's first at frames 0 and 1 (no flow yet)
    assert calls["port_dx"] == counts["K6_dx"] == ROUTED[mode] - 1 - 2
    assert calls["port_dw"] == counts["K6_dw"] == ROUTED[mode]  # every weight trains
    atol, rtol = TOL["float32"]
    for k in ("seg_logits", "flow", "cum_flow", "registered"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), atol=atol,
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    if mode != "concat":
        return
    scratch = SegFlow(SegFlowModelConfig(**cfg_kw), 4)  # JAX's gradients in torch layout
    load_flax_params(scratch, jax.tree_util.tree_map(np.asarray, ref_grads))
    grads = dict(scratch.named_parameters())
    for name, p in model.named_parameters():
        r = grads[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=2e-3 * float(np.abs(r).max()) + 1e-6,
                                   rtol=0, err_msg=name)


def test_kernel_launches_at_the_flagship_geometry():
    """The counts ``chip_smoke.py`` holds the card to: the flagship widths
    (32, 64, 128) on 128-wide frames. A serving forward of 12 frames under
    fused_cm: the encoders' level-0 convs and level 1's second, the four
    decoder convs (level 2 is 128 channels wide: never routed); a concat
    training step of 6 frames adds the skip fuses of levels 0 and 1."""
    serving = SegFlow(SegFlowModelConfig(corr_fuse="fused_cm"), 4, conv_impl="pallas")
    assert serving.kernel_launches(12, 128) == {"K5": 0, "K6": 3 + 4 + 3 * 12 + 4 * 11}
    train = SegFlow(SegFlowModelConfig(deep_supervision=True), 4, conv_impl="pallas")
    assert train.kernel_launches(6, 128, backward=True) == {"K5": 0, "K6": 55, "K6_dx": 52,
                                                            "K6_dw": 55}
    off = SegFlow(SegFlowModelConfig(), 4, conv_impl="native")
    assert off.kernel_launches(6, 128, backward=True) == {"K5": 0, "K6": 0, "K6_dx": 0,
                                                          "K6_dw": 0}
    # remat runs each step's 48 routed convs again in the backward (K6 dw
    # once a conv: the recompute takes no weight gradient of its own)
    remat = SegFlow(SegFlowModelConfig(remat=True), 4, conv_impl="pallas")
    assert remat.kernel_launches(6, 128, backward=True) == {"K5": 0, "K6": 55 + 48,
                                                            "K6_dx": 52, "K6_dw": 55}


def test_remat_counts_its_recomputed_convs(monkeypatch):
    """Under remat the backward recomputes each step (torch.utils.checkpoint):
    the routed convs the port calls in a forward + backward are
    kernel_launches(backward=True)'s."""
    calls = {"fwd": 0, "dx": 0, "dw": 0}
    monkeypatch.setattr(blocks, "conv3x3", _counting(calls, "fwd", blocks.conv3x3))
    monkeypatch.setattr(k6, "conv3x3_dx_plain", _counting(calls, "dx", k6.conv3x3_dx_plain))
    monkeypatch.setattr(k6, "conv3x3_dw_plain", _counting(calls, "dw", k6.conv3x3_dw_plain))
    model = SegFlow(SegFlowModelConfig(**dict(SMALL, corr_fuse="split", remat=True,
                                              dtype="float32")), 4, conv_impl="pallas")
    out = model(torch.from_numpy(_video(seed=2, b=1, t=T, hw=HW)))
    _scalar(out["seg_logits"], out["flow"], out["cum_flow"], out["registered"]).backward()
    counts = model.kernel_launches(T, HW, backward=True)
    assert (calls["fwd"], calls["dx"], calls["dw"]) == (counts["K6"], counts["K6_dx"],
                                                        counts["K6_dw"])
    assert counts["K6"] > model.kernel_launches(T, HW)["K6"] == counts["K6_dw"]


def test_fused_norm_switch_runs_k5_where_jax_does(monkeypatch):
    """norm="instance" + CSOF_FUSED_NORM=1: the JAX package's Pallas
    InstanceNorm + LeakyReLU (interpret mode) in every ConvNormAct, the
    port's K5 (plain version here) in the same blocks; forward only."""
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    cfg_kw = dict(SMALL, corr_fuse="concat", norm="instance", dtype="float32", scan_unroll=8)
    params = small_params(JaxConfig(**cfg_kw), seed=2)
    video = _video(seed=12, b=2, t=T)
    calls = {"jax": 0, "port": 0}
    monkeypatch.setattr(jna, "instance_norm_leaky_relu_pallas",
                        _counting(calls, "jax", jna.instance_norm_leaky_relu_pallas))
    jmodel = JaxSegFlow(cfg=JaxConfig(**cfg_kw))
    ref = jax.jit(lambda p, v: jax.vmap(lambda x: jmodel.apply({"params": p}, x))(v))(
        params, jnp.asarray(video))
    monkeypatch.setattr(blocks, "instance_norm_leaky_relu",
                        _counting(calls, "port", blocks.instance_norm_leaky_relu))
    model = SegFlow(SegFlowModelConfig(**cfg_kw), 4)
    load_flax_params(model, params)
    k5.launches = 0
    with torch.no_grad():
        out = model(torch.from_numpy(video))
    assert k5.launches == 0
    assert calls["port"] == calls["jax"] == model.kernel_launches(T, 16)["K5"] > 0
    atol, rtol = TOL["float32"]
    for k in ("seg_logits", "flow", "cum_flow", "registered"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=atol, rtol=rtol,
                                   err_msg=k)


def test_tapsum_switch_runs_the_native_conv(monkeypatch):
    """CSOF_CONV2D_IMPL=tapsum: the JAX package runs its tap-sum form (a TPU
    reformulation), the port the native conv; SegFlow and the U-Net built
    under the switch match JAX."""
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "tapsum")
    cfg_kw = dict(SMALL, corr_fuse="concat", dtype="float32")
    params = small_params(JaxConfig(**cfg_kw), seed=3)
    video = _video(seed=13, b=1, t=T, hw=32)
    jmodel = JaxSegFlow(cfg=JaxConfig(**cfg_kw))
    ref = jax.jit(lambda p, v: jax.vmap(lambda x: jmodel.apply({"params": p}, x))(v))(
        params, jnp.asarray(video))
    model = SegFlow(SegFlowModelConfig(**cfg_kw), 4)
    load_flax_params(model, params)
    assert {m.conv_impl for m in model.modules() if hasattr(m, "conv_impl")} == {"tapsum"}
    with torch.no_grad():
        out = model(torch.from_numpy(video))
    atol, rtol = TOL["float32"]
    for k in ("seg_logits", "flow", "cum_flow", "registered"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=atol, rtol=rtol,
                                   err_msg=k)

    jnet = JaxUNet(**UNET_SMALL)
    uparams = _flax_params(jnet, seed=4)
    x = np.random.RandomState(14).randn(1, 64, 64, 1).astype(np.float32)
    uref = jax.jit(lambda p, v: jnet.apply({"params": p}, v))(uparams, jnp.asarray(x))
    net = GenericUNet(in_channels=1, conv_impl="tapsum", **UNET_SMALL)
    load_flax_params(net, uparams)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    atol, rtol = UNET_TOL["float32"]
    for g, r in zip(got, uref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), atol=atol,
                                   rtol=rtol)


def test_trainer_builds_segflow_under_the_switches(monkeypatch, tmp_path):
    """Trainer (through build_model) builds SegFlow with the environment's
    switches and trains under pallas; it refuses CSOF_FUSED_NORM=1 (K5 has
    no backward), for SegFlow as for the U-Net."""
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.training.trainer import Trainer

    config = ExperimentConfig(segflow=SegFlowModelConfig(**dict(SMALL, dtype="float32")),
                              data=DataConfig(do_data_aug=False))
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    trainer = Trainer(config, tmp_path, device="cpu").initialize()
    assert {m.conv_impl for m in trainer.model.modules() if hasattr(m, "conv_impl")} == {"pallas"}
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    with pytest.raises(NotImplementedError, match="K5"):
        Trainer(config, tmp_path, device="cpu")

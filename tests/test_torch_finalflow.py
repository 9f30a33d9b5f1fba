"""The port's FinalFlow against the JAX package's, on the CPU: each
bottleneck (``gru``, ``3d``, ``transformer``) with ``diffeomorphic`` off
and on, in float32 and (``gru``) bfloat16, batched over videos where the
JAX module takes one; then the kernel switches: under
``CSOF_CONV2D_IMPL=pallas`` the port calls kernel K6 (its plain version
here) exactly where and as often as the JAX package calls its Pallas conv
(interpret mode, as its own tests run it), and with ``norm="instance"`` and
``CSOF_FUSED_NORM=1`` kernel K5 where it calls its Pallas InstanceNorm +
LeakyReLU; ``FinalFlow.kernel_launches`` gives both counts.

Tolerances: float32 outputs within 1e-4 of the largest (the same sums in
another order, through the integration); bfloat16 within 5e-2 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_raft import random_params

import csof_tpu.ops.pallas.conv as jconv
import csof_tpu.ops.pallas.norm_act as jna
from csof_tpu.models.finalflow import FinalFlow as JaxFinalFlow
from csof_tpu.models.finalflow import FinalFlowConfig as JaxFinalFlowConfig
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.models import blocks
from csof_tpu_torch.models.finalflow import FinalFlow, FinalFlowConfig
from csof_tpu_torch.ops.kernels import conv as k6
from csof_tpu_torch.ops.kernels import norm_act as k5

torch_threads.pin()

SMALL = dict(out_encoder_dims=(8, 16), bottleneck_heads=2, int_steps=3)
OUTPUTS = ("flow", "flow_forward", "cum_flow", "registered", "velocity")


def _videos(seed, b=2, t=3, hw=32):
    return np.random.RandomState(seed).rand(b, t, hw, hw, 1).astype(np.float32)


def _counting(calls, key, fn):
    def wrapped(*a, **k):
        calls[key] += 1
        return fn(*a, **k)
    return wrapped


def _run_both(cfg_kw, videos, seed, count=None):
    """The JAX FinalFlow vmapped over the videos and the port's on the batch,
    the same parameters; ``count()`` installs the call counters once the
    parameters are drawn (their shapes come from a trace of init)."""
    jm = JaxFinalFlow(JaxFinalFlowConfig(**cfg_kw))
    params = random_params(jm, jnp.asarray(videos[0]), seed=seed)
    if count is not None:
        count()
    ref = jax.jit(jax.vmap(lambda v: jm.apply({"params": params}, v)))(videos)
    model = FinalFlow(FinalFlowConfig(**cfg_kw))
    load_flax_params(model, params)
    with torch.no_grad():
        out = model(torch.from_numpy(videos))
    return model, out, ref


def _compare(out, ref, tol):
    for k in OUTPUTS:
        if ref[k] is None:
            assert out[k] is None, k
            continue
        r = np.asarray(ref[k])
        assert tuple(out[k].shape) == r.shape, k
        np.testing.assert_allclose(out[k].float().numpy(), r, atol=tol * float(np.abs(r).max()),
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("bottleneck, diffeomorphic", [("gru", False), ("gru", True),
                                                       ("3d", True), ("transformer", False),
                                                       ("transformer", True)])
def test_finalflow_matches_jax(bottleneck, diffeomorphic):
    cfg_kw = dict(SMALL, bottleneck_type=bottleneck, diffeomorphic=diffeomorphic,
                  dtype="float32")
    seed = 3 * ("gru", "3d", "transformer").index(bottleneck) + diffeomorphic
    _, out, ref = _run_both(cfg_kw, _videos(seed), seed)
    assert float(np.abs(np.asarray(ref["flow"])[:, 1:]).max()) > 1e-3  # flows that moved
    assert not out["flow"][:, 0].any()  # frame 0 anchors as the identity
    _compare(out, ref, 1e-4)


def test_finalflow_one_video_and_bfloat16_match_jax():
    """A video without the batch axis gives the JAX module's layout; the gru
    bottleneck in bf16 (GroupNorm's bf16 path)."""
    cfg_kw = dict(SMALL, bottleneck_type="gru", dtype="bfloat16")
    videos = _videos(7, b=1)
    model, out, ref = _run_both(cfg_kw, videos, 7)
    _compare(out, ref, 5e-2)
    with torch.no_grad():
        single = model(torch.from_numpy(videos[0]))
    for k in ("flow", "registered"):
        assert single[k].shape == out[k].shape[1:]
        np.testing.assert_array_equal(single[k].numpy(), out[k][0].numpy())


def test_pallas_switch_runs_k6_where_jax_runs_its_pallas_conv(monkeypatch):
    """Frames 64 wide with dims (8, 16): level 0 (64 wide) and level 1 (32
    wide) route. T = 3: both encoders' three routed convs, the two fuses,
    and the decoder's two convs once a frame."""
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    calls = {"jax": 0, "port": 0}

    def count():
        monkeypatch.setattr(jconv, "conv3x3_cols_vb",
                            _counting(calls, "jax", jconv.conv3x3_cols_vb))
        monkeypatch.setattr(blocks, "conv3x3", _counting(calls, "port", blocks.conv3x3))

    cfg_kw = dict(SMALL, bottleneck_type="gru", dtype="float32")
    k6.launches = 0
    model, out, ref = _run_both(cfg_kw, _videos(11, b=1, t=3, hw=64), 11, count)
    assert k6.launches == 0  # CPU tensors: the plain version
    assert calls["port"] == calls["jax"] == model.kernel_launches(3, 64)["K6"] == 2 * 3 + 2 + 2 * 3
    _compare(out, ref, 1e-4)


def test_fused_norm_switch_runs_k5_where_jax_runs_its_pallas_norm(monkeypatch):
    """norm="instance" + CSOF_FUSED_NORM=1: every ConvNormAct's InstanceNorm +
    LeakyReLU, the decoder's per frame too (re-batched to 4-D in JAX)."""
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    calls = {"jax": 0, "port": 0}

    def count():
        monkeypatch.setattr(jna, "instance_norm_leaky_relu_pallas",
                            _counting(calls, "jax", jna.instance_norm_leaky_relu_pallas))
        monkeypatch.setattr(blocks, "instance_norm_leaky_relu",
                            _counting(calls, "port", blocks.instance_norm_leaky_relu))

    cfg_kw = dict(SMALL, bottleneck_type="3d", norm="instance", dtype="float32")
    k5.launches = 0
    model, out, ref = _run_both(cfg_kw, _videos(12, b=2, t=2, hw=64), 12, count)
    assert k5.launches == 0
    counts = model.kernel_launches(2, 64)
    assert calls["port"] == calls["jax"] == counts["K5"] == 2 * 4 + 2 + 2 * 2
    _compare(out, ref, 1e-4)


def test_kernel_launches_at_the_bench_geometry():
    """The counts chip_smoke.py holds the card to: the default widths (32,
    64, 128) on 12 frames of 128^2. K6: each encoder's level-0 convs and
    level 1's second (level 1's first reads a 128-wide input, level 2 is 128
    channels), the fuses of levels 0 and 1, the decoder's two convs at
    levels 1 and 0 each frame; K5 (instance + the switch): all 12 encoder
    convs, 3 fuses and 4 decoder convs a frame."""
    model = FinalFlow(FinalFlowConfig(), conv_impl="pallas")
    assert model.kernel_launches(12, 128) == {"K5": 0, "K6": 2 * 3 + 2 + 4 * 12}
    inst = FinalFlow(FinalFlowConfig(norm="instance"), conv_impl="pallas", fused_norm_act=True)
    assert inst.kernel_launches(12, 128) == {"K5": 12 + 3 + 4 * 12, "K6": 2 * 3 + 2 + 4 * 12}
    assert FinalFlow(FinalFlowConfig(), conv_impl="native").kernel_launches(12, 128) == {
        "K5": 0, "K6": 0}

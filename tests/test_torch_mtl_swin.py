"""The port's Swin blocks, MTL model, temporal video model and deformable
attention against the JAX package's, on the CPU, with the same parameters
(a flax tree drawn from a numpy seed, carried over by
``load_flax_params``); batched in the port where the JAX modules take one
image, map or video (``vmap``ped here). Then the reference Swin importers
(both bias-table layouts) against JAX's, and the kernel switches: under
``CSOF_CONV2D_IMPL=pallas`` the port calls K6 (its plain version here)
exactly where and as often as the JAX package calls its Pallas conv, and
with ``norm="instance"`` and ``CSOF_FUSED_NORM=1`` K5 where it calls its
Pallas InstanceNorm + LeakyReLU (interpret mode, as its own tests run
them); ``kernel_launches`` gives both.

Tolerances: the Swin block, stage and merging within 1e-5 of the output's
largest magnitude at float32 (the same sums in another order); the models
with attention bottlenecks within 1e-4 of it at float32 and 5e-2 at
bfloat16 (each rounding of a bf16 activation moves the next layer's input
by up to 2^-8 of it); one input without the batch axis against its row of a
batch of two within a tenth of those (the CPU's convolutions and norms sum
a batch of one in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_finalflow import _counting
from test_torch_raft import random_params

import csof_tpu.compat.torch_import as jimport
import csof_tpu.models.swin as jswin
import csof_tpu.ops.pallas.conv as jconv
import csof_tpu.ops.pallas.norm_act as jna
from csof_tpu.models.deformable import DeformableTransformerLayer as JaxDeformable
from csof_tpu.models.mtl import MTLConfig as JaxMTLConfig
from csof_tpu.models.mtl import MTLModel as JaxMTL
from csof_tpu.models.temporal import TemporalVideoSegModel as JaxTemporal
from csof_tpu_torch.compat import torch_import
from csof_tpu_torch.compat.flax_import import flax_to_torch_arrays, load_flax_params
from csof_tpu_torch.models import blocks, swin
from csof_tpu_torch.models.deformable import DeformableTransformerLayer
from csof_tpu_torch.models.mtl import MTLConfig, MTLModel, ModelWrap
from csof_tpu_torch.models.temporal import TemporalVideoSegModel

torch_threads.pin()

SWIN_TOL = 1e-5
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SMALL_MTL = dict(out_encoder_dims=(8, 16, 32), swin_heads=(2, 2, 2), window=4,
                 bottleneck_heads=2, dim_feedforward=32, reconstruction=True,
                 directional_field=True)
SMALL_TEMPORAL = dict(out_encoder_dims=(8, 16), d_model=16, num_heads=2, video_length=4)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * float(np.abs(ref).max()))


def _jax_batched(module, params, *xs):
    return jax.jit(jax.vmap(lambda *a: module.apply({"params": params}, *a)))(*xs)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_window_helpers_match_jax():
    x = _rand(0, 2, 8, 12, 3)
    wins = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins[1].numpy(), np.asarray(jswin.window_partition(x[1], 4)))
    back = swin.window_unpartition(wins, 4, 8, 12)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(swin.relative_position_index(4),
                                  jswin.relative_position_index(4))
    for h, w, win, shift in ((8, 8, 4, 2), (8, 12, 4, 2), (16, 8, 8, 4)):
        np.testing.assert_array_equal(swin.shifted_window_mask(h, w, win, shift).numpy(),
                                      np.asarray(jswin.shifted_window_mask(h, w, win, shift)))


@pytest.mark.parametrize("kind", ["block", "shifted block", "stage", "merging"])
def test_swin_modules_match_jax(kind):
    x = _rand(1, 2, 8, 8, 16)
    if kind == "merging":
        jm, tm = jswin.PatchMerging(24), swin.PatchMerging(16, 24)
    elif kind == "stage":
        jm, tm = jswin.SwinStage(16, 2, 2, 4), swin.SwinStage(16, 2, 2, 4)
    else:
        shift = 2 if kind == "shifted block" else 0
        jm, tm = jswin.SwinBlock(16, 2, 4, shift), swin.SwinBlock(16, 2, 4, shift)
    params = random_params(jm, jnp.asarray(x[0]), seed=2)
    load_flax_params(tm, params)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), _jax_batched(jm, params, x), SWIN_TOL)


def test_swin_block_bfloat16_matches_jax():
    """A bf16 map (as the Swin encoder's embedding gives it) stays bf16; the
    logits and softmax inside run in float32 in both."""
    x = jnp.asarray(_rand(3, 2, 8, 8, 16), jnp.bfloat16)
    jm = jswin.SwinBlock(16, 2, 4, 2, dtype=jnp.bfloat16)
    tm = swin.SwinBlock(16, 2, 4, 2, dtype=torch.bfloat16)
    params = random_params(jm, x[0], seed=4)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16))
    ref = _jax_batched(jm, params, x)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(got, ref, MODEL_TOL["bfloat16"])


def _mtl_pair(encoder, dtype, seed, hw=32, **kw):
    cfg_kw = dict(SMALL_MTL, encoder=encoder, dtype=dtype, **kw)
    jm = JaxMTL(JaxMTLConfig(**cfg_kw), num_classes=4)
    images = np.random.RandomState(seed).rand(2, hw, hw, 1).astype(np.float32)
    params = random_params(jm, jnp.asarray(images[0]), seed=seed)
    tm = MTLModel(MTLConfig(**cfg_kw), num_classes=4, input_hw=(hw, hw))
    load_flax_params(tm, params)
    return jm, tm, params, images


@pytest.mark.parametrize("encoder", ["conv", "swin"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mtl_model_matches_jax(encoder, dtype):
    """Both heads on; one image without the batch axis gives JAX's layout."""
    seed = 10 + 2 * (encoder == "swin") + (dtype == "bfloat16")
    jm, tm, params, images = _mtl_pair(encoder, dtype, seed)
    ref = _jax_batched(jm, params, images)
    with torch.no_grad():
        out = tm(torch.from_numpy(images))
        single = tm(torch.from_numpy(images[1]))
    assert set(out) == set(ref) == {"seg_logits", "reconstruction", "directional_field"}
    for k in ref:
        assert out[k].dtype == torch.float32, k
        _close(out[k], ref[k], MODEL_TOL[dtype])
        _close(single[k], out[k][1].numpy(), MODEL_TOL[dtype] / 10)  # batch 1 vs 2: the CPU's sums


def test_model_wrap_pairs_two_models():
    jm, tm, params, images = _mtl_pair("conv", "float32", 20)
    wrap = ModelWrap(tm, MTLModel(MTLConfig(**dict(SMALL_MTL, encoder="swin")), 4,
                                  input_hw=(32, 32)))
    with torch.no_grad():
        out = wrap(torch.from_numpy(images))
        alone = tm(torch.from_numpy(images))
    assert set(out) == {"model1", "model2"}
    assert torch.equal(out["model1"]["seg_logits"], alone["seg_logits"])


@pytest.mark.parametrize("t", [3, 6])
def test_temporal_model_matches_jax_below_and_above_the_bus_length(t):
    """video_length 4: three frames slice the bus, six pad it with zeros."""
    jm = JaxTemporal(**SMALL_TEMPORAL)
    videos = np.random.RandomState(t).rand(2, t, 32, 32, 1).astype(np.float32)
    params = random_params(jm, jnp.asarray(videos[0]), seed=t)
    tm = TemporalVideoSegModel(**SMALL_TEMPORAL)
    load_flax_params(tm, params)
    with torch.no_grad():
        out = tm(torch.from_numpy(videos))
        single = tm(torch.from_numpy(videos[0]))
    _close(out, _jax_batched(jm, params, videos), MODEL_TOL["float32"])
    _close(single, out[0].numpy(), 1e-5)  # batch 1 vs 2: the CPU kernels' sums


def test_temporal_model_bfloat16_matches_jax():
    kw = dict(SMALL_TEMPORAL, dtype=jnp.bfloat16)
    jm = JaxTemporal(**kw)
    videos = np.random.RandomState(7).rand(2, 5, 32, 32, 1).astype(np.float32)
    params = random_params(jm, jnp.asarray(videos[0]), seed=7)
    tm = TemporalVideoSegModel(**dict(kw, dtype=torch.bfloat16))
    load_flax_params(tm, params)
    with torch.no_grad():
        _close(tm(torch.from_numpy(videos)), _jax_batched(jm, params, videos),
               MODEL_TOL["bfloat16"])


@pytest.mark.parametrize("query_dim", [12, 16])
def test_deformable_layer_matches_jax(query_dim):
    """A query map 12 wide gets the projection Dense_0 (the FFN is then
    Dense_1 / Dense_2); offsets of a few pixels, some past the border."""
    jm = JaxDeformable(16, num_heads=2, num_points=3, dim_feedforward=32)
    q = _rand(query_dim, 2, 8, 8, query_dim)
    v = _rand(query_dim + 1, 2, 6, 10, 16)
    params = random_params(jm, jnp.asarray(q[0]), jnp.asarray(v[0]), seed=query_dim)
    params["DeformableAttention2D_0"]["offsets"]["bias"] *= 30.0
    tm = DeformableTransformerLayer(query_dim, 16, 16, num_heads=2, num_points=3,
                                    dim_feedforward=32)
    load_flax_params(tm, params)
    with torch.no_grad():
        out = tm(torch.from_numpy(q), torch.from_numpy(v))
        single = tm(torch.from_numpy(q[0]), torch.from_numpy(v[0]))
    _close(out, _jax_batched(jm, params, q, v), MODEL_TOL["float32"])
    _close(single, out[0].numpy(), 1e-5)  # batch 1 vs 2: the CPU kernels' sums


def _reference_attention(rng, dim, heads, window, layout):
    size = (2 * window - 1) ** 2
    sd = {"qkv.weight": rng.randn(3 * dim, dim) / np.sqrt(dim), "qkv.bias": 0.1 * rng.randn(3 * dim),
          "proj.weight": rng.randn(dim, dim) / np.sqrt(dim), "proj.bias": 0.1 * rng.randn(dim)}
    table = 0.5 * rng.randn(size, heads)
    if layout == "relative_position_bias_table":
        sd[layout] = table
    else:
        sd["rpe_table"] = table.T.copy()
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("layout", ["relative_position_bias_table", "rpe_table"])
def test_reference_swin_importers_match_jax(layout):
    """A reference-layout state dict from a seed, imported by both packages:
    the same parameters (the port's equal to JAX's carried over) and the
    same outputs, for WindowAttention and a whole SwinBlock."""
    rng = np.random.RandomState(5)
    attn_sd = _reference_attention(rng, 16, 2, 4, layout)
    windows = _rand(6, 3, 4, 16, 16)
    jm = jswin.WindowAttention(16, 2, 4)
    jparams = jimport.import_window_attention_weights(
        attn_sd, random_params(jm, jnp.asarray(windows[0]), seed=7))
    tm = swin.WindowAttention(16, 2, 4)
    tm.load_state_dict(torch_import.import_window_attention_weights(attn_sd, tm))
    want = flax_to_torch_arrays(tm, jparams)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
    with torch.no_grad():
        _close(tm(torch.from_numpy(windows)), _jax_batched(jm, jparams, windows), SWIN_TOL)

    block_sd = {f"attn.{k}": v for k, v in _reference_attention(rng, 16, 2, 4, layout).items()}
    for name, shape in (("norm1", (16,)), ("norm2", (16,)), ("mlp.fc1", (64, 16)),
                        ("mlp.fc2", (16, 64))):
        block_sd[f"{name}.weight"] = (1.0 * (len(shape) == 1) + rng.randn(*shape)
                                      / np.sqrt(shape[-1])).astype(np.float32)
        block_sd[f"{name}.bias"] = (0.1 * rng.randn(shape[0])).astype(np.float32)
    x = _rand(8, 2, 8, 8, 16)
    jb = jswin.SwinBlock(16, 2, 4, 2)
    jparams = jimport.import_swin_block_weights(block_sd,
                                                random_params(jb, jnp.asarray(x[0]), seed=9))
    tb = swin.SwinBlock(16, 2, 4, 2)
    tb.load_state_dict(torch_import.import_swin_block_weights(block_sd, tb))
    want = flax_to_torch_arrays(tb, jparams)
    for name, p in tb.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
    with torch.no_grad():
        _close(tb(torch.from_numpy(x)), _jax_batched(jb, jparams, x), SWIN_TOL)


def _count_both(monkeypatch, which):
    calls = {"jax": 0, "port": 0}
    if which == "K6":
        targets = ((jconv, "conv3x3_cols_vb", "jax"), (blocks, "conv3x3", "port"))
    else:
        targets = ((jna, "instance_norm_leaky_relu_pallas", "jax"),
                   (blocks, "instance_norm_leaky_relu", "port"))
    for mod, name, key in targets:
        monkeypatch.setattr(mod, name, _counting(calls, key, getattr(mod, name)))
    return calls


@pytest.mark.parametrize("which", ["K6", "K5"])
def test_kernel_switches_route_mtl_and_temporal_as_jax(which, monkeypatch):
    """64-wide inputs with dims (8, 16, 32): the encoder's stride-1 convs at
    64 and 32 wide and both decoders' convs run K6 (3 + 4 + 4 in MTL; the
    temporal encoder and its one decoder over all frames, 3 + 4); with
    instance norm and the switch every ConvNormAct runs K5."""
    if which == "K6":
        monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    else:
        monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    norm = "group" if which == "K6" else "instance"
    images = np.random.RandomState(30).rand(1, 64, 64, 1).astype(np.float32)
    jm = JaxMTL(JaxMTLConfig(**dict(SMALL_MTL, norm=norm)), num_classes=4)
    params = random_params(jm, jnp.asarray(images[0]), seed=30)
    tm = MTLModel(MTLConfig(**dict(SMALL_MTL, norm=norm)), 4, input_hw=(64, 64))
    load_flax_params(tm, params)
    calls = _count_both(monkeypatch, which)
    ref = _jax_batched(jm, params, images)
    with torch.no_grad():
        out = tm(torch.from_numpy(images))
    want = {"K6": 3 + 4 + 4, "K5": 6 + 4 + 4}[which]
    assert calls["jax"] == calls["port"] == tm.kernel_launches(64)[which] == want
    for k in ref:
        _close(out[k], ref[k], MODEL_TOL["float32"])

    kw = dict(SMALL_TEMPORAL, out_encoder_dims=(8, 16, 32), d_model=32, norm=norm)
    jt = JaxTemporal(**kw)
    videos = np.random.RandomState(31).rand(1, 3, 64, 64, 1).astype(np.float32)
    params = random_params(jt, jnp.asarray(videos[0]), seed=31)
    tt = TemporalVideoSegModel(**kw)
    load_flax_params(tt, params)
    calls = _count_both(monkeypatch, which)  # fresh counters over the first ones
    ref = _jax_batched(jt, params, videos)
    with torch.no_grad():
        out = tt(torch.from_numpy(videos))
    want = {"K6": 3 + 4, "K5": 6 + 4}[which]
    assert calls["jax"] == calls["port"] == tt.kernel_launches(64)[which] == want
    _close(out, ref, MODEL_TOL["float32"])


def test_kernel_launches_at_the_card_geometry():
    """The counts chip_smoke.py phase 33 holds the card to: MTLConfig()'s
    widths on 256 x 224 images (level widths 224, 112, 56: the encoder's
    stride-1 convs but level 2's 128-channel one, both decoders' four),
    the Swin encoder's decoders only; the temporal defaults on 128^2 frames
    (widths 128, 64, 32); with instance norm and the switch, K5 on every
    ConvNormAct."""
    heads = dict(reconstruction=True, directional_field=True)
    conv = MTLModel(MTLConfig(**heads), 4, conv_impl="pallas")
    assert conv.kernel_launches(224) == {"K5": 0, "K6": 3 + 4 + 4}
    sw = MTLModel(MTLConfig(encoder="swin", **heads), 4, conv_impl="pallas")
    assert sw.kernel_launches(224) == {"K5": 0, "K6": 4 + 4}
    inst = MTLModel(MTLConfig(norm="instance", **heads), 4, conv_impl="pallas",
                    fused_norm_act=True)
    assert inst.kernel_launches(224) == {"K5": 6 + 4 + 4, "K6": 3 + 4 + 4}
    assert MTLModel(MTLConfig(**heads), 4, conv_impl="native").kernel_launches(224) == {
        "K5": 0, "K6": 0}
    tv = TemporalVideoSegModel(conv_impl="pallas")
    assert tv.kernel_launches(128) == {"K5": 0, "K6": 4 + 4}
    ti = TemporalVideoSegModel(norm="instance", conv_impl="pallas", fused_norm_act=True)
    assert ti.kernel_launches(128) == {"K5": 6 + 4, "K6": 4 + 4}

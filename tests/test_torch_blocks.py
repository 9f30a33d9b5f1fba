"""Blocks, attention, GRU and warp of the PyTorch port against the flax
modules of the JAX package: the same parameters (crossed over through
load_flax_params) on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csof_tpu.models import attention as jattn
from csof_tpu.models import blocks as jblocks
from csof_tpu.models import convgru as jgru
from csof_tpu.models import segflow as jseg
from csof_tpu.ops.warp import warp_image_cm as jwarp
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.models import attention, blocks, convgru, segflow
from csof_tpu_torch.ops.warp import warp_image_cm

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bf16: the two frameworks round at other points inside fused elementwise ops
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)}


def _perturb(tree, seed):
    """Move every 1-D leaf (norm scale/bias, biases) off its init value so a
    swapped or dropped affine shows up."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, tree)


def _cross(flax_module, torch_module, *inputs, seed=0):
    """Init the flax module, perturb, load into the torch module; returns
    the flax variables."""
    variables = jax.jit(flax_module.init)(jax.random.PRNGKey(seed), *inputs)
    params = _perturb(jax.tree_util.tree_map(np.asarray, variables["params"]), seed)
    load_flax_params(torch_module, params)
    return {"params": params}


def _nhwc(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x_nhwc, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))).to(dtype)


def _close(got_nchw, ref_nhwc, dtype="float32", tol=None):
    atol, rtol = tol or TOL[dtype]
    np.testing.assert_allclose(got_nchw.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_nhwc, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [16, 12])
def test_group_norm(channels, dtype):
    jd, td = DT[dtype]
    x = _nhwc(0, 2, 6, 5, channels) * 3 + 1
    mod = blocks.GroupNorm(channels)
    v = _cross(jblocks.GroupNorm(), mod, jnp.asarray(x, jd))
    with torch.no_grad():
        got = mod(_t(x, td))
    assert got.dtype == td
    _close(got, jblocks.GroupNorm().apply(v, jnp.asarray(x, jd)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm(dtype):
    jd, td = DT[dtype]
    x = _nhwc(1, 2, 6, 5, 8) * 2 - 1
    mod = blocks.InstanceNorm(8)
    v = _cross(jblocks.InstanceNorm(), mod, jnp.asarray(x, jd))
    with torch.no_grad():
        got = mod(_t(x, td))
    _close(got, jblocks.InstanceNorm().apply(v, jnp.asarray(x, jd)), dtype)


@pytest.mark.parametrize("stride,norm,dtype", [
    (1, "group", "float32"), (2, "group", "float32"), (1, "instance", "float32"),
    (2, "batch", "bfloat16"),
])
def test_conv_norm_act(stride, norm, dtype):
    jd, td = DT[dtype]
    x = _nhwc(2, 2, 9, 10, 6)
    fm = jblocks.ConvNormAct(16, (3, 3), strides=(stride, stride), norm=norm, dtype=jd)
    mod = blocks.ConvNormAct(6, 16, stride, norm, td)
    v = _cross(fm, mod, jnp.asarray(x))
    with torch.no_grad():
        got = mod(_t(x))
    assert got.dtype == td
    _close(got, fm.apply(v, jnp.asarray(x)), dtype)


def test_conv_transpose_mirrored_kernel():
    x = _nhwc(3, 2, 5, 4, 6)
    fm = jblocks.ConvTranspose(8, (2, 2), (2, 2))
    mod = blocks.ConvTranspose(6, 8)
    v = _cross(fm, mod, jnp.asarray(x))
    with torch.no_grad():
        got = mod(_t(x))
    _close(got, fm.apply(v, jnp.asarray(x)))


def test_encoder_and_decoder():
    x = _nhwc(4, 2, 16, 16, 1)
    dims = (8, 16, 16)
    fenc = jseg.Encoder(dims, "group")
    enc = segflow.Encoder(1, dims, "group")
    venc = _cross(fenc, enc, jnp.asarray(x))
    ref_skips = jax.jit(fenc.apply)(venc, jnp.asarray(x))
    with torch.no_grad():
        skips = enc(_t(x))
    for got, ref in zip(skips, ref_skips):
        _close(got, ref)

    fdec = jseg.Decoder(dims, 4, "group", head_init_scale=1e5)
    dec = segflow.Decoder(16, dims, 4, "group", head_init_scale=1e5)
    ref_in = [jnp.asarray(np.asarray(s)) for s in ref_skips]
    vdec = _cross(fdec, dec, ref_in[-1], ref_in)
    ref_head, ref_x = jax.jit(fdec.apply)(vdec, ref_in[-1], ref_in)
    with torch.no_grad():
        head, feat = dec(skips[-1], skips)
    assert head.dtype == torch.float32
    _close(head, ref_head, tol=(1e-4, 1e-4))
    _close(feat, ref_x)


@pytest.mark.parametrize("dtype,widths", [
    ("float32", (16, 16, 16)), ("float32", (12, 16, 8)), ("bfloat16", (16, 16, 16)),
])
def test_cross_attention(dtype, widths):
    jd, td = DT[dtype]
    maps = [_nhwc(5 + i, 2, 4, 6, c) for i, c in enumerate(widths)]
    fm = jattn.CrossAttentionLayer(16, 2, 32, jd)
    mod = attention.CrossAttentionLayer(16, 2, 32, td, widths=widths)
    one = [jnp.asarray(m[0]) for m in maps]
    v = _cross(fm, mod, *one)
    ref = jax.vmap(lambda a, b, c: fm.apply(v, a, b, c))(*[jnp.asarray(m) for m in maps])
    with torch.no_grad():
        got, amap = mod(*[_t(m) for m in maps], return_attn_map=True)
    _close(got, ref, dtype, tol=(5e-2, 5e-2) if dtype == "bfloat16" else None)
    _, inter = fm.apply(v, *one, mutable=["intermediates"])
    np.testing.assert_allclose(amap[0].numpy(), np.asarray(inter["intermediates"]
                               ["attn_weights"][0]), atol=2e-3 if dtype == "bfloat16" else 1e-6)


def test_sine_pos_embed():
    np.testing.assert_allclose(attention.sine_pos_embed_2d(5, 7, 16).numpy(),
                               np.asarray(jattn.sine_pos_embed_2d(5, 7, 16)), atol=1e-6)


def test_conv_gru_cell():
    h, x = _nhwc(8, 2, 6, 6, 16), _nhwc(9, 2, 6, 6, 16)
    fm = jgru.ConvGRUCell(16)
    mod = convgru.ConvGRUCell(16, 16)
    v = _cross(fm, mod, jnp.asarray(h), jnp.asarray(x))
    with torch.no_grad():
        got = mod(_t(h), _t(x))
    _close(got, fm.apply(v, jnp.asarray(h), jnp.asarray(x)))


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("hw", [(12, 10), (32, 36)])  # JAX gather path, then its MXU path
def test_warp_image_cm(padding, hw):
    rng = np.random.RandomState(10)
    img = rng.rand(2, *hw, 1).astype(np.float32)
    flow = (rng.randn(2, 2, *hw) * 4).astype(np.float32)
    ref = jax.vmap(lambda i, f: jwarp(i, f, padding=padding))(jnp.asarray(img), jnp.asarray(flow))
    got = warp_image_cm(_t(img), torch.from_numpy(flow), padding=padding)
    _close(got, ref, tol=(2e-5, 2e-5))

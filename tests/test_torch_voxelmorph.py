"""The port's VoxelMorph against the JAX package's, on the CPU: the
channels-last warps (2D and 3D, border and zeros padding, the NaN rule),
scaling-and-squaring integration, the model in 2D and 3D with and without
``diffeomorphic`` (parameters carried across by the converter), in bfloat16,
and ``register_sequence``.

Tolerances: float32 within 2e-5 (the same bilinear sums in another order,
seven self-compositions deep for the integration) and 1e-4 of the largest
output for the models; bfloat16 within 5e-2 of it (each conv rounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_raft import random_params

from csof_tpu.config.experiment import VoxelMorphModelConfig as JaxVxmConfig
from csof_tpu.models.voxelmorph import VoxelMorph as JaxVoxelMorph
from csof_tpu.models.voxelmorph import register_sequence as jax_register_sequence
from csof_tpu.ops import integrate as jint
from csof_tpu.ops import warp as jwarp
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config.experiment import VoxelMorphModelConfig
from csof_tpu_torch.models.voxelmorph import VoxelMorph, register_sequence
from csof_tpu_torch.ops import integrate, warp

torch_threads.pin()

SMALL = dict(enc_features=(4, 8, 8), dec_features=(8, 8, 8, 4))
OPS_TOL = 2e-5


def _field(rng, shape, scale):
    return (scale * rng.randn(*shape)).astype(np.float32)


_jax_warp_batch = jax.jit(jwarp.warp_batch, static_argnames=("mode", "padding"))


@pytest.mark.parametrize("spatial", [(17, 23), (5, 9, 11)])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp_batch_and_image_match_jax(spatial, padding):
    """Flows that reach past every edge (up to 4 pixels)."""
    rng = np.random.RandomState(len(spatial) + (padding == "zeros"))
    nd = len(spatial)
    img = rng.rand(2, *spatial, 3).astype(np.float32)
    flow = _field(rng, (2, *spatial, nd), 2.0)
    got = warp.warp_batch(torch.from_numpy(img), torch.from_numpy(flow), padding=padding)
    ref = np.asarray(_jax_warp_batch(jnp.asarray(img), jnp.asarray(flow), padding=padding))
    np.testing.assert_allclose(got.numpy(), ref, atol=OPS_TOL, rtol=OPS_TOL)
    one = warp.warp_image(torch.from_numpy(img[1]), torch.from_numpy(flow[1]), padding=padding)
    np.testing.assert_allclose(one.numpy(), ref[1], atol=OPS_TOL, rtol=OPS_TOL)


def test_warp_batch_keeps_nan_where_the_flow_is_nan():
    flow = np.zeros((1, 6, 7, 2), np.float32)
    flow[0, 2, 3, 1] = np.nan
    img = np.random.RandomState(0).rand(1, 6, 7, 1).astype(np.float32)
    for padding in ("border", "zeros"):
        got = warp.warp_batch(torch.from_numpy(img), torch.from_numpy(flow), padding=padding)
        ref = np.asarray(_jax_warp_batch(jnp.asarray(img), jnp.asarray(flow), padding=padding))
        assert np.isnan(got[0, 2, 3, 0].item()) and np.isnan(ref[0, 2, 3, 0])
        mask = ~np.isnan(ref)
        np.testing.assert_allclose(got.numpy()[mask], ref[mask], atol=1e-6)


@pytest.mark.parametrize("spatial", [(20, 24), (6, 10, 12)])
def test_vecint_matches_jax(spatial):
    rng = np.random.RandomState(7)
    v = _field(rng, (2, *spatial, len(spatial)), 3.0)
    got = integrate.vecint_batch(torch.from_numpy(v), 7)
    ref = np.asarray(jint.vecint_batch(jnp.asarray(v), 7))
    np.testing.assert_allclose(got.numpy(), ref, atol=OPS_TOL, rtol=OPS_TOL)
    np.testing.assert_allclose(integrate.vecint(torch.from_numpy(v[0]), 7).numpy(), ref[0],
                               atol=OPS_TOL, rtol=OPS_TOL)


def _pair(rng, shape):
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


def _check(model_kw, shape, dtype="float32", seed=0, tol=1e-4):
    rng = np.random.RandomState(seed)
    moving, fixed = _pair(rng, shape)
    jm = JaxVoxelMorph(JaxVxmConfig(**SMALL, **model_kw, dtype=dtype))
    params = random_params(jm, jnp.asarray(moving), jnp.asarray(fixed), seed=seed)
    ref = jax.jit(jm.apply)({"params": params}, moving, fixed)
    model = VoxelMorph(VoxelMorphModelConfig(**SMALL, **model_kw, dtype=dtype), shape[-1],
                       len(shape) - 2)
    load_flax_params(model, params)
    out = model(torch.from_numpy(moving), torch.from_numpy(fixed))
    assert sorted(out) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert out[k].shape == r.shape, k
        np.testing.assert_allclose(out[k].detach().float().numpy(), r,
                                   atol=tol * float(np.abs(r).max()), rtol=0, err_msg=k)
    return model, params


@pytest.mark.parametrize("diffeomorphic", [True, False])
def test_voxelmorph_2d_matches_jax(diffeomorphic):
    _check(dict(diffeomorphic=diffeomorphic, int_steps=7), (3, 32, 40, 1))


def test_voxelmorph_3d_matches_jax():
    _check(dict(diffeomorphic=True, int_steps=5), (2, 8, 16, 24, 1), seed=1)


def test_voxelmorph_bfloat16_matches_jax():
    """The UNet in bf16 (LeakyReLU's slope rounded to bf16, as JAX rounds
    it), the flow head and the integration in float32."""
    _check(dict(diffeomorphic=True, int_steps=7), (2, 32, 40, 1), dtype="bfloat16", seed=2,
           tol=5e-2)


def test_register_sequence_matches_jax():
    rng = np.random.RandomState(3)
    frames = rng.rand(5, 24, 32, 1).astype(np.float32)
    cfg = dict(**SMALL, diffeomorphic=True, int_steps=4, dtype="float32")
    jm = JaxVoxelMorph(JaxVxmConfig(**cfg))
    params = random_params(jm, jnp.asarray(frames[1:]), jnp.asarray(frames[1:]), seed=3)
    ref = jax.jit(lambda p, f: jax_register_sequence(jm, p, f))({"params": params}, frames)
    model = VoxelMorph(VoxelMorphModelConfig(**cfg))
    load_flax_params(model, params)
    out = register_sequence(model, torch.from_numpy(frames))
    assert out["flow"].shape == (4, 24, 32, 2)
    for k in ("flow", "registered", "flow_inverse"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].detach().numpy(), r,
                                   atol=1e-4 * float(np.abs(r).max()), rtol=0, err_msg=k)

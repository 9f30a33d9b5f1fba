"""K1 (correlation) and K3 (skip fuse) of the PyTorch port.

On the CPU the plain PyTorch versions are held against the JAX package's
Pallas kernels, run in interpret mode, on the same numpy inputs. The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``python3 chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csof_tpu.ops.pallas.corr import local_correlation_volume_pallas_batched
from csof_tpu.ops.pallas.skipfuse import fused_skip_fuse_batched
from csof_tpu_torch.ops import correlation
from csof_tpu_torch.ops.kernels import corr as k1
from csof_tpu_torch.ops.kernels import skipfuse as k3

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(seed, b, c, h, w, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, c, h, w).astype(np.float32)
    m = rng.randn(b, c, h, w).astype(np.float32)
    jd, td = DTYPES[dtype]
    return (jnp.asarray(q, jd), jnp.asarray(m, jd),
            torch.from_numpy(q).to(td), torch.from_numpy(m).to(td))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


# bf16: both sides round the same f32 sum (taken in another order) -> 1 ulp
CORR_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius,stride,hw", [
    (2, 1, (16, 16)), (2, 2, (16, 16)), (1, 1, (16, 16)), (4, 2, (16, 16)), (2, 1, (12, 20)),
])
def test_corr_plain_matches_pallas(radius, stride, hw, dtype):
    qj, mj, qt, mt = _pair(0, 2, 8, *hw, dtype)
    ref = local_correlation_volume_pallas_batched(
        qj, mj, radius, stride, interpret=True, query_cm=True, out_cm=True, memory_cm=True)
    got = k1.corr_plain(qt, mt, radius, stride)
    assert got.dtype == qt.dtype and got.shape == (2, (2 * radius + 1) ** 2, *hw)
    atol, rtol = CORR_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=rtol)


def _skip_params(seed, c, f, k2):
    rng = np.random.RandomState(seed)
    cin = 2 * c + k2
    w = (rng.randn(3, 3, cin, f) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b, gs, gb = (0.1 * rng.randn(f)).astype(np.float32), \
        (1 + 0.1 * rng.randn(f)).astype(np.float32), (0.1 * rng.randn(f)).astype(np.float32)
    torch_args = (torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
                  torch.from_numpy(gs), torch.from_numpy(gb))
    return (w, b, gs, gb), torch_args


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("radius,stride,hw", [(2, 1, (16, 16)), (2, 2, (12, 20))])
def test_skip_fuse_plain_matches_pallas(radius, stride, hw, dtype, atol):
    c = f = 8
    qj, mj, qt, mt = _pair(1, 2, c, *hw, dtype)
    jargs, targs = _skip_params(2, c, f, (2 * radius + 1) ** 2)
    ref = fused_skip_fuse_batched(qj, mj, *[jnp.asarray(a) for a in jargs], radius=radius,
                                  stride=stride, interpret=True)  # (B, H, W, F)
    got = k3.skip_fuse_plain(qt, mt, *targs, radius, stride)  # (B, F, H, W)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), _np(ref), atol=atol,
                               rtol=atol)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    k1.launches = k3.launches = 0
    _, _, q, m = _pair(3, 1, 8, 12, 12, "float32")
    _, (w, b, gs, gb) = _skip_params(4, 8, 8, 25)
    with torch.no_grad():
        assert torch.equal(correlation.local_correlation_volume(q, m, 2, 1),
                           k1.corr_plain(q, m, 2, 1))
        assert torch.equal(k3.fused_skip_fuse(q, m, w, b, gs, gb, 2, 1),
                           k3.skip_fuse_plain(q, m, w, b, gs, gb, 2, 1))
    assert k1.launches == 0 and k3.launches == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    _, _, q, m = _pair(5, 1, 8, 8, 8, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        k1.corr_cuda(q, m, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        k3.skip_fuse_cuda(q, m, torch.zeros(8, 41, 3, 3), *[torch.zeros(8)] * 3, 2, 1)


def test_gradient_request_raises_clearly():
    _, _, q, m = _pair(6, 1, 8, 8, 8, "float32")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        correlation.local_correlation_volume(q, m, 2, 1)
    _, (w, b, gs, gb) = _skip_params(7, 8, 8, 25)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        k3.fused_skip_fuse(q.detach(), m, w, b, gs, gb, 2, 1)


def test_groups_are_lowered_until_they_divide():
    assert [k3.num_groups_for(f) for f in (4, 8, 12, 20, 128)] == [4, 8, 6, 5, 8]

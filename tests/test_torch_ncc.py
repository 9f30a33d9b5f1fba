"""K4, the windowed NCC map, on the CPU: the port's plain version against the
JAX package's Pallas kernel in interpret mode and against the port's own
``ncc_loss`` map; ``ncc_loss_kernel`` against ``ncc_loss_pallas``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads

from csof_tpu.ops.pallas.ncc import ncc_loss_pallas, ncc_map_pallas
from csof_tpu_torch.ops import losses as L
from csof_tpu_torch.ops.kernels import ncc as k4

torch_threads.pin()

# the same float32 operations in the same order as the Pallas kernel's: a
# few ulps of the cc map (XLA may reassociate the closing arithmetic)
PALLAS_ATOL = 1e-5
# the port's ncc_loss takes its box sums in another order (average pooling);
# cc lies in [0, ~1], so the tolerance is absolute: near-constant windows
# cancel in var = S_II - 2 mu S_I + mu^2 win
LOSS_MAP_ATOL = 1e-4


def _planes(n, h, w, seed=0):
    """Images in [0, 1] with a constant region (var 0 up to rounding) and
    a target that is a noisy copy of the prediction."""
    rng = np.random.RandomState(seed)
    i = rng.rand(n, h, w).astype(np.float32)
    i[:, : h // 3, : w // 3] = 0.4
    j = (0.7 * i + 0.3 * rng.rand(n, h, w)).astype(np.float32)
    j[0, -(h // 3):, -(w // 3):] = 0.9
    return i, j


#: window 9 and odd windows, even windows (offsets -w/2 ... w/2 - 1), windows
#: above 15, and windows wider than the plane
@pytest.mark.parametrize("n,h,w,window", [(3, 24, 24, 9), (2, 17, 40, 9), (1, 33, 19, 5),
                                          (2, 12, 11, 15), (2, 16, 20, 4), (1, 19, 23, 8),
                                          (1, 20, 36, 17), (1, 40, 45, 31), (1, 9, 7, 21),
                                          (1, 30, 90, 77)])
def test_ncc_map_plain_matches_the_pallas_kernel(n, h, w, window):
    i, j = _planes(n, h, w)
    ref = jax.vmap(lambda a, b: ncc_map_pallas(a, b, window, interpret=True))(
        jnp.asarray(i), jnp.asarray(j))
    got = k4.ncc_map_plain(torch.from_numpy(i), torch.from_numpy(j), window)
    assert got.shape == (n, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PALLAS_ATOL, rtol=0)
    # and the wrapper runs the plain version on CPU tensors, counting nothing
    k4.launches = 0
    np.testing.assert_array_equal(k4.ncc_map(torch.from_numpy(i), torch.from_numpy(j),
                                             window).numpy(), got.numpy())
    assert k4.launches == 0


@pytest.mark.parametrize("n,h,w", [(4, 32, 32), (2, 21, 37)])
def test_ncc_map_plain_matches_the_ported_ncc_loss_map(n, h, w):
    i, j = _planes(n, h, w, seed=1)
    got = k4.ncc_map_plain(torch.from_numpy(i), torch.from_numpy(j))
    loss_map = L.ncc_loss(torch.from_numpy(i)[..., None], torch.from_numpy(j)[..., None],
                          clip=None, reduction="none")[..., 0]
    np.testing.assert_allclose(got.numpy(), (1.0 - loss_map).numpy(), atol=LOSS_MAP_ATOL, rtol=0)
    assert float(got.max()) > 0.5  # the noisy copy correlates


def test_ncc_loss_kernel_matches_ncc_loss_pallas_and_ncc_loss():
    rng = np.random.RandomState(2)
    a = rng.rand(2, 24, 20, 2).astype(np.float32)
    b = (0.5 * a + 0.5 * rng.rand(2, 24, 20, 2)).astype(np.float32)
    ref = float(ncc_loss_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = k4.ncc_loss_kernel(torch.from_numpy(a), torch.from_numpy(b))
    assert got.item() == pytest.approx(ref, abs=1e-6)
    same = k4.ncc_loss_kernel(torch.from_numpy(a), torch.from_numpy(a))
    assert same.item() == pytest.approx(L.ncc_loss(torch.from_numpy(a), torch.from_numpy(a))
                                        .item(), abs=1e-5)


@pytest.mark.parametrize("c,dtype", [(3, np.float32), (1, "bfloat16"), (3, "bfloat16")])
def test_ncc_loss_kernel_matches_ncc_loss_pallas_over_channels_and_bf16(c, dtype):
    """Channels-last batches with C = 3 (each channel its own plane) and bf16
    inputs (widened to float32 as the Pallas kernel casts them)."""
    rng = np.random.RandomState(4 + c)
    a = rng.rand(2, 20, 18, c).astype(np.float32)
    a[:, :6, :6] = 0.4
    b = (0.6 * a + 0.4 * rng.rand(2, 20, 18, c)).astype(np.float32)
    if dtype == "bfloat16":
        ta, tb = (torch.from_numpy(x).bfloat16() for x in (a, b))
        ja, jb = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (ta, tb))
    else:
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref = float(ncc_loss_pallas(ja, jb, interpret=True))
    got = k4.ncc_loss_kernel(ta, tb)
    assert got.dtype == torch.float32 and got.item() == pytest.approx(ref, abs=1e-6)


def test_ncc_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 8)
    with pytest.raises(TypeError):
        k4.ncc_map_cuda(x, x)  # a CPU tensor
    with pytest.raises(ValueError, match="unsupported device"):
        k4.ncc_map(x.to("meta"), x.to("meta"))
    with pytest.raises(TypeError):
        k4.ncc_loss_cuda(x[..., None], x[..., None])  # a CPU tensor
    with pytest.raises(ValueError, match="unsupported device"):
        k4.ncc_loss_kernel(x[..., None].to("meta"), x[..., None].to("meta"))
    with pytest.raises(ValueError, match="window must be at least 1"):
        k4.ncc_plan(1, 8, 8, 0, 4)

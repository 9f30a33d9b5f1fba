"""K3's conv pass on the tensor cores, the parts a CPU can check: its weight
in K6's packed order (``conv.pack_weight``), the channel map of the concat
[q, m, corr] that the conv reads from three tensors, the GroupNorm partials
of its tiles, and the numerics of its float32 route (3xTF32 with a fresh
accumulator a chunk) over a concat whose chunks straddle q, m and corr.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_threads

from csof_tpu_torch.ops.kernels import conv as k6
from csof_tpu_torch.ops.kernels import skipfuse as k3
from csof_tpu_torch.ops.kernels.corr import corr_plain

torch_threads.pin()

#: K3's float32 tolerance against its plain version on the card (atol, rtol)
F32_TOL = (1e-4, 1e-4)
K2 = 81  # (2r + 1)^2 at radius 4


def _unpack(packed: torch.Tensor, f: int, cin: int, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``pack_weight``: (F, Cin, 3, 3) float32 (hi + lo for
    float32), checking that the padding is zero."""
    v = packed.float()
    if dtype == torch.float32:
        v = v[:, :, 0] + v[:, :, 1]
    nbk, nch, taps, groups, nb, epc = v.shape
    full = v.permute(0, 4, 1, 3, 5, 2).reshape(nbk * nb, nch * groups * epc, 3, 3)
    assert not full[f:].any() and not full[:, cin:].any()
    return full[:f, :cin]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,f", [(12, 12), (32, 32), (64, 64), (128, 128), (7, 130)])
def test_k3_packed_weight_unpacks_to_the_weight_exactly(c, f, dtype):
    """K3's weight (F, 2C + 81, 3, 3) in K6's packed order, as the wrapper
    packs it: the block width follows F (two blocks at F = 130), the channel
    chunks run over [q, m, corr] with C = 7 and 12 not a multiple of them,
    and unpacking gives the weight exactly."""
    cin = 2 * c + K2
    w = torch.from_numpy(np.random.RandomState(c + f).randn(f, cin, 3, 3).astype(np.float32))
    packed, nb = k6.pack_weight(w, dtype)
    assert nb == k6.block_n(f) and packed.shape[0] == -(-f // nb)
    assert torch.equal(_unpack(packed, f, cin, dtype), w.to(dtype).float())


def _channel(q, m, corr, c):
    """skipfuse.cu ConcatSource::channel: plane c of [q, m, corr]."""
    cq = q.shape[1]
    return q[:, c] if c < cq else m[:, c - cq] if c < 2 * cq else corr[:, c - 2 * cq]


def _tf32_rna(a):
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    return (a.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _conv64(x, w):
    return F.conv2d(torch.from_numpy(x.astype(np.float64)),
                    torch.from_numpy(w.astype(np.float64)), padding=1).numpy()


def _gn_act(y, gw, gb, groups, eps=1e-5):
    """GroupNorm (group mean as the mean of channel means) + LeakyReLU 0.01."""
    b, f = y.shape[:2]
    mean_c, m2_c = y.mean((2, 3)), (y * y).mean((2, 3))
    mean = np.repeat(mean_c.reshape(b, groups, -1).mean(-1), f // groups, 1)
    m2 = np.repeat(m2_c.reshape(b, groups, -1).mean(-1), f // groups, 1)
    a = gw / np.sqrt(np.maximum(m2 - mean * mean, 0) + eps)
    o = y * a[:, :, None, None] + (gb - mean * a)[:, :, None, None]
    return np.where(o >= 0, o, 0.01 * o)


def _inputs(c, f, seed, h=12, w=10, b=2):
    rng = np.random.RandomState(seed)
    q, m = (rng.randn(b, c, h, w).astype(np.float32) for _ in range(2))
    corr = corr_plain(torch.from_numpy(q), torch.from_numpy(m), 4, 1).numpy()
    cin = 2 * c + K2
    wt = (rng.randn(f, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    bias, gw, gb = (0.1 * rng.randn(f)).astype(np.float32), \
        (1 + 0.1 * rng.randn(f)).astype(np.float32), (0.1 * rng.randn(f)).astype(np.float32)
    return q, m, corr, wt, bias, gw, gb


def _k3_f32_emulated(q, m, corr, wt, bias, gw, gb, groups, three=True):
    """K3's float32 conv route: the concat read channel by channel through the
    source map, in chunks of 8 channels (32 bytes); x split on the card (hi
    rounded to nearest, lo read as tf32), w split by the packing; each
    chunk's three products (or one TF32 product) summed in float64 and
    rounded to float32 (a fresh accumulator), then added into the running
    float32 sum; + bias, GroupNorm, LeakyReLU in float64."""
    f, cin = wt.shape[:2]
    packed, _ = k6.pack_weight(torch.from_numpy(wt), torch.float32)
    packed[:, :, 1] = 0  # the hi part alone
    w_hi = _unpack(packed, f, cin, torch.float32).numpy()
    w_lo = _tf32_trunc(wt - w_hi)
    acc = np.zeros((q.shape[0], wt.shape[0], *q.shape[2:]), np.float32)
    for c0 in range(0, cin, 8):
        x = np.stack([_channel(q, m, corr, c) for c in range(c0, min(c0 + 8, cin))], 1)
        x_hi = _tf32_rna(x)
        sl = slice(c0, c0 + x.shape[1])
        if three:
            part = (_conv64(_tf32_trunc(x - x_hi), w_hi[:, sl]) + _conv64(x_hi, w_lo[:, sl])
                    + _conv64(x_hi, w_hi[:, sl]))
        else:
            part = _conv64(x_hi, _tf32_rna(wt[:, sl]))
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return _gn_act(acc.astype(np.float64) + bias[None, :, None, None], gw, gb, groups)


def _k3_ref(q, m, corr, wt, bias, gw, gb, groups):
    x = np.concatenate([q, m, corr], 1)
    return _gn_act(_conv64(x, wt) + bias[None, :, None, None], gw, gb, groups)


@pytest.mark.parametrize("c,f", [(12, 12), (20, 40), (32, 32)])
def test_three_tf32_products_a_chunk_reach_k3_float32_tolerance(c, f):
    """C = 12 and 20: the 8-channel chunks straddle q | m (chunk 1) and
    m | corr; against the float64 chain, inside a tenth of the tolerance."""
    args = _inputs(c, f, seed=c + f)
    groups = k3.num_groups_for(f)
    got = _k3_f32_emulated(*args, groups)
    ref = _k3_ref(*args, groups)
    err = np.abs(got - ref)
    assert (err <= 0.1 * (F32_TOL[0] + F32_TOL[1] * np.abs(ref))).all(), float(err.max())


@pytest.mark.parametrize("c,f", [(12, 12), (32, 32)])
def test_a_single_tf32_pass_misses_k3_float32_tolerance(c, f):
    """The negative control: one TF32 product per tap falls outside it."""
    args = _inputs(c, f, seed=3 * c + f)
    groups = k3.num_groups_for(f)
    got = _k3_f32_emulated(*args, groups, three=False)
    assert not np.allclose(got, _k3_ref(*args, groups), atol=F32_TOL[0], rtol=F32_TOL[1])


@pytest.mark.parametrize("h,w,rows", [(17, 70, 2), (17, 70, 4), (128, 128, 4), (32, 32, 2),
                                      (3, 5, 4), (64, 129, 2)])
def test_groupnorm_partials_of_the_conv_tiles(h, w, rows):
    """The conv pass's tiles (64 columns x 2 or 4 rows) fit the partials
    buffer the wrapper allocates, and summing each tile's (sum y, sum y^2)
    over the valid pixels of its rows gives the channel statistics."""
    tiles_w, tiles = -(-w // 64), -(-h // rows) * -(-w // 64)
    assert tiles <= k3.partial_tiles(h, w)
    y = np.random.RandomState(h * w).randn(3, h, w).astype(np.float32)
    s1 = np.zeros(3, np.float32)
    s2 = np.zeros(3, np.float32)
    for t in range(tiles):
        y0, x0 = (t // tiles_w) * rows, (t % tiles_w) * 64
        blk = y[:, y0:y0 + rows, x0:x0 + 64]
        s1 += blk.sum((1, 2))
        s2 += (blk * blk).sum((1, 2))
    np.testing.assert_allclose(s1, y.sum((1, 2)), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s2, (y * y).sum((1, 2)), rtol=1e-5)

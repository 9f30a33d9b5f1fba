"""K2's tiling and K5's plans, on the CPU.

K2 (csrc/corr_bwd.cu) and K5 (csrc/norm_act.cu) run only on the card, so
what surrounds their arithmetic is held here: a torch emulation of K2's
tiles (window-row staging with the r*s halo, the g rows that dq and dm
share, the kernel's shared-memory indices) against ``corr_bwd_plain``;
``norm_act_plan`` at every shape of the paths; and an emulation of K5's
fixed-order reduction (threads, warp butterfly, warps, cluster ranks)
against ``norm_act_plain`` at K5's float32 tolerance.
"""

import numpy as np
import pytest
import torch

from csof_tpu_torch.bounds import UNET_BATCH, UNET_K5_SHAPES
from csof_tpu_torch.ops.kernels import corr as k1
from csof_tpu_torch.ops.kernels import norm_act as k5

# the kernels' tolerances (tests/test_torch_cuda.py): K2 the same float32
# sums in another order, bf16 one ulp; K5 float32 statistics in another order
CORR_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
NORM_TOL_F32 = (2e-5, 2e-5)
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory, 1 KB of it reserved a block


def _window(t, rows, cols):
    """t[:, :, rows][:, :, :, cols], zero where a row or column falls outside
    the image (the kernel's zero-filled copies)."""
    h, w = t.shape[2:]
    out = t[:, :, rows.clamp(0, h - 1)][:, :, :, cols.clamp(0, w - 1)]
    ok = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[None, :]
    return out * ok.to(out.dtype)


def emulate_corr_bwd(q, m, g, radius, stride, mirror=False):
    """K2 as the kernel tiles it, in float32: per 32 x TH tile and window
    row j, the q rows dy above and the m rows dy below the tile and the 2r+1
    g planes of row j (rows y0 - max(dy, 0) .. + TH + |dy|), all with the
    halo columns [x0 - a, x0 + 32 + a); dq reads g at the tile's rows and
    slides along m, dm reads g dy rows up, shifted by (r - i) * s, and
    slides along q, both with the kernel's shared-memory column indices.
    ``mirror`` flips dm's shift (the error a sign slip would make)."""
    geo = k1.corr_bwd_geometry(q.dtype, radius, stride)
    th, a, cols, grows = geo["rows"], geo["a"], geo["cols"], geo["grows"]
    r, s, k = radius, stride, 2 * radius + 1
    b, c, h, w = q.shape
    qf, mf, gf = q.float(), m.float(), g.to(q.dtype).float()
    dq = torch.zeros(b, c, h, w)
    dm = torch.zeros(b, c, h, w)
    px, ty = torch.arange(32), torch.arange(th)
    for y0 in range(0, h, th):
        for x0 in range(0, w, 32):
            xs = x0 - a + torch.arange(cols)
            acc_q = torch.zeros(b, c, th, 32)
            acc_m = torch.zeros(b, c, th, 32)
            for j in range(k):
                dy = (j - r) * s
                sq = _window(qf, y0 - dy + ty, xs)
                sm = _window(mf, y0 + dy + ty, xs)
                ng = th + abs(dy)
                assert ng <= grows
                sg = _window(gf[:, j * k:(j + 1) * k], y0 - max(dy, 0) + torch.arange(ng), xs)
                for i in range(k):
                    g_dq = sg[:, i, max(dy, 0):max(dy, 0) + th][:, :, a + px]
                    shift = (i - r) * s if mirror else (r - i) * s
                    g_dm = sg[:, i, max(-dy, 0):max(-dy, 0) + th][:, :, a + px + shift]
                    o_dm = (i if mirror else k - 1 - i) * s
                    acc_q += g_dq[:, None] * sm[..., a - r * s + px + i * s]
                    acc_m += g_dm[:, None] * sq[..., a - r * s + px + o_dm]
            hh, ww = min(th, h - y0), min(32, w - x0)
            dq[:, :, y0:y0 + hh, x0:x0 + ww] = acc_q[:, :, :hh, :ww]
            dm[:, :, y0:y0 + hh, x0:x0 + ww] = acc_m[:, :, :hh, :ww]
    scale = 1.0 / np.sqrt(c)
    return (dq * scale).to(q.dtype), (dm * scale).to(q.dtype)


def _bwd_case(b, c, h, w, radius, dtype, seed=0):
    rng = np.random.RandomState(seed)
    q, m = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dtype)
            for _ in range(2))
    g = torch.from_numpy(rng.randn(b, (2 * radius + 1) ** 2, h, w).astype(np.float32))
    return q, m, g.to(dtype)


# radius 1-4, stride 1-3; W 1, 17, 31, 33, 40, 65 (a partial 32-column tile,
# or more than one), H 1, 5, 6, 9, 13 (a partial 4-row tile)
K2_CASES = [(1, 1, 3, 5, 33), (2, 2, 5, 9, 40), (3, 3, 5, 6, 17), (4, 1, 4, 9, 65),
            (4, 2, 2, 13, 31), (2, 3, 3, 5, 1), (4, 3, 3, 6, 34), (1, 2, 4, 1, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,stride,c,h,w", K2_CASES)
def test_k2_tiling_emulation_matches_the_plain_backward(radius, stride, c, h, w, dtype):
    q, m, g = _bwd_case(2, c, h, w, radius, dtype)
    got = emulate_corr_bwd(q, m, g, radius, stride)
    ref = k1.corr_bwd_plain(q, m, g, radius, stride)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=CORR_TOL[dtype][0], rtol=CORR_TOL[dtype][1])


def test_k2_emulation_catches_a_mirrored_dm_shift():
    """Negative control: dm with the shift of dq (p + d instead of p - d)
    is caught by the comparison above."""
    q, m, g = _bwd_case(1, 3, 9, 40, 4, torch.float32, seed=1)
    _, dm = emulate_corr_bwd(q, m, g, 4, 2, mirror=True)
    _, ref = k1.corr_bwd_plain(q, m, g, 4, 2)
    assert not np.allclose(dm.numpy(), ref.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,stride", [(r, s) for r in (1, 2, 3, 4) for s in (1, 2, 3)])
def test_k2_geometry_fits_a_block_and_two_blocks_fit_an_sm(radius, stride, dtype):
    geo = k1.corr_bwd_geometry(dtype, radius, stride)
    assert geo["smem_bytes"] <= k1.MAX_SMEM_BYTES
    assert geo["a"] >= geo["halo"] and geo["a"] % (16 // dtype.itemsize) == 0
    assert geo["grows"] == geo["rows"] + radius * stride
    if stride <= 2:  # the SegFlow levels' strides: two blocks share an SM
        assert 2 * (geo["smem_bytes"] + 1024) <= SMEM_PER_SM
    # the 32 channels of a block come in whole stages, split over 4 warps
    assert 32 % geo["stage_channels"] == 0 and geo["stage_channels"] % 4 == 0


def test_k2_geometry_of_a_halo_too_wide_to_stage():
    """Radius 4 at stride 7 needs more shared memory (float32) than a block
    has, 6 does not: the wrapper refuses the first (tests/test_torch_cuda.py)."""
    assert k1.corr_bwd_geometry(torch.float32, 4, 7)["smem_bytes"] > k1.MAX_SMEM_BYTES
    assert k1.corr_bwd_geometry(torch.float32, 4, 6)["smem_bytes"] <= k1.MAX_SMEM_BYTES


# -- K5 ----------------------------------------------------------------------

K5_RAGGED = [(3, 7, 33, 129), (5, 3, 17, 9)]
K5_TRAIN_NOTE = (40, 32, 320, 256)  # bf16, the Task002 2d training batch's first stage
K5_PLAN_SHAPES = ([(UNET_BATCH, *shape) for shape, _ in UNET_K5_SHAPES]
                  + [K5_TRAIN_NOTE] + K5_RAGGED)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", K5_PLAN_SHAPES)
def test_norm_act_plan_fits_a_block_and_a_portable_cluster(n, c, h, w, dtype):
    plan = k5.norm_act_plan(n, c, h, w, dtype)
    hw, item = h * w, dtype.itemsize
    if hw * item <= k5.SMALL_MAX_BYTES:
        assert plan == k5.WARP_PLAN
        return
    group = 16 // item
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= k5.MAX_CLUSTER
    assert plan.path == ("block" if plan.cluster == 1 else "cluster")
    assert plan.slice % group == 0 and plan.slice * plan.cluster >= hw
    assert plan.slice * (plan.cluster - 1) < hw  # no block is left without elements
    assert plan.smem_bytes == (plan.slice // group + 1) * 16 <= k1.MAX_SMEM_BYTES
    assert plan.slice * item <= k5.SLICE_BYTES or plan.cluster == k5.MAX_CLUSTER


def test_norm_act_plan_holds_the_largest_float32_plane_in_a_cluster():
    plan = k5.norm_act_plan(UNET_BATCH, 32, 320, 256, torch.float32)
    assert plan.path == "cluster" and plan.cluster == 4
    assert 2 * (plan.smem_bytes + 1024) <= SMEM_PER_SM  # two blocks share an SM


def test_norm_act_plan_refuses_a_plane_too_large_for_the_largest_cluster():
    with pytest.raises(ValueError, match="shared memory"):
        k5.norm_act_plan(1, 1, 1024, 1024, torch.float32)  # 4 MB over 8 blocks


def emulate_norm_act(x, scale, bias, plan, eps=1e-5, slope=0.01, threads=256):
    """K5's block and cluster path in float32, in the kernel's order: each
    block stages its slice at its offset from the 16-byte grid (zeros
    around it), thread t sums groups t, t + 256, ... element by element, a
    butterfly sums each warp, the warps add in order, and every block adds
    the cluster's partials in rank order."""
    n, c, h, w = x.shape
    hw, item = h * w, x.element_size()
    group = 16 // item
    xf = x.float().reshape(n * c, hw)
    planes = torch.arange(n * c)
    sums = torch.zeros(n * c, 2)
    for rank in range(plan.cluster):
        s0 = rank * plan.slice
        ln = max(0, min(plan.slice, hw - s0))
        mis = (planes * hw + s0) % group  # a 16-byte aligned base
        ng = (mis + ln + group - 1) // group
        sx = torch.zeros(n * c, int(ng.max()) * group + threads * group)
        for p in range(n * c):
            sx[p, int(mis[p]):int(mis[p]) + ln] = xf[p, s0:s0 + ln]
        acc = torch.zeros(n * c, 2, threads)
        for it in range(-(-int(ng.max()) // threads)):
            v = sx[:, it * threads * group:(it + 1) * threads * group].reshape(n * c, threads,
                                                                             group)
            for e in range(group):
                acc[:, 0] = acc[:, 0] + v[..., e]
                acc[:, 1] = acc[:, 1] + v[..., e] * v[..., e]
        acc = acc.reshape(n * c, 2, threads // 32, 32)
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[..., torch.arange(32) ^ off]
        part = torch.zeros(n * c, 2)
        for wp in range(threads // 32):
            part = part + acc[..., wp, 0]
        sums = sums + part
    mean = sums[:, 0] / hw
    inv = torch.rsqrt(sums[:, 1] / hw - mean * mean + eps)
    cs = torch.arange(n * c) % c
    y = (xf - mean[:, None]) * inv[:, None]
    y = y * scale[cs][:, None] + bias[cs][:, None]
    return torch.where(y >= 0, y, slope * y).reshape(n, c, h, w).to(x.dtype)


# a cluster of 4 (the U-Net's 320 x 256 float32 planes), of 2 and of 8 with
# planes off the 16-byte grid, and a block a plane
@pytest.mark.parametrize("n,c,h,w", [(1, 2, 320, 256), (2, 3, 1, 20481), (1, 2, 257, 319),
                                     (3, 7, 33, 129)])
def test_cluster_reduction_emulation_matches_the_plain_version(n, c, h, w):
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(n, c, h, w) * 2 + 0.5).astype(np.float32))
    x[0, 0] = 0.25  # a constant plane
    scale = torch.from_numpy(1 + 0.2 * rng.randn(c).astype(np.float32))
    bias = torch.from_numpy(0.2 * rng.randn(c).astype(np.float32))
    plan = k5.norm_act_plan(n, c, h, w, torch.float32)
    assert plan.path != "warp"
    got = emulate_norm_act(x, scale, bias, plan)
    np.testing.assert_allclose(got.numpy(), k5.norm_act_plain(x, scale, bias).numpy(),
                               atol=NORM_TOL_F32[0], rtol=NORM_TOL_F32[1])

"""K2's tiling and K5's plans, on the CPU.

K2 (csrc/corr_bwd.cu) and K5 (csrc/norm_act.cu) run only on the card, so
what surrounds their arithmetic is held here: a torch emulation of K2's
tiles (window-row staging with the r*s halo, the g rows that dq and dm
share, the kernel's shared-memory indices) against ``corr_bwd_plain``;
``norm_act_plan`` at every shape of the paths; and an emulation of K5's
fixed-order reduction (threads, warp butterfly, warps, cluster ranks)
against ``norm_act_plain`` at K5's float32 tolerance. K7 and K7 dx (csrc/
inorm_lrelu.cu) likewise: their plain closed forms, which the CPU side of
their autograd function runs, against autograd of the eager InstanceNorm +
LeakyReLU in float64, with ``native_plan`` and the route at each shape.
"""

import numpy as np
import pytest
import torch
import torch_threads

from csof_tpu_torch.bounds import UNET_BATCH, UNET_K5_SHAPES
from csof_tpu_torch.ops.kernels import corr as k1
from csof_tpu_torch.ops.kernels import norm_act as k5

torch_threads.pin()

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


F32, BF16 = torch.float32, torch.bfloat16
# the plans K5's norm_act_plan and K7's native_plan gave, each with its own
# copy of the cluster rule, before both became callers of plane_plan:
# (path, cluster, slice, smem_bytes), None where they raised. K5: the U-Net's
# planes at UNET_BATCH and at the training batch, the ragged shapes, each
# side of every threshold (NORM_PLAN_EDGES of the card tests) and a
# plane too large; K7 (forward, dx): the 2-D and 3-D U-Net's planes and
# each side of the warp, slice and shared-memory edges
K5_OLD_PLANS = [
    ((32, 32, 320, 256), F32, ("cluster", 4, 20480, 81936)),
    ((32, 32, 320, 256), BF16, ("cluster", 2, 40960, 81936)),
    ((32, 64, 160, 128), F32, ("block", 1, 20480, 81936)),
    ((32, 64, 160, 128), BF16, ("block", 1, 20480, 40976)),
    ((32, 128, 80, 64), F32, ("block", 1, 5120, 20496)),
    ((32, 128, 80, 64), BF16, ("block", 1, 5120, 10256)),
    ((32, 256, 40, 32), F32, ("block", 1, 1280, 5136)),
    ((32, 256, 40, 32), BF16, ("warp", 0, 0, 0)),
    ((32, 480, 20, 16), F32, ("warp", 0, 0, 0)),
    ((32, 480, 20, 16), BF16, ("warp", 0, 0, 0)),
    ((32, 480, 10, 8), F32, ("warp", 0, 0, 0)),
    ((32, 480, 10, 8), BF16, ("warp", 0, 0, 0)),
    ((32, 480, 5, 4), F32, ("warp", 0, 0, 0)),
    ((32, 480, 5, 4), BF16, ("warp", 0, 0, 0)),
    ((40, 32, 320, 256), F32, ("cluster", 4, 20480, 81936)),
    ((40, 32, 320, 256), BF16, ("cluster", 2, 40960, 81936)),
    ((3, 7, 33, 129), F32, ("block", 1, 4260, 17056)),
    ((3, 7, 33, 129), BF16, ("block", 1, 4264, 8544)),
    ((5, 3, 17, 9), F32, ("warp", 0, 0, 0)),
    ((5, 3, 17, 9), BF16, ("warp", 0, 0, 0)),
    ((2, 3, 32, 32), F32, ("warp", 0, 0, 0)),
    ((2, 3, 32, 32), BF16, ("warp", 0, 0, 0)),
    ((2, 3, 1, 1025), F32, ("block", 1, 1028, 4128)),
    ((2, 3, 1, 1025), BF16, ("warp", 0, 0, 0)),
    ((2, 3, 1, 2049), F32, ("block", 1, 2052, 8224)),
    ((2, 3, 1, 2049), BF16, ("block", 1, 2056, 4128)),
    ((2, 3, 128, 160), F32, ("block", 1, 20480, 81936)),
    ((2, 3, 128, 160), BF16, ("block", 1, 20480, 40976)),
    ((2, 3, 1, 20481), F32, ("cluster", 2, 10244, 40992)),
    ((2, 3, 1, 20481), BF16, ("block", 1, 20488, 40992)),
    ((1, 3, 160, 256), F32, ("cluster", 2, 20480, 81936)),
    ((1, 3, 160, 256), BF16, ("block", 1, 40960, 81936)),
    ((1, 3, 40961, 1), F32, ("cluster", 4, 10244, 40992)),
    ((1, 3, 40961, 1), BF16, ("cluster", 2, 20488, 40992)),
    ((1, 2, 320, 256), F32, ("cluster", 4, 20480, 81936)),
    ((1, 2, 320, 256), BF16, ("cluster", 2, 40960, 81936)),
    ((1, 2, 257, 319), F32, ("cluster", 8, 10248, 41008)),
    ((1, 2, 257, 319), BF16, ("cluster", 4, 20496, 41008)),
    ((1, 1, 1024, 1024), F32, None),
    ((1, 1, 1024, 1024), BF16, None),
]
K7_OLD_PLANS = [
    (320 * 256, ("cluster", 4, 20480, 81936), ("cluster", 8, 10240, 81952)),
    (160 * 128, ("block", 1, 20480, 81936), ("cluster", 2, 10240, 81952)),
    (80 * 64, ("block", 1, 5120, 20496), ("block", 1, 5120, 40992)),
    (40 * 32, ("block", 1, 1280, 5136), ("block", 1, 1280, 10272)),
    (20 * 16, ("warp", 0, 0, 0), ("warp", 0, 0, 0)),
    (10 * 8, ("warp", 0, 0, 0), ("warp", 0, 0, 0)),
    (5 * 4, ("warp", 0, 0, 0), ("warp", 0, 0, 0)),
    (192 * 160, ("cluster", 2, 15360, 61456), ("cluster", 4, 7680, 61472)),
    (96 * 80, ("block", 1, 7680, 30736), ("block", 1, 7680, 61472)),
    (1024, ("warp", 0, 0, 0), ("warp", 0, 0, 0)),
    (1025, ("block", 1, 1028, 4128), ("block", 1, 1028, 8256)),
    (10240, ("block", 1, 10240, 40976), ("block", 1, 10240, 81952)),
    (10241, ("block", 1, 10244, 40992), ("cluster", 2, 5124, 41024)),
    (20481, ("cluster", 2, 10244, 40992), ("cluster", 4, 5124, 41024)),
    (40960, ("cluster", 2, 20480, 81936), ("cluster", 4, 10240, 81952)),
    (40961, ("cluster", 4, 10244, 40992), ("cluster", 8, 5124, 41024)),
    (81921, ("cluster", 8, 10244, 40992), ("cluster", 8, 10244, 81984)),
    (163841, ("cluster", 8, 20484, 81952), ("cluster", 8, 20484, 163904)),
    (232000, ("cluster", 8, 29000, 116016), ("cluster", 8, 29000, 232032)),
    (240000, ("cluster", 8, 30000, 120016), None),
    (1024 * 1024, None, None),
]
PLANE_PLAN_CASES = ([("K5", shape, dtype, 1, want) for shape, dtype, want in K5_OLD_PLANS]
                    + [("K7", (hw,), F32, 1, fwd) for hw, fwd, _ in K7_OLD_PLANS]
                    + [("K7_dx", (hw,), F32, 2, bwd) for hw, _, bwd in K7_OLD_PLANS])


@pytest.mark.parametrize("kernel,shape,dtype,arrays,want", PLANE_PLAN_CASES)
def test_plane_plan_gives_the_plans_of_k5_and_k7_it_replaced(kernel, shape, dtype, arrays,
                                                             want):
    hw = shape[-2] * shape[-1] if kernel == "K5" else shape[0]
    callers = {"K5": lambda: k5.norm_act_plan(*shape, dtype),
               "K7": lambda: k5.native_plan(hw), "K7_dx": lambda: k5.native_plan(hw, True)}
    if want is None:
        for plan in (lambda: k5.plane_plan(hw, dtype, arrays), callers[kernel]):
            with pytest.raises(ValueError, match="shared memory"):
                plan()
        return
    want = k5.NormActPlan(*want)
    assert k5.plane_plan(hw, dtype, arrays) == want
    assert callers[kernel]() == want


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


# K7's paths at U-Net-like planes: a warp a plane (5 x 7), a block (40 x 32;
# K7 dx: a block too), a cluster (160 x 128: K7 a block of 80 KB, K7 dx a
# cluster of 2)
@pytest.mark.parametrize("n,c,h,w,fwd,bwd", [(2, 3, 5, 7, 0, 0), (2, 4, 40, 32, 1, 1),
                                             (1, 2, 160, 128, 1, 2)])
def test_native_norm_act_plain_forms_equal_the_eager_autograd(n, c, h, w, fwd, bwd):
    import torch.nn.functional as F

    from csof_tpu_torch.models.blocks import ConvNormAct, InstanceNorm, leaky_relu

    assert (k5.native_plan(h * w).cluster, k5.native_plan(h * w, True).cluster) == (fwd, bwd)
    rng = np.random.RandomState(11)
    z = torch.from_numpy(rng.randn(n, c, h, w) * 2 + 0.5)
    z[0, 0] = 0.25  # a constant plane
    dy = torch.from_numpy(rng.randn(n, c, h, w))
    norm = InstanceNorm(c)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(1 + 0.2 * rng.randn(c)))
        norm.bias.copy_(torch.from_numpy(0.2 * rng.randn(c)))
    # the module's float32 formula (biased two-pass variance, eps inside the
    # root, then the affine and the activation), autograd in float64
    ref = [t.detach().double().requires_grad_() for t in (z, norm.weight, norm.bias)]
    leaky_relu(F.instance_norm(ref[0], weight=ref[1], bias=ref[2], eps=norm.eps)).backward(dy)
    got = [t.detach().double().requires_grad_() for t in (z, norm.weight, norm.bias)]
    before = (k5.native_launches, k5.native_bwd_launches)
    y = k5.native_norm_act(*got, norm.eps)
    y.backward(dy)
    assert (k5.native_launches, k5.native_bwd_launches) == before  # no kernel on the CPU
    with torch.no_grad():
        want = leaky_relu(F.instance_norm(z, weight=ref[1], bias=ref[2], eps=norm.eps))
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-10, atol=1e-10)
    # the backward given the signs of y (as a check of the kernel replays its
    # own) equals the backward taking them from its own pre-activation
    wb = [t.detach().double() for t in (norm.weight, norm.bias)]
    _, mean, rstd = k5.native_forward_plain(z, *wb, norm.eps)
    own = k5.native_backward_plain(z, dy, mean, rstd, *wb)
    given = k5.native_backward_plain(z, dy, mean, rstd, *wb, positive=y.detach() >= 0)
    assert all(torch.equal(a, b) for a, b in zip(own, given))
    # the route: float32 CUDA planes of a 2D instance block; never the CPU,
    # bfloat16, a 3D block, GroupNorm or K5
    block = ConvNormAct(c, c, norm="instance")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert block.uses_k7(h * w, cuda, torch.float32)
    assert not block.uses_k7(h * w, cpu, torch.float32)
    assert not block.uses_k7(h * w, cuda, torch.bfloat16)
    assert not ConvNormAct(c, c, norm="instance", kernel_size=(3, 3, 3)).uses_k7(h * w, cuda,
                                                                                 torch.float32)
    assert not ConvNormAct(c, c, norm="group").uses_k7(h * w, cuda, torch.float32)
    assert not ConvNormAct(c, c, norm="instance", fused_norm_act=True).uses_k7(h * w, cuda,
                                                                               torch.float32)
    x = torch.from_numpy(rng.randn(n, c, h, w).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(block(x).numpy(),
                                      leaky_relu(block.InstanceNorm_0(block.Conv_0(x))).numpy())
    assert (k5.native_launches, k5.native_bwd_launches) == before

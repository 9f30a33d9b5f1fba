"""CUDA kernels of the PyTorch port on the card, against their plain
PyTorch versions. Every test skips without a CUDA device. This file imports
no JAX, so it also runs where JAX is not installed:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.ops.kernels import corr as k1
from csof_tpu_torch.ops.kernels import skipfuse as k3

# bf16 corr: both round the same f32 sum, taken in another order -> 1 ulp
CORR_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
SKIP_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 5e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, c, h, w, seed=0):
    rng = np.random.RandomState(seed)
    q, m = (torch.from_numpy(rng.randn(2, c, h, w).astype(np.float32)).to(device, dtype)
            for _ in range(2))
    cin = 2 * c + 81
    params = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.randn(c, cin, 3, 3) * np.sqrt(2.0 / (9 * cin)), 0.1 * rng.randn(c),
        1 + 0.1 * rng.randn(c), 0.1 * rng.randn(c))]
    return q, m, params


def _close(got, ref, tol):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               ref.detach().float().cpu().numpy(),
                               atol=tol[0], rtol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w,stride", [(32, 64, 64, 2), (32, 24, 24, 1), (16, 20, 36, 2)])
def test_kernels_match_plain(cuda, c, h, w, stride, dtype):
    q, m, params = _inputs(cuda, dtype, c, h, w)
    before = (k1.launches, k3.launches)
    got = k1.corr_cuda(q, m, 4, stride)
    torch.cuda.synchronize()
    _close(got, k1.corr_plain(q, m, 4, stride), CORR_TOL[dtype])
    got = k3.skip_fuse_cuda(q, m, *params, 4, stride)
    torch.cuda.synchronize()
    _close(got, k3.skip_fuse_plain(q, m, *params, 4, stride), SKIP_TOL[dtype])
    # K3's first pass is a K1 launch
    assert (k1.launches, k3.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w,radius,stride", [
    (32, 64, 64, 4, 2), (64, 32, 32, 4, 1), (32, 24, 24, 4, 1), (16, 20, 36, 4, 2),
    (12, 19, 23, 1, 1), (8, 17, 33, 2, 3), (24, 16, 16, 3, 2),
])
def test_corr_backward_kernel_matches_plain(cuda, c, h, w, radius, stride, dtype):
    q, m, _ = _inputs(cuda, dtype, c, h, w)
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(2, (2 * radius + 1) ** 2, h, w).astype(np.float32))
    g = g.to(cuda, dtype)
    before = k1.bwd_launches
    dq, dm = k1.corr_bwd_cuda(q, m, g, radius, stride)
    torch.cuda.synchronize()
    assert k1.bwd_launches == before + 1
    rq, rm = k1.corr_bwd_plain(q, m, g, radius, stride)
    _close(dq, rq, CORR_TOL[dtype])
    _close(dm, rm, CORR_TOL[dtype])


def _fuse_inputs(device, dtype, b, c, f, h, w, radius, seed=3):
    """q, m (B, C, H, W) and K3's parameters for F output channels."""
    rng = np.random.RandomState(seed)
    q, m = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(device, dtype)
            for _ in range(2))
    cin = 2 * c + (2 * radius + 1) ** 2
    params = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.randn(f, cin, 3, 3) * np.sqrt(2.0 / (9 * cin)), 0.1 * rng.randn(f),
        1 + 0.1 * rng.randn(f), 0.1 * rng.randn(f))]
    return q, m, params


# K1's tile is 32 columns x 4 (float32) or 8 (bf16) rows; K3's conv tile 64
# columns x 2 or 4 rows: W 5, 23, 33, 70, 130 and H 3, 9, 13, 17 cross their
# edges; W 23, 33 and 5 are no multiple of K1's 16-byte group (element path);
# C 7, 12, 20 no multiple of its 8-channel chunk nor K3's 16 (bf16) / 8
# (float32) channel chunk, so K3's chunks straddle q, m and corr
RAGGED_CORR = [(1, 12, 17, 70, 4, 1), (8, 12, 9, 33, 4, 2), (1, 20, 13, 40, 3, 3),
               (8, 7, 3, 24, 1, 1), (1, 16, 9, 130, 2, 2), (1, 5, 3, 5, 4, 3),
               (8, 32, 17, 23, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,radius,stride", RAGGED_CORR)
def test_corr_kernel_across_its_tiling_edges(cuda, b, c, h, w, radius, stride, dtype):
    q, m, _ = _fuse_inputs(cuda, dtype, b, c, c, h, w, radius)
    before = k1.launches
    got = k1.corr_cuda(q, m, radius, stride)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    _close(got, k1.corr_plain(q, m, radius, stride), CORR_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,f,h,w,radius,stride", [
    (1, 12, 12, 17, 70, 4, 1),   # F = 12: 6 groups, N block 32 with 20 idle columns
    (8, 12, 12, 9, 33, 4, 2),
    (2, 20, 40, 13, 65, 3, 3),
    (1, 32, 32, 5, 129, 1, 1),
    (8, 7, 130, 3, 23, 2, 2),    # F = 130: two N blocks (128 + 2), 5 groups
    (1, 64, 64, 17, 5, 4, 1),
])
def test_skip_fuse_kernel_across_its_tiling_edges(cuda, b, c, f, h, w, radius, stride, dtype):
    q, m, params = _fuse_inputs(cuda, dtype, b, c, f, h, w, radius)
    before = (k1.launches, k3.launches)
    got = k3.skip_fuse_cuda(q, m, *params, radius, stride)
    torch.cuda.synchronize()
    assert (k1.launches, k3.launches) == (before[0] + 1, before[1] + 1)
    _close(got, k3.skip_fuse_plain(q, m, *params, radius, stride), SKIP_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skip_fuse_kernel_is_deterministic(cuda, dtype):
    """The GroupNorm partials are reduced in a fixed order (no atomics): two
    runs of K3 at the first SegFlow level give the same bits."""
    q, m, params = _fuse_inputs(cuda, dtype, 8, 32, 32, 128, 128, 4)
    a = k3.skip_fuse_cuda(q, m, *params, 4, 2)
    b = k3.skip_fuse_cuda(q, m, *params, 4, 2)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a, k3.skip_fuse_plain(q, m, *params, 4, 2), SKIP_TOL[dtype])


@pytest.mark.cuda
def test_corr_function_gradients_on_the_card(cuda):
    """K1 forward + K2 backward through autograd against autograd of the
    plain forward (float32)."""
    q, m, _ = _inputs(cuda, torch.float32, 32, 40, 40)
    g = torch.randn(2, 81, 40, 40, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    q.requires_grad_(True)
    m.requires_grad_(True)
    before = (k1.launches, k1.bwd_launches)
    got = torch.autograd.grad((k1.CorrFunction.apply(q, m, 4, 2) * g).sum(), (q, m))
    assert (k1.launches, k1.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = torch.autograd.grad((k1.corr_plain(q, m, 4, 2) * g).sum(), (q, m))
    for a, b in zip(got, ref):
        _close(a, b, (1e-4, 1e-4))


def _unaligned(t):
    """t's values in a contiguous tensor that starts one element past a
    16-byte boundary (the kernels' element paths)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _bwd_inputs(device, dtype, b, c, h, w, radius, seed=4):
    rng = np.random.RandomState(seed)
    q, m = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(device, dtype)
            for _ in range(2))
    g = torch.from_numpy(rng.randn(b, (2 * radius + 1) ** 2, h, w).astype(np.float32))
    return q, m, g.to(device, dtype)


# K2's block is 32 columns x 4 (float32) or 8 (bf16) rows and 32 channels,
# staged 8 channels a ring stage: C 1, 8, 13, 40 and 130 leave a block or a
# stage partly empty; W 1, 17, 33, 129 are no multiple of the 16-byte group
# (element copies and stores) and cross the 32-column tile, W 48 and 64
# take the 16-byte path at a ragged H; H 1 and 17 cross the row tiles;
# strides 1-3 (3 indexes shared memory per FMA), radius 1-4, B 1 and 4
RAGGED_CORR_BWD = [(1, 1, 17, 33, 4, 2), (4, 8, 1, 129, 4, 1), (1, 13, 17, 17, 3, 3),
                   (4, 130, 17, 1, 1, 1), (1, 13, 1, 1, 2, 2), (4, 8, 17, 129, 2, 3),
                   (1, 130, 17, 33, 4, 2), (4, 40, 17, 48, 3, 1), (1, 64, 17, 64, 4, 2),
                   (1, 8, 17, 33, 4, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,radius,stride", RAGGED_CORR_BWD)
def test_corr_backward_kernel_across_its_tiling_edges(cuda, b, c, h, w, radius, stride, dtype):
    q, m, g = _bwd_inputs(cuda, dtype, b, c, h, w, radius)
    before = k1.bwd_launches
    dq, dm = k1.corr_bwd_cuda(q, m, g, radius, stride)
    torch.cuda.synchronize()
    assert k1.bwd_launches == before + 1
    rq, rm = k1.corr_bwd_plain(q, m, g, radius, stride)
    _close(dq, rq, CORR_TOL[dtype])
    _close(dm, rm, CORR_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_backward_kernel_on_unaligned_tensors(cuda, dtype):
    """Tensors off the 16-byte grid take K2's element copies and stores."""
    q, m, g = _bwd_inputs(cuda, dtype, 2, 20, 24, 64, 4)
    dq, dm = k1.corr_bwd_cuda(*(_unaligned(t) for t in (q, m, g)), 4, 2)
    rq, rm = k1.corr_bwd_plain(q, m, g, 4, 2)
    _close(dq, rq, CORR_TOL[dtype])
    _close(dm, rm, CORR_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_backward_kernel_is_deterministic(cuda, dtype):
    """Each output is summed by one thread in a fixed order (no atomics):
    two runs of K2 at the first SegFlow level give the same bits."""
    q, m, g = _bwd_inputs(cuda, dtype, 4, 32, 128, 128, 4)
    a = k1.corr_bwd_cuda(q, m, g, 4, 2)
    b = k1.corr_bwd_cuda(q, m, g, 4, 2)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# K5: the kernel and the plain version take the same float32 sums in another
# order, so the statistics differ by a few float32 ulps, which the
# normalization scales by 1/std; bf16 rounds once: one bf16 ulp (2^-8).
NORM_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 8e-3)}
# K6: the same float32 sum in another order (up to 9 * 128 terms); bf16
# output rounds once, plus one rounding of the bias add
CONV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", [
    (4, 32, 320, 256), (4, 64, 160, 128), (3, 128, 80, 64), (2, 480, 5, 4), (3, 7, 33, 129),
    (2, 5, 1, 1),
])
def test_norm_act_kernel_matches_plain(cuda, n, c, h, w, dtype):
    from csof_tpu_torch.ops.kernels import norm_act as k5

    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(n, c, h, w) * 2 + 0.5).astype(np.float32)).to(cuda, dtype)
    x[0, 0] = 0.25  # a constant plane stays finite
    scale = torch.from_numpy(1 + 0.2 * rng.randn(c).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(0.2 * rng.randn(c).astype(np.float32)).to(cuda)
    before = k5.launches
    got = k5.norm_act_cuda(x, scale, bias)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got, k5.norm_act_plain(x, scale, bias), NORM_TOL[dtype])


def _norm_inputs(device, dtype, n, c, h, w, seed=3):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n, c, h, w) * 2 + 0.5).astype(np.float32)).to(device, dtype)
    x[0, 0] = 0.25  # a constant plane stays finite
    scale = torch.from_numpy(1 + 0.2 * rng.randn(c).astype(np.float32)).to(device)
    bias = torch.from_numpy(0.2 * rng.randn(c).astype(np.float32)).to(device)
    return x, scale, bias


# each side of every threshold of norm_act_plan: 4 KB planes (a warp a plane
# / a block: float32 1024 / 1025 elements, bf16 2048 / 2049), then slices of
# 80 KB: 20480 elements (float32: a block / a cluster of 2), 40960 (float32:
# 2 / 4; bf16: a block / 2), 81920 (float32: 4 / 8; bf16: 2 / 4); plane
# sizes 1025, 2049, 20481, 40961, 81983 and 4257 put planes off the 16-byte
# grid (element copies for a head and tail)
NORM_PLAN_EDGES = [(2, 3, 32, 32), (2, 3, 1, 1025), (2, 3, 1, 2049), (2, 3, 64, 64),
                   (2, 3, 128, 160), (2, 3, 1, 20481), (1, 3, 160, 256), (1, 3, 40961, 1),
                   (1, 2, 320, 256), (1, 2, 257, 319), (3, 7, 33, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", NORM_PLAN_EDGES)
def test_norm_act_kernel_across_its_plan_edges(cuda, n, c, h, w, dtype):
    from csof_tpu_torch.ops.kernels import norm_act as k5

    x, scale, bias = _norm_inputs(cuda, dtype, n, c, h, w)
    ref = k5.norm_act_plain(x, scale, bias)
    for xin in (x, _unaligned(x)):
        before = k5.launches
        got = k5.norm_act_cuda(xin, scale, bias)
        torch.cuda.synchronize()
        assert k5.launches == before + 1
        _close(got, ref, NORM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_act_kernel_is_deterministic(cuda, dtype):
    """Sums in a fixed order, the cluster's partials in rank order: two runs
    of K5 on the U-Net's largest planes give the same bits."""
    from csof_tpu_torch.ops.kernels import norm_act as k5

    x, scale, bias = _norm_inputs(cuda, dtype, 4, 32, 320, 256)
    a = k5.norm_act_cuda(x, scale, bias)
    b = k5.norm_act_cuda(x, scale, bias)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# K7 and K7 dx: the U-Net's level shapes at batch 2-3 (a cluster of 4 and of
# 8, a block and a cluster of 2, a block, a block, and the warp path), then
# each side of native_plan's edges: 1024 / 1025 elements (a warp / a block),
# 10240 / 10241 (K7 dx a block of 80 KB / a cluster of 2), 20480 / 20481
# (K7 a block / a cluster of 2), 40960 (2 / 4), 81983 (8 / 8), 160000 (K7 dx
# 8 blocks of 160 KB), and an odd shape; plane sizes not a multiple of 4 put
# planes off the 16-byte grid
NATIVE_SHAPES = [(2, 32, 320, 256), (2, 64, 160, 128), (3, 128, 80, 64), (3, 256, 40, 32),
                 (2, 480, 20, 16), (2, 480, 10, 8), (2, 480, 5, 4), (2, 3, 32, 32),
                 (2, 3, 1, 1025), (2, 3, 64, 160), (2, 3, 1, 10241), (2, 3, 128, 160),
                 (2, 3, 1, 20481), (1, 3, 256, 160), (1, 2, 257, 319), (1, 2, 400, 400),
                 (3, 7, 33, 129)]


def _native_reference(z, dy, weight, bias, negative_mask):
    """y and the gradients of z, weight and bias in float64: F.instance_norm
    (the module's formula), then LeakyReLU 0.01 where ``negative_mask`` says
    the pre-activation is negative (the card's signs, replayed: a sign flip
    at |a| within a rounding of 0 moves da by 0.99 dy at one element)."""
    import torch.nn.functional as F

    ref = [t.detach().double().requires_grad_() for t in (z, weight, bias)]
    a = F.instance_norm(ref[0], weight=ref[1], bias=ref[2], eps=1e-5)
    y = torch.where(negative_mask, a * 0.01, a)
    y.backward(dy.double())
    return y.detach(), *(t.grad for t in ref)


def _close_by_plane(got, ref, rtol=1e-4, rel_plane=1e-4):
    """|got - ref| <= rtol |ref| + rel_plane * max |ref| of its (n, c) plane
    (of the whole tensor for a 1-D one): float32 sums over a plane in
    another order, against float64."""
    got, ref = got.double(), ref.double()
    scale = ref.abs().amax((2, 3), keepdim=True) if ref.dim() == 4 else ref.abs().max()
    bad = (got - ref).abs() > rtol * ref.abs() + rel_plane * scale
    assert not bool(bad.any()), (int(bad.sum()), float((got - ref).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", NATIVE_SHAPES)
def test_native_norm_act_kernels_match_the_eager_autograd(cuda, n, c, h, w):
    """K7 (y, and the mean and rstd it saves) and K7 dx (dz, dgamma, dbeta)
    against leaky_relu(InstanceNorm(z)) and its autograd in float64, for z
    and dy on and off the 16-byte grid; one launch of each."""
    from csof_tpu_torch.ops.kernels import norm_act as k5

    z, weight, bias = _norm_inputs(cuda, torch.float32, n, c, h, w)
    dy = torch.from_numpy(np.random.RandomState(4).randn(n, c, h, w).astype(np.float32)).to(cuda)
    for zin, dyin in ((z, dy), (_unaligned(z), dy), (z, _unaligned(dy))):
        zz = zin.detach().requires_grad_()
        wb = [t.detach().clone().requires_grad_() for t in (weight, bias)]
        before = (k5.native_launches, k5.native_bwd_launches)
        y = k5.native_norm_act(zz, *wb)
        y.backward(dyin)
        torch.cuda.synchronize()
        assert (k5.native_launches, k5.native_bwd_launches) == (before[0] + 1, before[1] + 1)
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(zz.grad).all())
        ry, rdz, rdw, rdb = _native_reference(z, dy, weight, bias, y < 0)
        _close(y, ry, NORM_TOL[torch.float32])
        _close_by_plane(zz.grad, rdz)
        _close_by_plane(wb[0].grad, rdw)
        _close_by_plane(wb[1].grad, rdb)
    _, mean, rstd = k5.native_forward_cuda(z, weight, bias)
    zf = z.double().reshape(n * c, -1)
    _close(mean, zf.mean(1), (1e-5, 1e-5))
    _close(rstd, torch.rsqrt(zf.var(1, unbiased=False) + 1e-5), (1e-5, 1e-5))


@pytest.mark.cuda
def test_native_norm_act_kernels_are_deterministic(cuda):
    """Sums in a fixed order, the cluster's partials in rank order, dgamma
    and dbeta summed over N in order: two runs of K7 and K7 dx on the
    U-Net's largest planes give the same bits."""
    from csof_tpu_torch.ops.kernels import norm_act as k5

    z, weight, bias = _norm_inputs(cuda, torch.float32, 4, 32, 320, 256)
    dy = torch.randn(z.shape, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    runs = []
    for _ in range(2):
        zz, w, b = (t.detach().clone().requires_grad_() for t in (z, weight, bias))
        y = k5.native_norm_act(zz, w, b)
        y.backward(dy)
        runs.append((y, zz.grad, w.grad, b.grad))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_native_norm_act_route_engages_only_on_float32_2d_instance_blocks(cuda):
    """A float32 2D InstanceNorm block on the card runs K7 forward and K7 dx
    backward, and equals the eager module and activation; bfloat16, a 3D
    block, a GroupNorm block, a K5 block and a CPU block run none."""
    from csof_tpu_torch.models.blocks import ConvNormAct, leaky_relu
    from csof_tpu_torch.ops.kernels import norm_act as k5

    def run(block, x):
        before = (k5.native_launches, k5.native_bwd_launches)
        out = block(x.requires_grad_())
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        return out, (k5.native_launches - before[0], k5.native_bwd_launches - before[1])

    gen = torch.Generator().manual_seed(0)
    block = ConvNormAct(4, 8, norm="instance", generator=gen)
    x = torch.randn(2, 4, 48, 40, generator=gen)
    out, counts = run(block.to(cuda), x.to(cuda))
    assert counts == (1, 1)
    with torch.no_grad():
        want = leaky_relu(block.InstanceNorm_0(block.Conv_0(x.to(cuda))))
    _close(out, want, NORM_TOL[torch.float32])
    cases = [(ConvNormAct(4, 8, norm="instance", dtype=torch.bfloat16, generator=gen), cuda),
             (ConvNormAct(4, 8, norm="instance", kernel_size=(3, 3, 3), generator=gen), cuda),
             (ConvNormAct(4, 8, norm="group", generator=gen), cuda),
             (ConvNormAct(4, 8, norm="instance", fused_norm_act=True, generator=gen), cuda),
             (ConvNormAct(4, 8, norm="instance", generator=gen), torch.device("cpu"))]
    for other, device in cases:
        xi = x if len(other.Conv_0.kernel_size) == 2 else x[:, :, None].expand(2, 4, 3, 48, 40)
        if other.fused_norm_act:  # K5 has no backward: its forward alone
            with torch.no_grad():
                other.to(device)(xi.to(device))
            continue
        assert run(other.to(device), xi.to(device).contiguous())[1] == (0, 0), other


def _task002_step(cuda):
    """The cell's U-Net (Task002 2d plan, conv_impl pallas, K5 off) at full
    width on the card, a batch of two 320 x 256 patches, and its loss."""
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.training.trainer import make_seg_loss

    net = unet_from_plans(task002_heart_2d(), conv_impl="pallas", fused_norm_act=False,
                          generator=torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.RandomState(0)
    seg = np.zeros((2, 320, 256), np.int64)
    seg[:, 100:220, 60:200] = 1
    batch = {"data": torch.from_numpy((rng.randn(2, 1, 320, 256) + seg[:, None])
                                      .astype(np.float32)).to(cuda),
             "seg": torch.from_numpy(seg).to(cuda)}
    loss_fn = make_seg_loss(ExperimentConfig(model="unet2d", data=DataConfig(do_data_aug=False)))
    return net, batch, loss_fn


@pytest.mark.cuda
def test_task002_step_launches_k7_as_kernel_launches_counts(cuda):
    """One training step of the cell's model: the wrappers' K7 and K7 dx
    counts equal GenericUNet.kernel_launches (26 blocks, each once a
    direction), and so do the inorm_lrelu device events of a traced step."""
    from csof_tpu_torch.kernel_times import device_events
    from csof_tpu_torch.ops.kernels import norm_act as k5

    net, batch, loss_fn = _task002_step(cuda)
    per = net.kernel_launches((320, 256), backward=True)
    assert (per["K7"], per["K7_dx"], per["K5"]) == (26, 26, 0)

    def step():
        net.zero_grad(set_to_none=True)
        loss, _ = loss_fn(net, batch)
        loss.backward()

    before = (k5.native_launches, k5.native_bwd_launches)
    step()
    torch.cuda.synchronize()
    assert (k5.native_launches - before[0], k5.native_bwd_launches - before[1]) == (26, 26)
    events, _ = device_events(step, reps=1)
    fwd = sum("inorm_lrelu_fwd" in e.name for e in events)
    bwd = sum("inorm_lrelu_bwd" in e.name for e in events)
    assert (fwd, bwd) == (per["K7"], per["K7_dx"]), (fwd, bwd)


@pytest.mark.cuda
def test_task002_sgd_steps_with_and_without_k7_agree(cuda, monkeypatch):
    """Two SGD-Nesterov steps of the cell's model from the same weights and
    batch, with the route and with the eager norm and activation: the losses
    and every parameter gradient of both steps agree to float32 tolerance.
    The eager run replays the routed run's LeakyReLU signs, block by block
    (a pre-activation within a rounding of 0 may take either side, and one
    such element moves a deep level's weight gradient by percents)."""
    from csof_tpu_torch.models import blocks
    from csof_tpu_torch.ops.kernels import norm_act as k5

    def run(hook):
        net, batch, loss_fn = _task002_step(cuda)
        for m in net.modules():
            if isinstance(m, blocks.ConvNormAct):
                m.register_forward_hook(hook)
        opt = torch.optim.SGD(net.parameters(), lr=1e-2, momentum=0.99, nesterov=True,
                              weight_decay=3e-5)
        out = []
        for _ in range(2):
            opt.zero_grad(set_to_none=True)
            loss, _ = loss_fn(net, batch)
            loss.backward()
            out.append((loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()
                                      if p.grad is not None}))
            opt.step()
        return out

    signs = []
    before = k5.native_launches
    routed = run(lambda mod, inp, out: signs.append(out.detach() < 0))
    assert k5.native_launches - before == 2 * 26 and len(signs) == 2 * 26
    monkeypatch.setattr(blocks.ConvNormAct, "uses_k7", lambda self, *args: False)
    replay = iter(signs)
    monkeypatch.setattr(blocks, "leaky_relu", lambda a: torch.where(next(replay), a * 0.01, a))
    eager = run(lambda *args: None)
    assert k5.native_launches - before == 2 * 26
    for (loss_k, grads_k), (loss_e, grads_e) in zip(routed, eager):
        np.testing.assert_allclose(loss_k, loss_e, rtol=1e-5)
        assert grads_k.keys() == grads_e.keys()
        for name, r in grads_e.items():
            r = r.cpu().numpy()
            np.testing.assert_allclose(grads_k[name].cpu().numpy(), r, rtol=0,
                                       atol=2e-3 * float(np.abs(r).max()) + 1e-6, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,ci,co,h,w,bias,out_f32", [
    (2, 1, 32, 320, 256, True, False), (2, 32, 32, 64, 64, True, False),
    (2, 128, 64, 40, 32, False, False), (3, 13, 40, 17, 23, True, False),
    (2, 8, 16, 9, 70, False, True), (1, 3, 5, 1, 1, True, True),
    # every tile edge of the tensor-core kernel: Ci not a multiple of the
    # k step and over one chunk, Co over one block, W across 64-pixel tiles
    (2, 1, 40, 17, 65, True, False), (1, 13, 130, 17, 129, False, False),
    (2, 130, 5, 1, 23, True, True), (1, 130, 128, 17, 70, True, False),
    (3, 13, 128, 1, 129, False, True), (2, 1, 130, 17, 1, True, True),
    (1, 130, 40, 17, 65, False, False), (2, 13, 5, 1, 70, False, True),
])
def test_conv3x3_kernel_matches_plain(cuda, n, ci, co, h, w, bias, out_f32, dtype):
    from csof_tpu_torch.ops.kernels import conv as k6

    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(n, ci, h, w).astype(np.float32)).to(cuda, dtype)
    wt = torch.from_numpy((rng.randn(co, ci, 3, 3) * np.sqrt(2 / (9 * ci))).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.randn(co).astype(np.float32)).to(cuda) if bias else None
    before = k6.launches
    got = k6.conv3x3_cuda(x, wt.to(cuda), b, out_f32)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    assert got.dtype == (torch.float32 if out_f32 else dtype)
    _close(got, k6.conv3x3_plain(x, wt.to(cuda), b, out_f32),
           CONV_TOL[torch.float32 if out_f32 else dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("ci", [8, 128, 256])
def test_conv3x3_float32_error_stays_flat_in_ci(cuda, ci):
    """float32 K6 against a float64 conv of the same inputs. Each chunk's
    products start a fresh accumulator, so the error does not grow with the
    27 * Ci / 8 tensor-core steps of the whole sum (in one accumulator it grew
    linearly, to 6e-5 at Ci 128 and 1.2e-4 at Ci 256)."""
    import torch.nn.functional as F

    from csof_tpu_torch.ops.kernels import conv as k6

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, ci, 32, 80).astype(np.float32)).to(cuda)
    wt = torch.from_numpy((rng.randn(64, ci, 3, 3) * np.sqrt(2 / (9 * ci))).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.randn(64).astype(np.float32)).to(cuda)
    wt = wt.to(cuda)
    got = k6.conv3x3_cuda(x, wt, b).double()
    ref = F.conv2d(x.double(), wt.double(), b.double(), padding=1)
    assert float((got - ref).abs().max()) < 2e-5


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, m, params = _inputs(cuda, torch.float32, 8, 12, 12)
    with pytest.raises(TypeError):
        k1.corr_cuda(q.half(), m.half(), 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        k1.corr_cuda(q.transpose(2, 3), m.transpose(2, 3), 2, 1)
    with pytest.raises(ValueError, match="radius"):
        k1.corr_cuda(q, m, 5, 1)
    with pytest.raises(ValueError, match="weight"):
        k3.skip_fuse_cuda(q, m, params[0][:, :10].contiguous(), *params[1:], 4, 1)
    g = torch.zeros(2, 25, 12, 12, device=cuda)
    with pytest.raises(ValueError, match="g must be"):
        k1.corr_bwd_cuda(q, m, g.bfloat16(), 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        k1.corr_bwd_cuda(q, m, g.transpose(2, 3), 2, 1)
    with pytest.raises(ValueError, match="halo"):
        k1.corr_bwd_cuda(q, m, torch.zeros(2, 81, 12, 12, device=cuda), 4, 7)
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    scale, bias = params[2], params[3]  # (8,) float32
    with pytest.raises(TypeError):
        k5.norm_act_cuda(q.half(), scale, bias)
    with pytest.raises(ValueError, match="scale"):
        k5.norm_act_cuda(q, scale[:4].contiguous(), bias)
    with pytest.raises(ValueError, match="weight"):
        k6.conv3x3_cuda(q, params[0])  # Ci 97, not 8
    with pytest.raises(ValueError, match="contiguous"):
        k6.conv3x3_cuda(q.transpose(2, 3), torch.zeros(4, 8, 3, 3, device=cuda))


@pytest.mark.cuda
def test_small_segflow_on_the_card_matches_the_cpu(cuda):
    cfg = SegFlowModelConfig(out_encoder_dims=(8, 16, 16), d_model=16, bottleneck_heads=2,
                             dim_feedforward=32, corr_fuse="fused_cm", dtype="float32")
    cpu = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(0))
    gpu = SegFlow(cfg, 4).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    video = torch.from_numpy(np.random.RandomState(1).rand(2, 4, 32, 32, 1).astype(np.float32))
    k3.launches = 0
    with torch.inference_mode():
        got = gpu(video.to(cuda))
        ref = cpu(video)
    assert k3.launches == 1 + 3 * 3  # prime step: bottleneck level only
    for k in ("seg_logits", "flow", "cum_flow", "registered"):
        _close(got[k], ref[k], (1e-3, 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_unet_on_the_card_matches_the_cpu(cuda, dtype):
    """Both switches on: K5 and K6 on the card against their plain versions
    on the CPU, through the whole U-Net and the predictor."""
    from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor
    from csof_tpu_torch.models.unet import GenericUNet
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    kw = dict(num_classes=3, base_num_features=16, pool_kernel_sizes=((2, 2),) * 3,
              conv_kernel_sizes=((3, 3),) * 4, dtype=dtype, fused_norm_act=True,
              conv_impl="pallas")
    cpu = GenericUNet(generator=torch.Generator().manual_seed(0), **kw).eval()
    gpu = GenericUNet(**kw).to(cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 1, 64, 96).astype(np.float32))
    k5.launches = k6.launches = 0
    with torch.inference_mode():
        got = gpu(x.to(cuda))
        ref = cpu(x)
    assert (k5.launches, k6.launches) == (14, 7)
    assert gpu.kernel_launches((64, 96)) == {"K5": 14, "K6": 7, "K7": 0}
    tol = (1e-3, 1e-3) if dtype == torch.float32 else (0.15, 0.05)
    for a, b in zip(got, ref):
        _close(a, b, tol)
    cfg = PredictorConfig((64, 64), 3, tile_batch=3)
    vol = np.random.RandomState(6).randn(1, 3, 70, 90).astype(np.float32)
    k5.launches = 0
    _, probs_gpu = SlidingWindowPredictor(gpu, cfg, cuda).predict_2d_stack(vol)
    _, probs_cpu = SlidingWindowPredictor(cpu, cfg, "cpu").predict_2d_stack(vol)
    forwards = -(-4 * 4 // 3)  # D 3 -> 4, a (96, 96) bucket: 4 tiles a slice; 2 pad tiles
    assert k5.launches == 14 * forwards
    np.testing.assert_allclose(probs_gpu, probs_cpu, atol=1e-3 if dtype == torch.float32 else 0.1)


@pytest.mark.cuda
def test_small_segflow_training_gradients_on_the_card_match_the_cpu(cuda):
    """The training loss and every parameter gradient, float32: K1 forward and
    K2 backward on the card against their plain versions on the CPU."""
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, LossWeights
    from csof_tpu_torch.training.trainer import build_model, make_segflow_loss

    config = ExperimentConfig(
        segflow=SegFlowModelConfig(out_encoder_dims=(8, 16, 16), d_model=16, bottleneck_heads=2,
                                   dim_feedforward=32, corr_fuse="concat", dtype="float32"),
        loss_weights=LossWeights(regularization_z=0.5, seg_registered=0.3, segmentation=1.0),
        data=DataConfig(do_data_aug=False))
    cpu = build_model(config, 4, torch.Generator().manual_seed(0))
    gpu = build_model(config, 4).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(2)
    batch = {"video": rng.rand(2, 4, 32, 32, 1).astype(np.float32),
             "seg": rng.randint(0, 4, (2, 4, 32, 32)).astype(np.int32),
             "labeled_mask": np.ones((2, 4), np.float32),
             "distance": rng.rand(2, 4).astype(np.float32)}
    loss_fn = make_segflow_loss(config)
    k1.launches = k1.bwd_launches = 0
    loss_gpu, _ = loss_fn(gpu, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    loss_gpu.backward()
    torch.cuda.synchronize()
    assert k1.launches == k1.bwd_launches == 1 + 3 * 3
    loss_cpu, _ = loss_fn(cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss_cpu.backward()
    np.testing.assert_allclose(loss_gpu.item(), loss_cpu.item(), rtol=1e-5)
    ref = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        r = ref[name].grad.numpy()
        np.testing.assert_allclose(p.grad.cpu().numpy(), r, rtol=0,
                                   atol=2e-3 * float(np.abs(r).max()) + 1e-6, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,ci,co,h,w", [
    (2, 32, 32, 64, 64), (2, 64, 32, 40, 48), (1, 64, 128, 32, 40), (3, 13, 40, 17, 23),
    # dx conv (Ci', Co') = (Co, Ci): Ci' 1, 13, 130 and Co' 5, 40, 128, 130
    (2, 1, 40, 17, 65), (1, 130, 13, 17, 129), (2, 5, 130, 1, 23), (1, 128, 130, 17, 70),
    (2, 40, 1, 17, 1), (1, 130, 130, 1, 129),
])
def test_conv3x3_backward_kernel_matches_plain(cuda, n, ci, co, h, w, dtype):
    """Conv3x3Function's gradients on the card: dx by K6 on the flipped
    weight against the plain dx formula (float32: against autograd of the
    plain forward too); dw and db as the plain version computes them."""
    from csof_tpu_torch.ops.kernels import conv as k6

    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(n, ci, h, w).astype(np.float32)).to(cuda, dtype)
    wt = torch.from_numpy((rng.randn(co, ci, 3, 3) * np.sqrt(2 / (9 * ci))).astype(np.float32))
    wt, b = wt.to(cuda), torch.from_numpy(0.1 * rng.randn(co).astype(np.float32)).to(cuda)
    dy = torch.from_numpy(rng.randn(n, co, h, w).astype(np.float32)).to(cuda, dtype)
    x.requires_grad_(True)
    wt.requires_grad_(True)
    b.requires_grad_(True)
    before = (k6.launches, k6.bwd_launches)
    got = torch.autograd.grad(k6.Conv3x3Function.apply(x, wt, b, False), (x, wt, b), dy)
    torch.cuda.synchronize()
    assert (k6.launches, k6.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    _close(got[0], k6.conv3x3_dx_plain(dy, wt.detach()), CONV_TOL[dtype])
    if dtype == torch.float32:
        ref = torch.autograd.grad(k6.conv3x3_plain(x, wt, b), (x, wt, b), dy)
        for a, r in zip(got, ref):
            _close(a, r, (1e-4 * float(r.abs().max()), 1e-4))


def _ncc_planes(n, h, w, seed=8):
    rng = np.random.RandomState(seed)
    i = rng.rand(n, h, w).astype(np.float32)
    i[:, : h // 3, : w // 3] = 0.4  # a constant region
    j = (0.7 * i + 0.3 * rng.rand(n, h, w)).astype(np.float32)
    return torch.from_numpy(i), torch.from_numpy(j)


#: K4 (N, H, W, window): the SegFlow loss at its training batch and at the
#: bench geometry, ragged H and W (1, 17, 33, 129; one column tile, a halo
#: off the 4-column group), planes wider than a block (column tiles: 300,
#: 600, 257), windows 1, 4, 8, 9, 15, 21, 31 (even, above 15, one wider than
#: the plane)
NCC_CASES = [(20, 128, 128, 9), (88, 128, 128, 9), (3, 33, 70, 9), (2, 17, 9, 5),
             (1, 40, 41, 15), (2, 1, 33, 9), (2, 17, 129, 4), (1, 129, 17, 31), (3, 33, 1, 1),
             (1, 17, 129, 31), (2, 129, 33, 15), (1, 9, 7, 21), (1, 40, 300, 9),
             (1, 20, 600, 31), (2, 17, 257, 4), (3, 33, 70, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,window", NCC_CASES)
def test_ncc_kernel_matches_plain(cuda, n, h, w, window):
    from csof_tpu_torch.ops.kernels import ncc as k4

    i, j = (t.to(cuda) for t in _ncc_planes(n, h, w))
    before = k4.launches
    got = k4.ncc_map_cuda(i, j, window)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and bool(torch.isfinite(got).all())
    _close(got, k4.ncc_map_plain(i, j, window), (1e-4, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,h,w,window", [(3, 33, 70, 9), (2, 17, 129, 4), (1, 40, 300, 31)])
def test_ncc_kernel_off_the_16_byte_grid(cuda, n, h, w, window, dtype):
    """Tensors that start one element past a 16-byte boundary take the
    kernel's element copies; bf16 and fp16 planes are widened as a cast."""
    from csof_tpu_torch.ops.kernels import ncc as k4

    i, j = (t.to(cuda, dtype) for t in _ncc_planes(n, h, w))
    ref = k4.ncc_map_plain(i, j, window)
    for a, b in ((i, j), (_unaligned(i), _unaligned(j))):
        got = k4.ncc_map_cuda(a, b, window)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        _close(got, ref, (1e-4, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", [(1, torch.float32), (3, torch.float32), (1, torch.bfloat16),
                                     (3, torch.bfloat16)])
def test_ncc_loss_kernel_is_one_launch_and_matches_ncc_loss(cuda, c, dtype):
    from csof_tpu_torch.ops import losses as L
    from csof_tpu_torch.ops.kernels import ncc as k4

    rng = np.random.RandomState(c)
    a = rng.rand(4, 40, 52, c).astype(np.float32)
    a[:, :10, :10] = 0.4
    b = (0.6 * a + 0.4 * rng.rand(4, 40, 52, c)).astype(np.float32)
    pred, target = (torch.from_numpy(t).to(cuda, dtype) for t in (a, b))
    before = k4.launches
    got = k4.ncc_loss_kernel(pred, target)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and got.shape == () and got.dtype == torch.float32
    ref = L.ncc_loss(pred, target)
    assert abs(got.item() - ref.item()) <= 1e-5
    from csof_tpu_torch.kernel_times import device_events

    events, launched = device_events(lambda: k4.ncc_loss_kernel(pred, target), reps=10)
    names = sorted({e.name for e in events})
    assert launched == 10 and len(names) == 1 and "ncc_kernel" in names[0], (launched, names)


@pytest.mark.cuda
def test_device_ms_without_a_traced_kernel_times_by_events(cuda, monkeypatch):
    """Where torch.profiler traces no kernel, device_ms takes the call's
    device time from CUDA events behind a spin kernel: positive, and no
    more than the host-clock median of a call with its launch gaps."""
    from csof_tpu_torch import kernel_times as kt

    x = torch.randn(64, 64, 128, 128, device=cuda)

    def call():
        return torch.relu(x)
    traced = kt.device_ms(call)["all"]
    monkeypatch.setattr(kt, "device_events", lambda fn, reps=10: ([], 10))
    queued = kt.device_ms(call)
    assert set(queued) == {"all"} and 0 < queued["all"] <= 2 * kt.median_ms(call)
    assert 0.5 * traced <= queued["all"] <= 2 * traced, (traced, queued)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,window,dtype", [
    (4, 64, 1000, 101, torch.float32), (2, 33, 300, 77, torch.bfloat16),
    (1, 17, 129, 9, torch.float32), (3, 20, 70, 127, torch.float16)])
def test_ncc_two_pass_path_matches_plain(cuda, n, h, w, window, dtype):
    """F9: the two-pass path (windows whose rings shared memory cannot hold,
    and any other it is given) against the plain map and loss; the map and
    loss in one wrapper call each, the same bits run to run."""
    from csof_tpu_torch.ops.kernels import ncc as k4

    i, j = (t.to(cuda, dtype) for t in _ncc_planes(n, h, w))
    plan = k4.two_pass_plan(n, h, w)
    assert window < 100 or k4.ncc_plan(n, h, w, window, i.element_size()) == plan
    maps = []
    for _ in range(2):
        out = torch.empty(n, h, w, dtype=torch.float32, device=cuda)
        k4.launch(i, j, out, None, n, 1, window, 1e-3, plan)
        maps.append(out)
    buf = torch.empty(1 + plan.blocks, dtype=torch.float32, device=cuda)
    k4.launch(i, j, None, buf, n, 1, window, 1e-3, plan)
    torch.cuda.synchronize()
    assert torch.equal(maps[0], maps[1])
    ref = k4.ncc_map_plain(i, j, window)
    _close(maps[0], ref, (1e-4, 0))
    loss_ref = 1.0 - ref.clamp(0.001, 0.999).mean()
    assert abs(buf[0].item() - loss_ref.item()) <= 1e-5


@pytest.mark.cuda
def test_ncc_one_pass_and_two_pass_losses_on_two_streams_keep_their_tickets(cuda):
    """A one-pass loss (window 9) and a two-pass loss (window 127) in flight
    at once on two streams, again and again: each launch of either path
    takes its own last-block ticket slot, so both losses stay right, and
    every slot is left clean for the loss after them."""
    from csof_tpu_torch.ops import losses as L
    from csof_tpu_torch.ops.kernels import ncc as k4

    i, j = (t.to(cuda)[..., None] for t in _ncc_planes(20, 128, 128))
    assert k4.ncc_plan(20, 128, 128, 9, 4).path == "fused"
    assert k4.ncc_plan(20, 128, 128, 127, 4).path == "two_pass"
    want = {w: L.ncc_loss(i, j, w).item() for w in (9, 127)}
    streams = {9: torch.cuda.Stream(cuda), 127: torch.cuda.Stream(cuda)}
    got = {9: [], 127: []}
    for _ in range(40):
        for w, s in streams.items():
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                got[w].append(k4.ncc_loss_kernel(i, j, w))
    torch.cuda.synchronize()
    for w, losses in got.items():
        worst = max(abs(v.item() - want[w]) for v in losses)
        assert worst <= 1e-5, (w, worst)
    after = k4.ncc_loss_kernel(i, j, 9)
    assert abs(after.item() - want[9]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["concat", "project", "split"])
def test_small_segflow_under_pallas_matches_the_cpu(cuda, mode):
    """SegFlow with conv_impl="pallas" at (8, 16) on 64-wide frames, float32:
    K6 forward and dx on the card, launched as often as the model counts,
    against the plain versions on the CPU (outputs, every gradient)."""
    from csof_tpu_torch.ops.kernels import conv as k6

    cfg = SegFlowModelConfig(out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2,
                             dim_feedforward=32, corr_radius=(2, 2), corr_stride=(2, 1),
                             corr_fuse=mode, dtype="float32")
    cpu = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(0), conv_impl="pallas")
    gpu = SegFlow(cfg, 4, conv_impl="pallas").to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    video = torch.from_numpy(np.random.RandomState(3).rand(1, 3, 64, 64, 1).astype(np.float32))
    k6.launches = k6.bwd_launches = 0
    outs = []
    for model, v in ((gpu, video.to(cuda)), (cpu, video)):
        out = model(v)
        ((out["seg_logits"] ** 2).mean() + (out["cum_flow"] ** 2).mean()
         + out["registered"].mean()).backward()
        outs.append(out)
    torch.cuda.synchronize()
    counts = gpu.kernel_launches(3, 64, backward=True)
    assert (k6.launches, k6.bwd_launches) == (counts["K6"], counts["K6_dx"]) != (0, 0)
    for k in ("seg_logits", "flow", "cum_flow", "registered"):
        _close(outs[0][k].detach(), outs[1][k].detach(), (1e-4, 1e-4))
    ref = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        r = ref[name].grad.numpy()
        np.testing.assert_allclose(p.grad.cpu().numpy(), r, rtol=0,
                                   atol=2e-3 * float(np.abs(r).max()) + 1e-6, err_msg=name)


@pytest.mark.cuda
def test_ncc_window_9_divides_exactly_for_every_float(cuda):
    """Window 9 divides by its 81 taps with a product and one FMA: all 2^32
    float32 values must round as IEEE division does."""
    from csof_tpu_torch.ops.kernels import ncc as k4

    assert k4.division_mismatches(9) == 0


@pytest.mark.cuda
def test_ncc_map_and_loss_are_the_same_bits_run_to_run(cuda):
    from csof_tpu_torch.ops.kernels import ncc as k4

    i, j = (t.to(cuda) for t in _ncc_planes(88, 128, 128))
    maps = [k4.ncc_map_cuda(i, j) for _ in range(2)]
    losses = [k4.ncc_loss_kernel(i[..., None], j[..., None]) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(maps[0], maps[1])
    assert losses[0].item() == losses[1].item() == losses[2].item()
    ref = k4.ncc_loss_kernel(i[..., None].cpu(), j[..., None].cpu())
    assert abs(losses[0].item() - ref.item()) <= 1e-5


@pytest.mark.cuda
def test_small_unet_train_step_on_the_card_matches_the_cpu(cuda):
    """The U-Net training loss, Dice statistics and every parameter
    gradient, float32, conv_impl="pallas": K6 forward and dx, K7 and K7 dx on
    the card against their plain versions and the eager norm on the CPU."""
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.models.unet import GenericUNet
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.training.trainer import make_seg_loss

    kw = dict(num_classes=3, base_num_features=8, pool_kernel_sizes=((2, 2),) * 3,
              conv_kernel_sizes=((3, 3),) * 4, conv_impl="pallas")
    cpu = GenericUNet(generator=torch.Generator().manual_seed(0), **kw)
    gpu = GenericUNet(**kw).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(9)
    batch = {"data": torch.from_numpy(rng.randn(2, 1, 64, 64).astype(np.float32)),
             "seg": torch.from_numpy(rng.randint(0, 3, (2, 64, 64)).astype(np.int32))}
    loss_fn = make_seg_loss(ExperimentConfig(model="unet2d", data=DataConfig(do_data_aug=False)))
    k6.launches = k6.bwd_launches = 0
    loss_gpu, aux_gpu = loss_fn(gpu, {k: v.to(cuda) for k, v in batch.items()})
    loss_gpu.backward()
    torch.cuda.synchronize()
    counts = gpu.kernel_launches((64, 64), backward=True)
    assert (k6.launches, k6.bwd_launches) == (counts["K6"], counts["K6_dx"]) == (7, 6)
    assert (counts["K7"], counts["K7_dx"]) == (14, 14)
    loss_cpu, aux_cpu = loss_fn(cpu, batch)
    loss_cpu.backward()
    np.testing.assert_allclose(loss_gpu.item(), loss_cpu.item(), rtol=1e-5)
    for k in ("tp", "fp", "fn"):
        _close(aux_gpu[k], aux_cpu[k], (1e-3, 1e-5))
    ref = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        if ref[name].grad is None:  # the zero-weight head
            assert p.grad is None, name
            continue
        r = ref[name].grad.numpy()
        np.testing.assert_allclose(p.grad.cpu().numpy(), r, rtol=0,
                                   atol=2e-3 * float(np.abs(r).max()) + 1e-6, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["v2", "base", "clip", "all"])
def test_augmentation_on_the_card_equals_the_cpu_apply(cuda, name):
    """The same draws (made on the CPU) through the apply on the card and on
    the CPU: float32 within 1e-5 of the largest value, segmentations equal;
    and a draw made on the card from a step generator is used as drawn."""
    import dataclasses

    from csof_tpu_torch.data import augment as ta

    cfg = {"v2": ta.AugmentConfig(), "base": ta.default_augment_config(),
           "clip": ta.clip_augment_config(),
           "all": dataclasses.replace(ta.video_augment_config(), p_elastic=1.0, p_lowres=1.0,
                                      p_inverted_gamma=1.0, p_blur=1.0, p_contrast=1.0)}[name]
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(4, 6, 64, 48).astype(np.float32))
    segs = torch.from_numpy(rng.randint(-1, 4, (4, 6, 64, 48)))
    gen = ta.step_generator(12345, 3, "cpu")
    spatial = ta.draw_spatial(gen, 4, 64, 48, cfg)
    intensity = ta.draw_intensity(gen, tuple(images.shape), cfg)
    cpu_img, cpu_seg = ta.apply_augment(images, segs, spatial, intensity, cfg)
    on_card = {k: v.to(cuda) for k, v in spatial.items()}, {k: v.to(cuda) for k, v in
                                                            intensity.items()}
    img, seg = ta.apply_augment(images.to(cuda), segs.to(cuda), *on_card, cfg)
    torch.cuda.synchronize()
    scale = cpu_img.abs().max().item()
    np.testing.assert_allclose(img.cpu().numpy(), cpu_img.numpy(), atol=1e-5 * scale, rtol=0)
    assert torch.equal(seg.cpu(), cpu_seg)
    # drawn on the card
    video = torch.from_numpy(rng.rand(2, 6, 64, 64, 1).astype(np.float32)).to(cuda)
    vseg = torch.from_numpy(rng.randint(-1, 4, (2, 6, 64, 64))).to(cuda)
    out, out_seg = ta.augment_video(ta.step_generator(1, 2, cuda), video, vseg)
    assert out.shape == video.shape and out.device.type == "cuda"
    assert bool(torch.isfinite(out).all()) and out_seg.dtype == vseg.dtype


def _smooth_field(rng, shape, amp):
    from scipy.ndimage import gaussian_filter

    f = np.stack([gaussian_filter(rng.randn(*shape), (0, 0, 3, 3)) for _ in range(2)], -1)
    return (amp * f / np.abs(f).max()).astype(np.float32)


@pytest.mark.cuda
def test_strain_jacobian_and_smoothing_on_the_card_equal_the_cpu(cuda):
    """The perimeter pass is exact on both devices (integer categories, a
    float64 weighted sum); the jacobian and gaussian_smooth are elementwise
    float32 (the latter with TF32 allowed: it takes no convolution call);
    the reports' reductions run in another order (STRAIN_TOL)."""
    from csof_tpu_torch.analysis.flow_analysis import (contour_error_report, jacobian_report,
                                                       strain_report)
    from csof_tpu_torch.data.conversion.acdc import _phantom_frame
    from csof_tpu_torch.ops.filters import gaussian_smooth
    from csof_tpu_torch.ops.jacobian import jacobian_determinant_batch
    from csof_tpu_torch.ops.strain import perimeter_batch, perimeter_histogram

    rng = np.random.RandomState(0)
    seg = np.stack([_phantom_frame((3, 64, 72), float(np.sin(np.pi * t / 6)), rng)[1]
                    for t in range(6)]).astype(np.uint8)  # (T, D, H, W)
    flow = _smooth_field(rng, seg.shape, 3.0)
    masks = torch.from_numpy(np.stack([seg == 1, seg == 3, (seg == 2) | (seg == 3)])
                             .reshape(-1, 64, 72))
    assert torch.equal(perimeter_histogram(masks.to(cuda)).cpu(), perimeter_histogram(masks))
    assert torch.equal(perimeter_batch(masks.to(cuda)).cpu(), perimeter_batch(masks))
    ft = torch.from_numpy(flow)
    _close(jacobian_determinant_batch(ft.to(cuda), ndim=2), jacobian_determinant_batch(ft, ndim=2),
           (1e-6, 1e-6))
    x = torch.from_numpy(rng.rand(4, 40, 50).astype(np.float32))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = gaussian_smooth(x.to(cuda), (0.8, 1.7, 2.5))
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _close(got, gaussian_smooth(x, (0.8, 1.7, 2.5)), (1e-7, 1e-6))
    strain_tol = dict(rtol=1e-5, atol=1e-4)  # percent: 100x a float32 thickness's rounding
    for got, ref in ((strain_report(seg, cuda), strain_report(seg, "cpu")),
                     (jacobian_report(flow, seg, cuda), jacobian_report(flow, seg, "cpu")),
                     (contour_error_report(flow[:, 1], seg[:, 1], 3, device=cuda),
                      contour_error_report(flow[:, 1], seg[:, 1], 3, device="cpu"))):
        assert sorted(got) == sorted(ref)
        for k in ref:
            g, r = (np.asarray(list(v.values()) if isinstance(v, dict) else v, np.float64)
                    for v in (got[k], ref[k]))
            np.testing.assert_allclose(g, r, err_msg=k, **strain_tol)


@pytest.mark.cuda
def test_a_worker_pool_after_cuda_use_equals_one_worker(cuda, tmp_path):
    """A process that has used CUDA opens the data plane's pools: the workers
    come from the fork server, hold neither the CUDA driver nor torch, and
    write what one worker writes."""
    import zipfile
    from pathlib import Path

    from csof_tpu_torch.cli.main import plan_and_preprocess_entry
    from csof_tpu_torch.data.conversion.acdc import convert_acdc, make_synthetic_acdc
    from csof_tpu_torch.utils.pool import map_in_processes

    torch.ones(8, device=cuda).sum().item()
    maps = Path("/proc/self/maps")
    assert torch.cuda.is_initialized() and "libcuda" in maps.read_text()
    for m in map_in_processes(maps.read_text, [None] * 3, 3):
        assert "libcuda" not in m and "libtorch" not in m
    make_synthetic_acdc(tmp_path / "raw", num_patients=3, num_frames=4, shape_zyx=(3, 40, 44))
    convert_acdc(tmp_path / "raw", tmp_path / "task")
    for n in (3, 1):
        plan_and_preprocess_entry(["-t", str(tmp_path / "task"), "-o", str(tmp_path / f"pre{n}"),
                                   "--num-workers", str(n)])
    a, b = tmp_path / "pre3", tmp_path / "pre1"
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert sum(f.suffix == ".npz" for f in files) == 3 * 6
    for rel in files:
        if rel.suffix == ".npz":
            with zipfile.ZipFile(a / rel) as za, zipfile.ZipFile(b / rel) as zb:
                assert all(za.read(n) == zb.read(n) for n in za.namelist()), rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


#: K6's z-tap route at the Task002 3d_fullres levels 0 and 1 (192x160 and
#: 96x80 planes; the depth cut): (Ci, Co, kernel, (D, H, W))
UNET3D_ROUTES = [(1, 32, (1, 3, 3), (4, 192, 160)), (64, 32, (3, 3, 3), (4, 192, 160)),
                 (64, 64, (3, 3, 3), (4, 96, 80)), (128, 64, (3, 3, 3), (6, 96, 80))]
#: the route against its plain tap sum (the same roundings: K6's float32 sum
#: in another order; bf16 rounds once) and against one F.conv3d (TF32 off;
#: bf16: cuDNN rounds its own sum and the bias add once more)
UNET3D_TOL = {torch.float32: ((1e-4, 1e-4), (1e-4, 1e-4)),
              torch.bfloat16: ((2e-2, 1e-2), (5e-2, 2e-2))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co,kernel,dhw", UNET3D_ROUTES)
def test_unet3d_k6_route_matches_its_plain_tap_sum_and_conv3d(cuda, ci, co, kernel, dhw, dtype):
    """A 3D ConvNormAct under pallas: its conv as one K6 launch a z tap on
    the card, against the same route on the CPU (the plain version in every
    tap) and against the block's F.conv3d on the card."""
    from csof_tpu_torch.models.blocks import ConvNormAct
    from csof_tpu_torch.ops.kernels import conv as k6

    block = ConvNormAct(ci, co, 1, "instance", dtype, generator=torch.Generator().manual_seed(0),
                        kernel_size=kernel, conv_impl="pallas")
    with torch.no_grad():
        block.Conv_0.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    x = torch.randn(2, ci, *dhw, generator=torch.Generator().manual_seed(1)).to(dtype)
    with torch.no_grad():
        ref = block._k6_taps(x)
        block = block.to(cuda)
        before = k6.launches
        got = block._k6_taps(x.to(cuda))
        torch.cuda.synchronize()
        launched = k6.launches - before
        lib = block.Conv_0(x.to(cuda))
    assert launched == kernel[0] and got.dtype == dtype and got.is_contiguous()
    tol_plain, tol_lib = UNET3D_TOL[dtype]
    _close(got.cpu(), ref, tol_plain)
    _close(got, lib, tol_lib)


@pytest.mark.cuda
def test_unet3d_training_step_launches_match_the_device_events(cuda):
    """The Task002 3d_fullres U-Net at full width on a cut patch (1 x
    16x96x96: level 1 is 48 wide, so K6 routes at levels 0 and 1), one
    training step under pallas: the wrappers' counts equal kernel_launches
    (17 K6, 16 dx), and so do the conv3x3_kernel and conv3x3_dx_kernel
    events of a traced step."""
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.config.plans import task002_heart_3d
    from csof_tpu_torch.kernel_times import device_events
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.training.trainer import make_seg_loss

    net = unet_from_plans(task002_heart_3d(), conv_impl="pallas",
                          generator=torch.Generator().manual_seed(0)).to(cuda)
    per = net.kernel_launches((16, 96, 96), backward=True)
    assert per == {"K5": 0, "K6": 17, "K7": 0, "K6_dx": 16, "K7_dx": 0}
    rng = np.random.RandomState(0)
    seg = np.zeros((1, 16, 96, 96), np.int64)
    seg[:, 4:12, 30:60, 20:70] = 1
    batch = {"data": torch.from_numpy((rng.randn(1, 1, 16, 96, 96) + seg[:, None])
                                      .astype(np.float32)).to(cuda),
             "seg": torch.from_numpy(seg).to(cuda)}
    loss_fn = make_seg_loss(ExperimentConfig(model="unet3d", data=DataConfig(do_data_aug=False)))

    def step():
        net.zero_grad(set_to_none=True)
        loss, _ = loss_fn(net, batch)
        loss.backward()

    before = (k6.launches, k6.bwd_launches)
    step()
    torch.cuda.synchronize()
    assert (k6.launches - before[0], k6.bwd_launches - before[1]) == (17, 16)
    events, _ = device_events(step, reps=1)
    fwd = sum("conv3x3_kernel" in e.name for e in events)
    dx = sum("conv3x3_dx_kernel" in e.name for e in events)
    assert (fwd, dx) == (per["K6"], per["K6_dx"]), (fwd, dx)


@pytest.mark.cuda
def test_unet3d_predict_case_fits_at_its_tile_batch(cuda, tmp_path):
    """predict_case of the Task002 3d_fullres U-Net (mirror TTA, pallas) on
    a case of 96 x 200 x 176 at the plans' spacing: TILE_BATCH_3D tiles x 8
    mirrors a forward, 17 K6 a forward, a finite softmax, and a peak device
    memory below half the card's."""
    from csof_tpu_torch.config.plans import task002_heart_3d
    from csof_tpu_torch.inference.predictor import TILE_BATCH_3D, predict_case
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.sliding_window import bucket_image_shape, step_grid
    from csof_tpu_torch.utils.nifti import save_nifti

    plans = task002_heart_3d()
    patch = plans.fullres_stage().patch_size
    shape = (96, 200, 176)
    img = (20 + 30 * np.random.RandomState(1).rand(*shape)).astype(np.float32)
    save_nifti(img, tmp_path / "la_000_0000.nii.gz", spacing_xyz=(1.25, 1.25, 1.37))
    net = unet_from_plans(plans, conv_impl="pallas",
                          generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    tiles = len(step_grid(patch, bucket_image_shape(shape, patch, 0.5, 32), 0.5))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = k6.launches
    res = predict_case(plans, net, [tmp_path / "la_000_0000.nii.gz"], tmp_path / "la_000.nii.gz",
                       device="cuda")
    peak = torch.cuda.max_memory_allocated()
    assert k6.launches - before == 17 * -(-tiles // TILE_BATCH_3D)
    assert res["softmax"].shape == (2, *shape) and np.isfinite(res["softmax"]).all()
    total = torch.cuda.get_device_properties(0).total_memory
    assert peak < total / 2, f"peak {peak / 2**30:.2f} GiB of {total / 2**30:.2f}"


@pytest.mark.cuda
def test_small_finalflow_on_the_card_launches_k6_k5_and_matches_the_cpu(cuda):
    """FinalFlow under both switches (instance norm): K6 and K5 on the card
    as often as FinalFlow.kernel_launches says, the outputs against the CPU's
    plain versions (float32)."""
    from csof_tpu_torch.models.finalflow import FinalFlow, FinalFlowConfig
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    for bottleneck in ("gru", "3d", "transformer"):
        cfg = FinalFlowConfig(out_encoder_dims=(8, 16), bottleneck_type=bottleneck,
                              bottleneck_heads=2, norm="instance", diffeomorphic=True,
                              int_steps=3, dtype="float32")
        cpu = FinalFlow(cfg, torch.Generator().manual_seed(0), conv_impl="pallas",
                        fused_norm_act=True).eval()
        gpu = FinalFlow(cfg, conv_impl="pallas", fused_norm_act=True).to(cuda).eval()
        gpu.load_state_dict(cpu.state_dict())
        video = torch.from_numpy(np.random.RandomState(1).rand(2, 3, 64, 64, 1)
                                 .astype(np.float32))
        k5.launches = k6.launches = 0
        with torch.inference_mode():
            got = gpu(video.to(cuda))
            torch.cuda.synchronize()
            want = gpu.kernel_launches(3, 64)
            assert (k5.launches, k6.launches) == (want["K5"], want["K6"]) == (16, 14)
            ref = cpu(video)
        for k in ("flow", "flow_forward", "registered", "velocity"):
            _close(got[k], ref[k], (1e-3, 1e-3))


@pytest.mark.cuda
def test_small_raft_and_voxelmorph_on_the_card_match_the_cpu(cuda):
    """RAFT (the all-pairs volume, the window lookup, convex upsampling) and
    VoxelMorph 2D and 3D (the warps, the integration) on the card against
    the CPU, float32."""
    from csof_tpu_torch.config.experiment import RaftModelConfig, VoxelMorphModelConfig
    from csof_tpu_torch.models.raft import RAFT
    from csof_tpu_torch.models.voxelmorph import VoxelMorph

    rng = np.random.RandomState(3)
    cfg = RaftModelConfig(feature_dim=32, hidden_dim=16, context_dim=16, iters=3,
                          corr_levels=3, dtype="float32")
    cpu = RAFT(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu = RAFT(cfg).to(cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    a = torch.from_numpy(rng.rand(2, 48, 64, 1).astype(np.float32))
    b = torch.roll(a, (1, 2), (1, 2))
    with torch.inference_mode():
        _close(gpu(a.to(cuda), b.to(cuda)), cpu(a, b), (1e-3, 1e-3))
    vcfg = VoxelMorphModelConfig(enc_features=(4, 8, 8), dec_features=(8, 8, 8, 4),
                                 dtype="float32")
    for shape in ((3, 32, 40, 1), (2, 8, 16, 24, 1)):
        cpu = VoxelMorph(vcfg, ndim=len(shape) - 2, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            cpu.flow_head.weight.mul_(3e4)  # fields of a few pixels
        gpu = VoxelMorph(vcfg, ndim=len(shape) - 2).to(cuda)
        gpu.load_state_dict(cpu.state_dict())
        moving, fixed = (torch.from_numpy(rng.rand(*shape).astype(np.float32)) for _ in "ab")
        with torch.inference_mode():
            got, ref = gpu(moving.to(cuda), fixed.to(cuda)), cpu(moving, fixed)
        for k in ("flow", "flow_inverse", "registered"):
            _close(got[k], ref[k], (1e-4, 1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["conv", "swin"])
def test_small_mtl_on_the_card_launches_k6_k5_and_matches_the_cpu(cuda, encoder):
    """MTL under both switches (instance norm), both heads: K6 and K5 on the
    card as often as MTLModel.kernel_launches says, the outputs against the
    CPU's plain versions (float32)."""
    from csof_tpu_torch.models.mtl import MTLConfig, MTLModel
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    cfg = MTLConfig(out_encoder_dims=(8, 16, 32), encoder=encoder, swin_heads=(2, 2, 2),
                    window=4, bottleneck_heads=2, dim_feedforward=32, reconstruction=True,
                    directional_field=True, norm="instance")
    cpu = MTLModel(cfg, 4, input_hw=(64, 64), generator=torch.Generator().manual_seed(0),
                   conv_impl="pallas", fused_norm_act=True).eval()
    for dec in (cpu.seg_decoder, cpu.rec_decoder):
        dec.Conv_0.weight.data.mul_(1e4)  # logits of a few units
    gpu = MTLModel(cfg, 4, input_hw=(64, 64), conv_impl="pallas", fused_norm_act=True)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda).eval()
    images = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 1).astype(np.float32))
    k5.launches = k6.launches = 0
    with torch.inference_mode():
        got = gpu(images.to(cuda))
        torch.cuda.synchronize()
        want = gpu.kernel_launches(64)
        assert (k5.launches, k6.launches) == (want["K5"], want["K6"])
        assert want == ({"K5": 14, "K6": 11} if encoder == "conv" else {"K5": 8, "K6": 8})
        ref = cpu(images)
    for k in ("seg_logits", "reconstruction", "directional_field"):
        _close(got[k], ref[k], (1e-3, 1e-3))


@pytest.mark.cuda
def test_small_temporal_and_deformable_on_the_card_match_the_cpu(cuda):
    """The temporal model under both switches (instance norm, 5 frames past
    a bus of 4): its K6 and K5 launches and outputs; the deformable layer
    (no kernel of the port), offsets of several pixels."""
    from csof_tpu_torch.models.deformable import DeformableTransformerLayer
    from csof_tpu_torch.models.temporal import TemporalVideoSegModel
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    kw = dict(out_encoder_dims=(8, 16, 32), d_model=32, num_heads=2, video_length=4,
              norm="instance", conv_impl="pallas", fused_norm_act=True)
    cpu = TemporalVideoSegModel(**kw, generator=torch.Generator().manual_seed(0)).eval()
    cpu.decoder.Conv_0.weight.data.mul_(1e4)
    gpu = TemporalVideoSegModel(**kw)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda).eval()
    video = torch.from_numpy(np.random.RandomState(2).rand(2, 5, 64, 64, 1).astype(np.float32))
    k5.launches = k6.launches = 0
    with torch.inference_mode():
        got = gpu(video.to(cuda))
        torch.cuda.synchronize()
        assert {"K5": k5.launches, "K6": k6.launches} == gpu.kernel_launches(64) == {
            "K5": 10, "K6": 7}
        _close(got, cpu(video), (1e-3, 1e-3))

    cpu = DeformableTransformerLayer(24, 32, 32, num_heads=4, num_points=4, dim_feedforward=64,
                                     generator=torch.Generator().manual_seed(3)).eval()
    cpu.DeformableAttention2D_0.offsets.bias.data.mul_(5.0)
    gpu = DeformableTransformerLayer(24, 32, 32, num_heads=4, num_points=4, dim_feedforward=64)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda).eval()
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(3, 16, 16, 24).astype(np.float32))
    v = torch.from_numpy(rng.randn(3, 12, 20, 32).astype(np.float32))
    with torch.inference_mode():
        _close(gpu(q.to(cuda), v.to(cuda)), cpu(q, v), (1e-4, 1e-4))


def _ddpm_step_on(device, seed=0):
    """One DDPM training step (K6 and its dx under pallas on a CUDA tensor)
    of a small denoiser on 2 x 64^2, the same weights and draws on any
    device: (loss, parameters after the step, their gradients)."""
    from csof_tpu_torch.models.diffusion import DDPM, DenoiserUNet, DiffusionConfig
    from csof_tpu_torch.profile_generative import adamw
    from csof_tpu_torch.training.generative import take_step

    cfg = DiffusionConfig(timesteps=50, features=(16, 32), time_dim=32)
    model = DenoiserUNet(cfg, torch.Generator().manual_seed(seed), "pallas").to(device)
    rng = np.random.RandomState(seed + 1)
    x = torch.from_numpy(rng.rand(2, 64, 64, 1).astype(np.float32)).to(device)
    t = torch.tensor([3, 41], device=device)
    noise = torch.from_numpy(rng.randn(2, 64, 64, 1).astype(np.float32)).to(device)
    loss = DDPM(model, cfg).loss(x, t=t, noise=noise)
    take_step(adamw(model.parameters(), lr=1e-3), loss)
    return (loss.item(), {n: p.detach().cpu() for n, p in model.named_parameters()},
            {n: p.grad.cpu() for n, p in model.named_parameters()})


@pytest.mark.cuda
def test_ddpm_training_step_on_the_card_equals_the_cpu(cuda):
    """The loss and every gradient of one DDPM step (4 K6, 3 dx) within 1e-4
    relative / 2e-3 of each leaf's largest entry (float32 sums in another
    order); the updated weights within AdamW's first step, lr x sign(g), of
    each other where a gradient is rounding alone."""
    from csof_tpu_torch.ops.kernels import conv as k6

    k6.launches = k6.bwd_launches = 0
    a, pa, ga = _ddpm_step_on(cuda)
    torch.cuda.synchronize()
    assert (k6.launches, k6.bwd_launches) == (4, 3)
    b, pb, gb = _ddpm_step_on(torch.device("cpu"))
    assert abs(a - b) <= 1e-4 * abs(b)
    for n in gb:
        _close(ga[n], gb[n], (2e-3 * float(gb[n].abs().max()) + 1e-6, 0.0))
        _close(pa[n], pb[n], (2.5e-3, 0.0))


@pytest.mark.cuda
def test_controlnet_step_on_the_card_equals_the_cpu_and_keeps_the_base(cuda):
    """One ControlNet step at 64^2 with a 128^2 hint (the antialiased resize,
    5 K6 and 2 dx under pallas: the step differentiates the control branch
    alone): the loss and every control gradient card vs CPU, the base
    parameters the same bits as before the step."""
    from csof_tpu_torch.models.diffusion import DDPM, DiffusionConfig
    from csof_tpu_torch.models.generative import ControlledDenoiserUNet, controlnet_param_labels
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.training.generative import (make_controlnet_optimizer,
                                                    make_controlnet_train_step)

    cfg = DiffusionConfig(timesteps=50, features=(16, 32), time_dim=32)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(2, 64, 64, 1).astype(np.float32))
    hint = torch.from_numpy(rng.rand(2, 128, 128, 3).astype(np.float32))
    noise = torch.from_numpy(rng.randn(2, 64, 64, 1).astype(np.float32))
    t = torch.tensor([7, 30])
    out = {}
    for device in (cuda, torch.device("cpu")):
        model = ControlledDenoiserUNet(cfg, 3, torch.Generator().manual_seed(4), "pallas")
        with torch.no_grad():
            for i in range(2):
                getattr(model, f"control_zero_{i}").weight.normal_(
                    0.0, 0.05, generator=torch.Generator().manual_seed(i))
        model = model.to(device)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_controlnet_train_step(model, DDPM(model, cfg), make_controlnet_optimizer(model))
        k6.launches = k6.bwd_launches = 0
        loss = step(x.to(device), hint.to(device), t=t.to(device), noise=noise.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert (k6.launches, k6.bwd_launches) == (5, 2) == (
                model.kernel_launches(64, backward=True)["K6"],
                model.kernel_launches(64, backward=True)["K6_dx"])
        labels = controlnet_param_labels(model)
        for n, p in model.named_parameters():
            if labels[n] == "frozen":
                assert torch.equal(p, before[n]), n
        out[device.type] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()
                                          if labels[n] == "control"})
    (a, ga), (b, gb) = out["cuda"], out["cpu"]
    assert abs(a - b) <= 1e-4 * abs(b)
    for n in gb:
        _close(ga[n], gb[n], (2e-3 * float(gb[n].abs().max()) + 1e-6, 0.0))


@pytest.mark.cuda
def test_event_files_are_the_same_bytes_from_card_or_cpu_tensors(cuda, tmp_path):
    """The TensorBoard writer takes tensors on either device: scalars, an
    overlay, a flow image, an attention map and a video from card tensors
    write the same file as from their CPU copies (a fixed clock)."""
    from csof_tpu_torch.utils.visualization import TensorBoardVisualizer

    rng = np.random.RandomState(6)
    data = {"image": rng.rand(24, 20).astype(np.float32), "seg": rng.randint(0, 4, (24, 20)),
            "flow": rng.randn(24, 20, 2).astype(np.float32),
            "attn": rng.rand(6, 5).astype(np.float32),
            "video": rng.rand(3, 24, 20).astype(np.float32)}
    files = []
    for device in (cuda, torch.device("cpu")):
        d = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        vis = TensorBoardVisualizer(tmp_path / device.type, clock=lambda: 1700000000.0)
        vis.log_scalars({"loss/train": torch.tensor(0.25, device=device), "loss/val": 0.5}, 1)
        vis.log_seg("seg", d["image"], d["seg"], 1)
        vis.log_flow("flow", d["flow"], 1)
        vis.log_attention("attn", d["image"], d["attn"], 2)
        vis.log_video("video", d["video"], 2)
        vis.close()
        (path,) = list((tmp_path / device.type).glob("events.out.tfevents.*"))
        files.append(path.read_bytes())
    assert files[0] == files[1] and len(files[0]) > 1000

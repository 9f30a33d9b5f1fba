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
    assert (k5.launches, k6.launches) == (14, 7) == tuple(gpu.kernel_launches(96).values())
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,window", [(20, 128, 128, 9), (3, 33, 70, 9), (2, 17, 9, 5),
                                          (1, 40, 41, 15)])
def test_ncc_kernel_matches_plain(cuda, n, h, w, window):
    from csof_tpu_torch.ops.kernels import ncc as k4

    rng = np.random.RandomState(8)
    i = rng.rand(n, h, w).astype(np.float32)
    i[:, : h // 3, : w // 3] = 0.4  # a constant region
    j = (0.7 * i + 0.3 * rng.rand(n, h, w)).astype(np.float32)
    i, j = torch.from_numpy(i).to(cuda), torch.from_numpy(j).to(cuda)
    before = k4.launches
    got = k4.ncc_map_cuda(i, j, window)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and bool(torch.isfinite(got).all())
    _close(got, k4.ncc_map_plain(i, j, window), (1e-4, 0))


@pytest.mark.cuda
def test_small_unet_train_step_on_the_card_matches_the_cpu(cuda):
    """The U-Net training loss, Dice statistics and every parameter
    gradient, float32, conv_impl="pallas": K6 forward and dx on the card
    against their plain versions on the CPU."""
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
    counts = gpu.kernel_launches(64, backward=True)
    assert (k6.launches, k6.bwd_launches) == (counts["K6"], counts["K6_dx"]) == (7, 6)
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

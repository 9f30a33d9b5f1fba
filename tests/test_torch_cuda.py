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
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
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

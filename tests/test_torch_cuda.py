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

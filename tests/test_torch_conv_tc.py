"""K6 on the tensor cores, the parts a CPU can check: the wrapper's weight
packing (the order the kernel's shared-memory descriptors read), the
numerics of the 3xTF32 route, emulated here in numpy, and K6 dw's split
plan (which pixels and channels each block of the weight gradient sums).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``). These
tests hold what surrounds it: that the packed weight holds exactly the
forward's weight and the dx's flipped weight, and that three TF32 products
(x_lo w_hi + x_hi w_lo + x_hi w_hi, with x_hi rounded to nearest) reach the
float32 tolerance K6 is held to on the card, where a single TF32 pass does
not.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_threads

from csof_tpu_torch.ops.kernels import conv as k6

torch_threads.pin()

#: K6's float32 tolerance against its plain version on the card (atol, rtol)
F32_TOL = (1e-4, 1e-4)


def _unpack(packed: torch.Tensor, co: int, ci: int, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``pack_weight``: (Co, Ci, 3, 3) float32, checking that
    the padding is zero."""
    v = packed.float()
    if dtype == torch.float32:
        v = v[:, :, 0] + v[:, :, 1]  # hi + lo
    nbk, nch, taps, groups, nb, epc = v.shape
    assert (taps, groups, epc) == (9, 2, 16 // torch.empty((), dtype=dtype).element_size())
    full = v.permute(0, 4, 1, 3, 5, 2).reshape(nbk * nb, nch * groups * epc, 3, 3)
    assert not full[co:].any() and not full[:, ci:].any()
    return full[:co, :ci]


@pytest.mark.parametrize("dx", [False, True], ids=["forward", "dx"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ci", [1, 13, 32])
@pytest.mark.parametrize("co", [5, 40, 64, 128])
def test_weight_packing_unpacks_to_the_weight_exactly(co, ci, dtype, dx):
    rng = np.random.RandomState(co * 1000 + ci)
    weight = torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32))
    packed, nb = k6.pack_weight(weight, dtype, dx)
    ref = k6.flipped_weight(weight) if dx else weight
    conv_co, conv_ci = ref.shape[:2]
    assert nb == k6.block_n(conv_co) and packed.shape[0] == -(-conv_co // nb)
    assert packed.dtype == dtype and packed.is_contiguous()
    got = _unpack(packed, conv_co, conv_ci, dtype)
    assert torch.equal(got, ref.to(dtype).float())
    if dtype == torch.float32:  # hi is tf32: its low 13 mantissa bits are zero
        hi = packed[:, :, 0].contiguous().view(torch.int32)
        assert not (hi & 0x1FFF).any()


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 -> tf32 to nearest, ties away from zero (cvt.rna.tf32.f32)."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a: np.ndarray) -> np.ndarray:
    """float32 as the tensor cores read a tf32 operand: its top 19 bits."""
    return (a.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _conv64(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    return F.conv2d(torch.from_numpy(x.astype(np.float64)),
                    torch.from_numpy(w.astype(np.float64)), padding=1).numpy()


def _unet_like(ci: int, co: int, seed: int):
    """An activation-like input (LeakyReLU of a normal, plus an offset) and a
    He-normal weight, as at the U-Net's 3x3 convs."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, ci, 24, 20)
    x = (np.where(x > 0, x, 0.01 * x) + 0.1).astype(np.float32)
    w = (rng.randn(co, ci, 3, 3) * np.sqrt(2.0 / (9 * ci))).astype(np.float32)
    return x, w


def test_package_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2**31 - 2**24, 4096).astype(np.uint32)  # finite, both signs below
    vals = np.concatenate([bits.view(np.float32), -bits.view(np.float32)])
    ties = (np.float32(1.0).view(np.uint32) + np.uint32(0x1000) * np.arange(1, 9, 2,
                                                                            dtype=np.uint32))
    vals = np.concatenate([vals, ties.view(np.float32), -ties.view(np.float32)])
    t = torch.from_numpy(vals)
    got = k6._tf32_hi(t, torch.empty_like(t)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _tf32_rna(vals).view(np.uint32))
    # a tie rounds away from zero: 1 + 2^-11 -> 1 + 2^-10
    assert got[-8] == np.float32(1 + 2**-10) and got[-4] == -np.float32(1 + 2**-10)


@pytest.mark.parametrize("ci,co", [(1, 32), (32, 32), (13, 40), (64, 128)])
def test_three_tf32_products_reach_float32_accuracy(ci, co):
    """x split on the card (hi rounded to nearest, lo = x - hi read as tf32),
    the weight split by the wrapper's packing; the three products summed in
    float64 against a float64 conv of the float32 inputs."""
    x, w = _unet_like(ci, co, seed=ci + co)
    x_hi = _tf32_rna(x)
    x_lo = _tf32_trunc(x - x_hi)
    packed, _ = k6.pack_weight(torch.from_numpy(w), torch.float32)
    hi_only = packed.clone()
    hi_only[:, :, 1] = 0
    w_hi = _unpack(hi_only, co, ci, torch.float32).numpy()
    w_lo = _tf32_trunc(w - w_hi)
    np.testing.assert_array_equal(w_hi, _tf32_rna(w))
    got = _conv64(x_lo, w_hi) + _conv64(x_hi, w_lo) + _conv64(x_hi, w_hi)
    ref = _conv64(x, w)
    err = np.abs(got - ref)
    # well inside the tolerance: a hundredth of it
    assert (err <= 1e-2 * (F32_TOL[0] + F32_TOL[1] * np.abs(ref))).all(), float(err.max())
    assert err.max() < 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("ci,co", [(32, 32), (64, 128)])
def test_a_single_tf32_pass_misses_the_float32_tolerance(ci, co):
    """The negative control: one TF32 product per tap (the inputs rounded to
    nearest) falls outside the tolerance that 3xTF32 meets."""
    x, w = _unet_like(ci, co, seed=7 * ci + co)
    got = _conv64(_tf32_rna(x), _tf32_rna(w))
    ref = _conv64(x, w)
    assert not np.allclose(got, ref, atol=F32_TOL[0], rtol=F32_TOL[1])


@pytest.mark.parametrize("kernel,train,ms,fp32_ms", [("K6", False, 2.352, 5.792),
                                                     ("K6", True, 2.940, 7.240),
                                                     ("K6_dx", True, 2.928, 7.212)])
def test_k6_bound_counts_float32_as_three_tf32_products(kernel, train, ms, fp32_ms):
    """K6's float32 bound: three TF32 products a multiply-add at the TF32
    tensor-core peak, with the FP32-core bound as a note beside it."""
    from csof_tpu_torch import bounds

    work = bounds.unet_train_work(kernel) if train else bounds.unet_forward_work(kernel, 4)
    assert work[1] == work[2] == 0.0
    got, by = bounds.bound_ms(*work)
    assert by == "operations" and got == pytest.approx(work[3] / bounds.TF32_TC_FLOPS * 1e3)
    assert got == pytest.approx(ms, abs=5e-4)
    note, note_by = bounds.fp32_cores_note(work)
    assert note_by == "operations" and note == pytest.approx(fp32_ms, abs=5e-4)


#: K6 dw's calls (N, Ci, Co, H, W): the two cells' folded planes (the 3-D
#: cell's z taps at 2 x 80 planes of 192x160 and 2 x 40 of 96x80, the 2-D
#: cell's 40 of 320x256 and 160x128), then Ci 1 and Ci off the channel
#: block, H and W off the chunk, N*H*W off the split, one pixel
WGRAD_CALLS = [(160, 1, 32, 192, 160), (160, 32, 32, 192, 160), (160, 64, 32, 192, 160),
               (80, 64, 64, 96, 80), (80, 128, 64, 96, 80), (40, 1, 32, 320, 256),
               (40, 32, 32, 320, 256), (40, 64, 32, 320, 256), (40, 64, 64, 160, 128),
               (40, 128, 64, 160, 128), (3, 13, 40, 17, 23), (2, 130, 5, 1, 33),
               (7, 20, 33, 19, 45), (1, 8, 130, 33, 1), (2, 1, 1, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,ci,co,h,w", WGRAD_CALLS)
def test_wgrad_plan_covers_every_pixel_and_channel_once(n, ci, co, h, w, dtype):
    """K6 dw's plan: the splits' runs of chunks partition the chunks, the
    chunks (2 rows x 32 columns of a plane) cover every pixel of the N
    planes exactly once, the channel blocks every (Co, Ci) pair once, the
    grid fits the card's 132 SMs where the blocks allow, and the scratch
    is one float32 (Co, Ci, 3, 3) partial a split. The chunk's shape is
    the kernel's own (``kGTR`` x ``kGTW`` in ``csrc/conv3x3_wgrad.cu``)."""
    src = (Path(k6.__file__).parents[2] / "csrc" / "conv3x3_wgrad.cu").read_text()
    tile = {k: int(v) for k, v in re.findall(r"constexpr int (kGTR|kGTW) = (\d+);", src)}
    assert (tile["kGTR"], tile["kGTW"]) == k6.WGRAD_TILE
    plan = k6.wgrad_plan(n, ci, co, h, w, dtype)
    runs = [plan.split_chunks(s) for s in range(plan.splits)]
    assert runs[0].start == 0 and runs[-1].stop == plan.chunks
    assert all(a.stop == b.start for a, b in zip(runs, runs[1:]))
    assert all(len(r) >= plan.chunks // plan.splits for r in runs)
    rows, cols = k6.WGRAD_TILE
    plane, y0, x0 = plan.chunk_origin(np.arange(plan.chunks))
    cover = np.zeros((n, plan.row_tiles * rows, plan.col_tiles * cols), np.int32)
    for dy in range(rows):
        for dx in range(cols):
            np.add.at(cover, (plane, y0 + dy, x0 + dx), 1)
    assert (cover == 1).all()
    assert plan.row_tiles * rows - h < rows and plan.col_tiles * cols - w < cols
    assert plan.channels == (8 if ci <= 8 else 16)
    assert plan.co_block == (32 if dtype == torch.float32 and co <= 32 else 64)
    pairs = np.zeros((co, ci), np.int32)
    for c0 in range(0, ci, plan.channels):
        for o0 in range(0, co, plan.co_block):
            pairs[o0:o0 + plan.co_block, c0:c0 + plan.channels] += 1
    assert (pairs == 1).all()
    assert plan.tiles == -(-ci // plan.channels) * -(-co // plan.co_block)
    assert 1 <= plan.splits <= plan.chunks and plan.tiles * plan.splits <= max(132, plan.tiles)
    assert plan.scratch == plan.splits * co * ci * 9

"""The FLOP counts and the frozen bounds against values worked out by hand."""

import pytest

from portbench.yardstick import bounds, flops


def test_unet_step_flops_is_three_forwards_of_its_convs():
    # a 2-pool U-Net (base 4: 4, 8, 16 features) at 8x8, batch 1, 2 classes,
    # summed by hand: two 3x3 convs a stage, a 2x2 transposed conv, two 3x3
    # convs and a 1x1 head a decoder level; the backward adds a weight
    # gradient of every conv and a data gradient of all but the first
    px = [64, 16, 4]
    enc = [2 * 9 * 1 * 4 * px[0] + 2 * 9 * 4 * 4 * px[0],
           2 * 9 * 4 * 8 * px[1] + 2 * 9 * 8 * 8 * px[1],
           2 * 9 * 8 * 16 * px[2] + 2 * 9 * 16 * 16 * px[2]]
    dec = [2 * 4 * 16 * 8 * px[2] + 2 * 9 * 16 * 8 * px[1] + 2 * 9 * 8 * 8 * px[1]
           + 2 * 8 * 2 * px[1],
           2 * 4 * 8 * 4 * px[1] + 2 * 9 * 8 * 4 * px[0] + 2 * 9 * 4 * 4 * px[0]
           + 2 * 4 * 2 * px[0]]
    forward = sum(enc) + sum(dec)
    first = 2 * 9 * 1 * 4 * px[0]  # the data needs no gradient
    assert flops.unet_step_flops(4, 480, 2, 2, 1, (8, 8)) == 3 * forward - first


def test_segflow_flops_scale_with_slices_and_count_the_correlation():
    cfg = dict(out_encoder_dims=[8, 16, 32], d_model=32, bottleneck_heads=4, dim_feedforward=64,
               corr_radius=[4, 4, 4], corr_stride=[2, 1, 1])
    items = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()))
    one = flops.segflow_forward_flops(items, 4, 1, 3, 32)
    assert flops.segflow_forward_flops(items, 4, 2, 3, 32) == 2 * one
    corr = sum(2 * 81 * c * (32 >> lv) ** 2 * (3 if lv == 2 else 2)
               for lv, c in enumerate((8, 16, 32)))
    assert one > corr > 0


def test_bounds_by_hand():
    # K6 at 40 x 32 x 320 x 256, 32 -> 32 channels, float32 with bias:
    # 3xTF32 operations bound it
    px = 40 * 320 * 256
    work = bounds.conv3x3_work(40, 320, 256, 32, 32, 4)
    assert work == (px * 64 * 4 + (9 * 32 + 1) * 32 * 4, 0.0, 0.0, 3 * 2 * 9 * 32 * 32 * px)
    assert bounds.bound_s(*work) == pytest.approx(3 * 2 * 9 * 32 * 32 * px / 495e12)
    # K1 in bf16 at 8 x 32 x 128 x 128: bytes bound it
    b1 = bounds.corr_work("K1", 8, 32, 128, 128, 2)
    assert b1[0] == (2 * 8 * 32 * 16384 + 8 * 81 * 16384) * 2
    assert bounds.bound_s(*b1) == pytest.approx(b1[0] / 3.35e12)
    assert bounds.MFU_PEAK_FLOPS == {"bfloat16": 989e12, "float32": 165e12}


def test_frozen_bounds_agree_with_the_ports():
    from csof_tpu_torch import bounds as port

    for args in ((40, 320, 256, 32, 32, 4), (8, 64, 64, 64, 64, 2)):
        assert bounds.conv3x3_work(*args) == port.conv3x3_work(*args)
    for kernel in ("K1", "K3"):
        for item in (2, 4):
            assert bounds.corr_work(kernel, 8, 64, 64, 64, item) == port.corr_work(
                kernel, 8, 64, 64, 64, item)

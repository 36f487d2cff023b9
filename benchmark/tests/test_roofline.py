"""The yardstick's counts, pinned."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import roofline


def test_forward_flops():
    assert roofline.forward_flops("ir_50", 256) == pytest.approx(3.2304e12, rel=1e-4)
    assert roofline.forward_flops("ir_100", 256) == pytest.approx(6.1899e12, rel=1e-4)
    assert roofline.forward_flops("ir_50", 512) == 2 * roofline.forward_flops("ir_50", 256)


def test_forward_flops_equal_the_program_roofline():
    from crfr_torch.bench.roofline import ir_layer_bounds, summarize

    for depth in ("50", "100"):
        want = summarize(ir_layer_bounds(depth, 128)).ideal_flops
        assert roofline.forward_flops(f"ir_{depth}", 128) == pytest.approx(want, rel=1e-12)


def test_train_flops_add_the_head():
    fwd = roofline.forward_flops("ir_50", 512)
    assert roofline.train_flops("ir_50", 512, 10572) == 3 * fwd + 6.0 * 512 * 512 * 10572


def test_kernel1_bytes_and_bound():
    ops, byts = roofline.degrade_work_int(256, 112, 16)
    assert byts == 256 * 112 * 112 * 3 * 3                     # 28.9 MB: uint8 in, bf16 out
    assert byts == pytest.approx(28.9e6, rel=1e-3)
    assert roofline.bound_s(ops, byts) == pytest.approx(byts / 3.35e12)


def test_per_image_lows_count_each_image_and_its_low():
    one = roofline.degrade_work(112, [16])
    ops, byts = roofline.degrade_work(112, [16] * 4)
    assert byts == 4 * one[1] == 4 * (112 * 112 * 3 * 3 + 4)
    assert ops == 4 * one[0]
    assert ops == pytest.approx(roofline.degrade_work_int(4, 112, 16)[0])
    # an identity "degrade" needs one tap a row each way; a deep one many
    assert roofline.degrade_work(112, [112])[0] < roofline.degrade_work(112, [8])[0]
    assert roofline.degrade_work(112, np.arange(8, 113))[1] == 105 * (112 * 112 * 9 + 4)

"""crfr_torch.bench.roofline against crfr.bench.roofline.

Each layer's name, FLOPs and bytes are facts of the architecture, equal to
crfr's for IR-18 and IR-50; the padded FLOPs and the bound follow the H100
rule (K to the wgmma's 16 and N to 8 in bf16, peaks 989.4 TFLOP/s and
3.35 TB/s), recomputed here; ``train_step_bounds`` counts one BN and one
PReLU as its docstring says, worked by hand; and ``xprof_check``'s
``train_roofline`` reads a profile against them."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import math

import pytest

from crfr.bench import roofline as ref
from crfr_torch.bench import roofline as rl


@pytest.mark.parametrize("depth", ["18", "50"])
@pytest.mark.parametrize("batch,size", [(256, 112), (8, 32)])
def test_layers_are_crfrs(depth, batch, size):
    want = ref.ir_layer_bounds(depth, batch, size)
    got = rl.ir_layer_bounds(depth, batch, size)
    assert [(g.name, g.flops, g.bytes) for g in got] == [(w.name, w.flops, w.bytes) for w in want]
    s, r = rl.summarize(got), ref.summarize(want)
    assert (s.ideal_flops, s.bytes) == (r.ideal_flops, r.bytes)


def _k_n(name, size):
    """K and N of a layer's GEMM, from its name (IR's layout)."""
    if name == "input":
        return 27, 64
    if name == "fc":
        return 512 * (size // 16) ** 2, 512
    ch, _, kind = name.split(".")
    ch = int(ch)
    cin = {64: 64, 128: 64, 256: 128, 512: 256}[ch]
    if kind == "c1":
        return 9 * (cin if name.split(".")[1] == "0" else ch), ch
    if kind == "c2":
        return 9 * ch, ch
    return cin, ch                                     # the 1×1 shortcut


@pytest.mark.parametrize("depth", ["18", "50"])
def test_padding_and_bound_follow_the_h100_rule(depth):
    for lb in rl.ir_layer_bounds(depth, 256, 112):
        k, n = _k_n(lb.name, 112)
        assert lb.flops % (2 * k * n) == 0
        m = lb.flops / (2 * k * n)
        padded = 2 * m * math.ceil(k / 16) * 16 * math.ceil(n / 8) * 8
        assert lb.flops_padded == padded
        t_ops, t_mem = padded / 989.4e12, lb.bytes / 3.35e12
        assert lb.bound_s == pytest.approx(max(t_ops, t_mem), rel=1e-12)
        assert lb.limiter == ("hbm" if t_mem > t_ops else "tensor")
    first = rl.ir_layer_bounds(depth, 256, 112)[0]
    assert first.flops_padded / first.flops == pytest.approx(32 / 27)   # K = 27 runs as 32


def test_train_step_bounds_of_one_bn_and_one_prelu_by_hand():
    """IR-18 at batch 4, 32 px, bf16: the stem's BN and PReLU act on
    4·32·32·64 elements of 2 bytes; BN forward moves x in and y out, BN
    backward dy and x in and dx out; PReLU likewise; four float32 vectors
    of 64 channels beside each."""
    ops = rl.train_step_bounds("18", 4, 32, "bfloat16")
    by = {(o.name, o.pass_): o for o in ops}
    n = 4 * 32 * 32 * 64
    vec = 4 * 64 * 4
    assert by[("input_bn", "forward")].bytes == 2 * n * 2 + vec
    assert by[("input_bn", "backward")].bytes == 3 * n * 2 + vec
    assert by[("input_prelu", "forward")].bytes == 2 * n * 2 + vec
    assert by[("input_prelu", "backward")].bytes == 3 * n * 2 + vec
    bn = by[("input_bn", "backward")]
    assert bn.group == "batch_norm" and bn.limiter == "hbm"
    assert bn.bound_s == pytest.approx(bn.bytes / 3.35e12)
    # a stage's first unit: bn0 before the stride on cin, bn2 after it on ch
    # (stage 64's first unit already halved 32 px to 16)
    n0 = 4 * 16 * 16 * 64
    n2 = 4 * 8 * 8 * 128
    assert by[("128.0.bn0", "forward")].bytes == 2 * n0 * 2 + vec
    assert by[("128.0.bn2", "forward")].bytes == 2 * n2 * 2 + 4 * 128 * 4
    assert by[("128.0.sc_bn", "forward")].bytes == 2 * n2 * 2 + 4 * 128 * 4
    # each conv: forward, dgrad and wgrad at the forward's padded FLOPs
    fwd = {lb.name: lb for lb in rl.ir_layer_bounds("18", 4, 32)}
    for name in ("input", "64.0.c1", "128.0.c2", "256.0.sc"):
        passes = [o for o in ops if o.name == name]
        assert [o.pass_ for o in passes] == ["forward", "dgrad", "wgrad"]
        assert all(o.flops == fwd[name].flops_padded for o in passes)
        assert passes[0].bytes == fwd[name].bytes
    counts = {g: sum(o.group == g for o in ops)
              for g in ("conv_forward", "conv_backward", "batch_norm", "prelu")}
    # IR-18: 21 convs (input, 16 3×3, 4 shortcuts: every stage's first unit
    # strides); BN: input, 8 × 2, 4 shortcuts, out; PReLU: input, 8
    assert counts == {"conv_forward": 21, "conv_backward": 42, "batch_norm": 2 * 22,
                      "prelu": 2 * 9}
    groups = rl.group_bounds(ops)
    assert groups["batch_norm"] == pytest.approx(sum(o.bound_s for o in ops
                                                     if o.group == "batch_norm"))


def test_float32_steps_are_tf32s():
    lb = rl.ir_layer_bounds("18", 8, 32, dtype="float32")[0]
    assert lb.flops_padded == 2 * 8 * 32 * 32 * 32 * 64          # K 27 → 32 (steps of 8)
    assert lb.bytes == 4 * (8 * 32 * 32 * 3 + 8 * 32 * 32 * 64 + 27 * 64)
    with pytest.raises(ValueError, match="dtype"):
        rl.ir_layer_bounds("18", 8, 32, dtype="float16")


def test_xprof_train_roofline_keys():
    from crfr_torch.bench.xprof_check import train_roofline

    r = {"wall_ms": 90.0, "device_busy_ms": 88.0,
         "group_ms": {"conv_forward": 10.0, "conv_backward": 20.0, "batch_norm": 30.0,
                      "prelu": 12.0, "reduce": 4.0}}
    out = train_roofline(r, "ir_50", 512, 112)
    fwd = rl.summarize(rl.ir_layer_bounds("50", 512, 112)).bound_s * 1e3
    assert out["fwd_conv_bound_ms"] == pytest.approx(fwd)
    assert out["train_conv_bound_3x_fwd_ms"] == pytest.approx(3 * fwd)
    assert out["conv_over_3x_bound"] == pytest.approx(30.0 / (3 * fwd))
    assert out["dispatch_gap_ms"] == pytest.approx(2.0)
    groups = rl.group_bounds(rl.train_step_bounds("50", 512, 112))
    assert out["group_bound_ms"]["batch_norm"] == pytest.approx(1e3 * groups["batch_norm"])
    assert out["group_over_bound"]["batch_norm"] == pytest.approx(
        30.0 / (1e3 * groups["batch_norm"]))
    assert out["group_over_bound"]["prelu_and_reduce"] == pytest.approx(
        16.0 / (1e3 * groups["prelu"]))


def test_report_names_the_card_and_its_peaks():
    text = rl.report("50", 256, 112, measured_ms=13.0, train=True)
    assert "NVIDIA H100 80GB HBM3" in text and "989.4 TFLOP/s" in text
    assert "batch_norm" in text and "% of attainable" in text

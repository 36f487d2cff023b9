"""The port's CUDA kernels against their plain versions, on the card: the
preprocessing kernel (with an int low, a low per image at its plan's
extremes and in a call that does not synchronize, or a resize, the SR
probe's ↓ among them), ``bank_tilemax`` with the fused gallery path,
and the one launch of the preprocessing kernel in a train step, an SR
train step, a hallucinated extract batch, and a residual-KD step on each
input path (a fixed low, a low per batch, a low per image, a frozen G, G
trained jointly), the teacher's KD term on the trainer included. The int8
convolution (``models.quant``, ``torch._int_mm`` on the card): ``QuantConv``
on the card equal to the same module on CPU tensors (the s32 sums bit for
bit) at each of IR-50's 17 conv shapes, the operand padding at M ≤ 16,
K = 27 and N off 8, the dtype it emits under autocast, and the one launch
of the preprocessing kernel in an int8 embed batch. The resize at the
detector's photo sizes (pyramid levels of 640×480 and 1280×720 photos in
shorter bands and by the two-pass plan, a 400 px box's crops), the two-pass
plan equal to the bands bit for bit where both fit; the ragged forms (every
level of a photo's pyramid in one launch, a stage's crops in one launch)
against their plain versions and, bit for bit, against a launch a level or
a crop; and the MTCNN cascade on the card equal to the same cascade on CPU
tensors, with three launches of the ragged forms a photo. The train-mode
BatchNorm (``ops.batch_norm``) against its plain path on the CPU at each
of IR-50's BN shapes in bf16 and float32 and at B=512's stage-1 shape, bit
for bit from call to call and under a remat recomputation (statistics
left), and the IR-50 and MobileFaceNet train steps with every BatchNorm2d
through its four kernels. The streamed margin CE through ``Trainer._loss``
at the train-ir100-ms1m cell's widths (B=512, D=512, 85,742 classes in
blocks of 8,192) against the benchmark's plain reference, and the same
with TF32 in the program's products failing that comparison.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor crfr, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

from crfr_torch.device import strict_fp32
from crfr_torch.ops import _build
from crfr_torch.ops import bank_scan as bs
from crfr_torch.ops import batch_norm as bn_op
from crfr_torch.ops import fused_preprocess as fp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with strict_fp32():
        yield torch.device("cuda")


def _pixels(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("b", [1, 64, 257])
@pytest.mark.parametrize("low", [16, 15, 8])
@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_degrade_kernel_matches_plain(cuda, mode, in_dtype, out_dtype, atol, low, b):
    x = _pixels((b, 112, 112, 3), in_dtype, cuda, seed=b + low)
    before = fp.fused_degrade_normalize.launches
    got = fp.fused_degrade_normalize(x, low, mode, out_dtype)
    want = fp.fused_degrade_normalize_reference(x, low, mode, out_dtype)
    torch.cuda.synchronize()
    assert fp.fused_degrade_normalize.launches == before + 1
    assert got.dtype == out_dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("rows", [112, 57, 28, 16, 7, 1])
@pytest.mark.parametrize("low,mode", [(16, "pil"), (15, "cv2")])
def test_degrade_kernel_any_band_height(cuda, low, mode, rows):
    """Bands of any number of output rows, a last band cut short included."""
    x = _pixels((5, 112, 112, 3), torch.uint8, cuda, seed=rows)
    key = fp.operator_key(112, 112, low, mode)
    got = fp._launch(x, key, 112, 112, torch.float32, "t", rows=rows)
    want = fp.fused_degrade_normalize_reference(x, low, mode, torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,out_hw", [((8, 160, 140, 3), (112, 112)),
                                          ((5, 37, 200, 3), (112, 96)),
                                          ((3, 64, 50, 3), (29, 31))])
def test_resize_kernel_matches_plain(cuda, shape, out_hw, in_dtype):
    """160x140 rows are 420 bytes of uint8 (4-byte loads), 37x200 rows 600
    (8-byte loads); a 29x31x3 output row is 93 elements (one per store)."""
    x = _pixels(shape, in_dtype, cuda)
    before = fp.fused_resize_normalize.launches
    got = fp.fused_resize_normalize(x, out_hw, "pil", torch.float32)
    want = fp.fused_resize_normalize_reference(x, out_hw, "pil", torch.float32)
    torch.cuda.synchronize()
    assert fp.fused_resize_normalize.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b", [1, 64, 513])
@pytest.mark.parametrize("low", [14, 16, 8])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
def test_resize_kernel_at_the_sr_shapes(cuda, in_dtype, low, b):
    """112² → the probe sizes of scales 8, 7 and 14, float32 out: the SR
    trainer's and the hallucinated extract's ↓."""
    x = _pixels((b, 112, 112, 3), in_dtype, cuda, seed=b + low)
    before = fp.fused_resize_normalize.launches
    got = fp.fused_resize_normalize(x, (low, low), "pil", torch.float32)
    want = fp.fused_resize_normalize_reference(x, (low, low), "pil", torch.float32)
    torch.cuda.synchronize()
    assert fp.fused_resize_normalize.launches == before + 1
    assert got.shape == (b, low, low, 3) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _counts():
    return (fp.fused_resize_normalize.launches, fp.fused_degrade_normalize.launches,
            fp.fused_degrade_normalize.lows_launches)


def test_sr_train_step_launches_the_resize_once(cuda):
    """One SR step (scale 8, 16 priors, batch 8 at 112²): one launch of the
    resize form and none of the degrade forms; finite losses."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.sr_loop import SRTrainer

    tr = SRTrainer(get_config("casia_arcface", ["train.log_every=1000"]), device=cuda)
    x = _pixels((8, 112, 112, 3), torch.uint8, cuda)
    tr.train_step(x)
    before = _counts()
    m = tr.train_step(x)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
    assert torch.isfinite(m["g_loss"]) and torch.isfinite(m["d_loss"])


def test_hallucinated_extract_launches_the_resize_once(cuda):
    """A hallucinated extract batch: one resize launch, no degrade."""
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.models.irse import build_backbone
    from crfr_torch.models.sr import build_hallucinator
    from crfr_torch.train.sr_loop import sr_apply_from_state

    model = build_backbone("ir_18").to(cuda).eval()
    f = make_extract_fn(model, degrade_to=14, device=cuda,
                        sr_apply=sr_apply_from_state(build_hallucinator(8).to(cuda)))
    x = _pixels((16, 112, 112, 3), torch.uint8, cuda)
    before = _counts()
    emb = f(x)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
    assert emb.shape == (16, 512) and torch.isfinite(emb).all()


@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c", [1, 4])
def test_kernel_other_channel_counts(cuda, c, out_dtype, atol):
    x = _pixels((9, 112, 112, c), torch.uint8, cuda, seed=c)
    got = fp.fused_degrade_normalize(x, 16, "pil", out_dtype)
    want = fp.fused_degrade_normalize_reference(x, 16, "pil", out_dtype)
    r = fp.fused_resize_normalize(x, (96, 80), "cv2", out_dtype)
    r_want = fp.fused_resize_normalize_reference(x, (96, 80), "cv2", out_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    torch.testing.assert_close(r.float(), r_want.float(), atol=atol, rtol=0)


def test_kernel_unaligned_input(cuda):
    """An input view that starts one byte off a 16-byte boundary takes
    one-byte loads; the results still equal the plain version."""
    big = _pixels((2 * 112 * 112 * 3 + 1,), torch.uint8, cuda)
    x = big[1:].view(2, 112, 112, 3)
    assert x.data_ptr() % 16 and x.is_contiguous()
    got = fp.fused_degrade_normalize(x, 16, "pil", torch.float32)
    torch.cuda.synchronize()
    want = fp.fused_degrade_normalize_reference(x.clone(), 16, "pil", torch.float32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_preprocess_never_takes_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel; the plain versions are for the CPU."""
    x = _pixels((4, 112, 112, 3), torch.uint8, cuda)
    y = _pixels((4, 160, 140, 3), torch.uint8, cuda)
    want = fp.fused_degrade_normalize_reference(x, 16, "pil", torch.float32)
    want_r = fp.fused_resize_normalize_reference(y, (112, 112), "pil", torch.float32)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("_reference", "fused_degrade_normalize_reference",
                 "fused_resize_normalize_reference"):
        monkeypatch.setattr(fp, name, refuse)
    got = fp.fused_degrade_normalize(x, 16, "pil", torch.float32)
    got_r = fp.fused_resize_normalize(y, (112, 112), "pil", torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    torch.testing.assert_close(got_r, want_r, atol=1e-4, rtol=0)


def test_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError, match="uint8 or float32"):
        fp.fused_degrade_normalize(_pixels((1, 16, 16, 3), torch.int32, cuda), 8)
    with pytest.raises(ValueError, match="contiguous"):
        x = _pixels((1, 16, 16, 6), torch.uint8, cuda)[..., ::2]
        fp.fused_degrade_normalize(x, 8)
    # a degrade of 2048² to 8 px reads ~1,000 input rows of 6 KB for one output
    # row: 6 MB, beyond any CTA's share, and a degrade has no two-pass plan
    before = fp.fused_degrade_normalize.launches
    with pytest.raises(ValueError, match="limit"):
        fp.fused_degrade_normalize(_pixels((1, 2048, 2048, 3), torch.uint8, cuda), 8)
    with pytest.raises(ValueError, match="two-pass plan is a resize's"):
        fp._launch(_pixels((1, 64, 64, 3), torch.uint8, cuda), fp.operator_key(64, 64, 8, "pil"),
                   64, 64, torch.float32, "t", rows=fp.TWO_PASS)
    assert fp.fused_degrade_normalize.launches == before


def test_preprocess_launch_plan(cuda):
    """The main case: one CTA per band of rows of each image, two CTAs' worth
    of registers on an SM, the plan inside the device's shared memory."""
    info = fp.resample_info((256, 112, 112, 3), 16, "pil", torch.uint8, torch.bfloat16)
    rows = fp.DEGRADE_ROWS
    assert info["rows"] == rows and info["ctas"] == 256 * -(-112 // rows)
    assert 2 * info["registers"] * info["threads"] <= 65536
    assert 0 < info["smem_bytes"] <= info["smem_limit"]
    assert (info["span"], info["in_span"]) == fp.band_spans(fp.operator_key(112, 112, 16, "pil"),
                                                            rows)
    resize = fp.resample_info((256, 160, 140, 3), (112, 112))
    assert 0 < resize["smem_bytes"] <= resize["smem_limit"]
    assert resize["span"] == resize["in_span"] > 0
    assert resize["rows"] == fp.RESIZE_ROWS and resize["plan"] == "bands"
    # a band's 13 rows of 20000 x 3 f32 would need 3 MB: the two-pass plan
    wide = fp.resample_info((1, 64, 64, 3), (112, 20000))
    assert wide["plan"] == "two_pass" and wide["smem_bytes"] == 0
    assert wide["scratch_bytes"] == 4 * 64 * 20000 * 3 and wide["span"] is None
    with pytest.raises(RuntimeError, match="CUDA error"):
        fp.resample_info((1, 2048, 2048, 3), 8)


def _lows(b, pattern, device, seed=0):
    if pattern == "random":
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(8, 113, (b,), generator=g, device=device, dtype=torch.int32)
    low = 37 if pattern == "equal" else pattern
    return torch.full((b,), low, dtype=torch.int32, device=device)


def _check_lows(x, lows, mode, out_dtype, atol):
    """Equal to the plain version within ``atol`` and, bit for bit, to the
    int form's launch on each low's images."""
    before = fp.fused_degrade_normalize.lows_launches
    got = fp.fused_degrade_normalize(x, lows, mode, out_dtype, lows=(8, 112))
    want = fp.fused_degrade_normalize_reference(x, lows, mode, out_dtype, lows=(8, 112))
    torch.cuda.synchronize()
    assert fp.fused_degrade_normalize.lows_launches == before + 1
    assert got.dtype == out_dtype and got.is_contiguous() and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    for low in set(lows.tolist()):
        sel = (lows == low).nonzero()[:, 0]
        one = fp.fused_degrade_normalize(x[sel].contiguous(), low, mode, out_dtype)
        assert torch.equal(one, got[sel]), low


@pytest.mark.parametrize("pattern", ["random", "equal", 8, 15, 16, 112])
@pytest.mark.parametrize("b", [1, 64, 513])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("in_dtype,out_dtype,atol", [(torch.uint8, torch.bfloat16, 2e-2),
                                                     (torch.float32, torch.float32, 1e-4)])
@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_lows_kernel_matches_plain_and_int_form(cuda, mode, in_dtype, out_dtype, atol, c, b,
                                                pattern):
    """A low per image, 8-112 at 112²: random lows, all equal, each of 8, 15,
    16, 112 alone (112 is the identity's up-and-down, in the same path)."""
    x = _pixels((b, 112, 112, c), in_dtype, cuda, seed=b + c)
    _check_lows(x, _lows(b, pattern, cuda, seed=b), mode, out_dtype, atol)


@pytest.mark.parametrize("offset", [1, 16])
def test_lows_kernel_input_view_off_alignment(cuda, offset):
    """Views that start 1 and 16 bytes into their allocation (uint8): the
    staging copies their unaligned ends byte by byte."""
    n = 64 * 112 * 112 * 3
    x = _pixels((n + offset,), torch.uint8, cuda)[offset:].view(64, 112, 112, 3)
    assert x.is_contiguous() and x.data_ptr() % 32 != 0
    _check_lows(x, _lows(64, "random", cuda, seed=offset), "pil", torch.float32, 1e-4)


def test_lows_kernel_marks_a_low_outside_its_table(cuda):
    """The wrapper does not read the lows back; an image whose low lies
    outside the table comes out NaN, the others as usual."""
    x = _pixels((3, 112, 112, 3), torch.uint8, cuda)
    lows = torch.tensor([16, 7, 113], dtype=torch.int32, device=cuda)
    got = fp.fused_degrade_normalize(x, lows, "pil", torch.float32, lows=(8, 112))
    torch.cuda.synchronize()
    assert torch.isnan(got[1:]).all()
    want = fp.fused_degrade_normalize(x[:1].contiguous(), 16, "pil", torch.float32)
    assert torch.equal(got[:1], want)


def test_lows_kernel_never_takes_the_plain_version(cuda, monkeypatch):
    x = _pixels((8, 112, 112, 3), torch.uint8, cuda)
    lows = _lows(8, "random", cuda)
    want = fp.fused_degrade_normalize_reference(x, lows, "pil", torch.float32, lows=(8, 112))

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("_reference", "fused_degrade_normalize_reference", "_table"):
        monkeypatch.setattr(fp, name, refuse)
    got = fp.fused_degrade_normalize(x, lows, "pil", torch.float32, lows=(8, 112))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_lows_launch_plan(cuda):
    """The plan for lows 8-112: each low at its own band height
    (``lows_plan`` with the device's shared memory and the kernel's CTAs an
    SM), B times the most bands of any low in CTAs, as many CTAs an SM by
    the occupancy API as the budget planned (two for uint8 in, one for
    float32 pil in), within the device's shared memory; the kernel takes
    every low's records as the host laid them out."""
    lows = _lows(512, "random", cuda)
    device_smem, ctas_per_sm = fp._lows_device(torch.device(cuda))
    assert ctas_per_sm == 2
    for in_dtype, out_dtype in ((torch.uint8, torch.bfloat16), (torch.float32, torch.float32)):
        for mode in ("pil", "cv2"):
            info = fp.resample_info((512, 112, 112, 3), lows, mode, in_dtype, out_dtype,
                                    lows=(8, 112))
            plan = fp.lows_plan(fp.lows_key(112, (8, 112), mode), 3,
                                1 if in_dtype == torch.uint8 else 4, device_smem, ctas_per_sm)
            planned = 1 if (mode, in_dtype) == ("pil", torch.float32) else 2
            assert plan["budget"] == fp.lows_budget(device_smem, planned)
            assert info["lows"] == [8, 112] and info["rows_by_low"] == list(plan["rows"])
            assert info["smem_bytes"] == plan["smem"] <= info["smem_budget"] == plan["budget"]
            assert info["ctas"] == 512 * plan["bands"] and info["bands"] == plan["bands"]
            assert info["rows"] == min(plan["rows"]) and info["ctas_per_sm"] >= planned
            # every low at one height: the layout each low takes, larger
            one = fp.resample_info((512, 112, 112, 3), lows, mode, in_dtype, out_dtype, rows=28,
                                   lows=(8, 112))
            assert one["rows_by_low"] == [28] * 105 and one["ctas"] == 512 * 4


@pytest.mark.parametrize("pattern", ["all112", "halves"])
@pytest.mark.parametrize("in_dtype,out_dtype,atol", [(torch.uint8, torch.bfloat16, 2e-2),
                                                     (torch.float32, torch.float32, 1e-4)])
def test_lows_plan_extremes(cuda, in_dtype, out_dtype, atol, pattern):
    """B=512 at the plan's extremes: every low 112 (bands of 28 rows, every
    CTA at work), and half at 8 (whole images) and half at 112,
    interleaved."""
    x = _pixels((512, 112, 112, 3), in_dtype, cuda, seed=5)
    lows = (torch.full((512,), 112, dtype=torch.int32, device=cuda) if pattern == "all112"
            else torch.tensor([8, 112] * 256, dtype=torch.int32, device=cuda))
    _check_lows(x, lows, "pil", out_dtype, atol)


def test_lows_kernel_does_not_synchronize(cuda):
    """A call with lows on the card (after the first, which fills the
    plan's caches) neither reads them back nor waits on the card."""
    x = _pixels((512, 112, 112, 3), torch.uint8, cuda)
    lows = _lows(512, "random", cuda, seed=3)
    want = fp.fused_degrade_normalize(x, lows, "pil", torch.bfloat16, lows=(8, 112))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fp.fused_degrade_normalize(x, lows, "pil", torch.bfloat16, lows=(8, 112))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_train_step_launches_the_kernel_once(cuda):
    """One train step of a small config on the card: one launch of the
    preprocessing kernel with a low per image and none of the int form,
    finite loss."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.loop import Trainer

    cfg = get_config("casia_arcface", ["model.backbone=ir_18", "data.num_classes=32",
                                       "train.batch_size=32"])
    tr = Trainer(cfg, device=cuda)
    x = _pixels((32, 112, 112, 3), torch.uint8, cuda)
    y = torch.arange(32, device=cuda)
    before = (fp.fused_degrade_normalize.launches, fp.fused_degrade_normalize.lows_launches)
    m = tr.train_step(x, y)
    torch.cuda.synchronize()
    after = (fp.fused_degrade_normalize.launches, fp.fused_degrade_normalize.lows_launches)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


@pytest.mark.parametrize("path,want", [
    ("fixed_low", (0, 1, 0)), ("low_per_batch", (0, 0, 1)), ("low_per_image", (0, 0, 1)),
    ("frozen_g", (1, 0, 0)), ("joint_g", (1, 0, 0))])
def test_kd_step_launches_the_kernel_once(cuda, path, want):
    """One residual-KD step of a small config on the card: one launch of
    the kernel's form for the path (resize, int degrade, degrade with a
    low per image), finite losses, every student parameter moved."""
    from crfr_torch.configs import get_config
    from crfr_torch.models.sr import build_hallucinator
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import sr_apply_from_state

    ov = {"fixed_low": ["data.degrade_min=16", "data.degrade_max=16"],
          "low_per_batch": ["data.per_sample_degrade=false"]}.get(path, [])
    cfg = get_config("casia_arcface", ["model.backbone=ir_18", "data.num_classes=32",
                                       "train.batch_size=16", "loss.distill_weight=0.05",
                                       "train.warmup_steps=0", *ov])
    kw = {"frozen_g": {"sr_scale": 8, "sr_fn": sr_apply_from_state(
              build_hallucinator(8, 4).to(cuda))},
          "joint_g": {"sr_scale": 8, "sr_module": build_hallucinator(8, 4)}}.get(path, {})
    st = DistillTrainer(cfg, teacher_from_trainer(Trainer(cfg, device=cuda)), device=cuda, **kw)
    x = _pixels((16, 112, 112, 3), torch.uint8, cuda)
    y = torch.arange(16, device=cuda)
    before_p = [p.detach().clone() for p in st.model.parameters()]
    before = _counts()
    m = st.train_step(x, y)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == want
    assert all(torch.isfinite(v) for v in m.values())
    assert all(not torch.equal(a, b) for a, b in zip(before_p, st.model.parameters()))


def test_trainer_kd_term_on_the_card(cuda):
    """``Trainer.set_teacher``: the step's loss grows by the KD term, one
    degrade launch still."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.distill_loop import teacher_from_trainer
    from crfr_torch.train.loop import Trainer

    cfg = get_config("casia_arcface", ["model.backbone=ir_18", "data.num_classes=32",
                                       "loss.distill_weight=0.05"])
    x = _pixels((16, 112, 112, 3), torch.uint8, cuda)
    y = torch.arange(16, device=cuda)
    lows = torch.full((16,), 20, dtype=torch.int32, device=cuda)
    losses = []
    for teach in (False, True):
        tr = Trainer(cfg, device=cuda)
        if teach:
            tr.set_teacher(teacher_from_trainer(Trainer(cfg.override(**{"train.seed": 5}),
                                                        device=cuda)))
        before = _counts()
        losses.append(tr.train_step(x, y, lows=lows)["loss"].item())
        assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, 1)
    assert losses[1] > losses[0]


def _bank(n, m, d, invalid, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    pq = torch.randint(-127, 128, (n, d), generator=g, device=device, dtype=torch.int8)
    q = torch.randint(-127, 128, (m, d), generator=g, device=device, dtype=torch.int8)
    sc = torch.rand(m, generator=g, device=device) * 1e-2
    valid = torch.rand(m, generator=g, device=device) >= invalid
    return pq, q, sc, valid


# (M, share of invalid rows): one row, a ragged single tile, one whole tile,
# a ragged few tiles, and banks of 512 tiles, ragged and whole
_TILEMAX_M = [(1, 0.0), (127, 0.1), (128, 0.0), (300, 0.5), ((1 << 16) - 77, 0.01),
              (1 << 16, 0.0)]


@pytest.mark.parametrize("d", [16, 48, 64, 512, 1024])
@pytest.mark.parametrize("n", [1, 7, 64, 255, 256, 257, 600])
@pytest.mark.parametrize("m,invalid", _TILEMAX_M)
def test_bank_tilemax_equals_plain(cuda, n, d, m, invalid):
    """Exactly equal: s32 sums are exact, the score is one rounded multiply.
    N > 256 (and N > 128 at D = 1024) takes more than one probe group."""
    pq, q, sc, valid = _bank(n, m, d, invalid, cuda, seed=n + d + m)
    before = bs.bank_tilemax.launches
    got = bs.bank_tilemax(pq, q, sc, valid)
    want = bs.bank_tilemax_reference(pq, q, sc, valid)
    torch.cuda.synchronize()
    assert bs.bank_tilemax.launches == before + 1
    assert got.shape == (n, -(-m // 128)) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [128, 256])
def test_bank_tilemax_argmax_at_every_row_position(cuda, n):
    """In each of 300 tiles every row position 0-127 holds the planted
    maximum of exactly one probe of each 128-probe half (a permutation per
    tile and half), and every row has its own scale, so each maximum's
    value names its row: a wrong accumulator-to-row mapping shows here."""
    tiles, d = 300, 256
    g = torch.Generator().manual_seed(11)
    q = torch.randint(-50, 51, (tiles * 128, d), generator=g, dtype=torch.int8)
    pos = torch.stack([torch.randperm(128, generator=g) for _ in range(2 * tiles)])
    planted = (torch.arange(tiles)[:, None] * 128 + pos.view(tiles, 2 * 128)).t()  # (256, tiles)
    for j in range(2 * 128):
        q[planted[j], j] = 100
    pq = torch.zeros((n, d), dtype=torch.int8)
    pq[torch.arange(n), torch.arange(n)] = 127
    sc = 1.0 + torch.arange(tiles * 128, dtype=torch.float32) * 2.0 ** -20
    valid = torch.ones(tiles * 128, dtype=torch.bool)
    pq, q, sc, valid = (x.to(cuda) for x in (pq, q, sc, valid))
    got = bs.bank_tilemax(pq, q, sc, valid)
    want = bs.bank_tilemax_reference(pq, q, sc, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, 12700.0 * sc[planted[:n].to(cuda)])


def test_bank_tilemax_all_invalid_tiles(cuda):
    """A whole tile of invalid rows, and a ragged last tile whose rows are
    all invalid, give -3e38."""
    pq, q, sc, valid = _bank(256, 1000, 512, 0.0, cuda, seed=3)
    valid[128:256] = False
    valid[896:] = False
    got = bs.bank_tilemax(pq, q, sc, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, bs.bank_tilemax_reference(pq, q, sc, valid))
    assert (got[:, 1] == bs.NEG).all() and (got[:, 7] == bs.NEG).all()
    assert (got[:, [0, 2, 3, 4, 5, 6]] > bs.NEG).all()


def test_bank_tilemax_extreme_codes(cuda):
    """Codes of +-127 and -128 at D = 1024: sums reach +-2^24 and stay
    exact in f32."""
    n, m, d = 200, 1000, 1024
    g = torch.Generator(device=cuda).manual_seed(4)
    codes = torch.tensor([-128, -127, 127], dtype=torch.int8, device=cuda)
    pq = codes[torch.randint(0, 3, (n, d), generator=g, device=cuda)]
    q = codes[torch.randint(0, 3, (m, d), generator=g, device=cuda)]
    pq[0], q[0], q[1] = -128, -128, 127
    sc = torch.ones(m, device=cuda)
    valid = torch.ones(m, dtype=torch.bool, device=cuda)
    got = bs.bank_tilemax(pq, q, sc, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, bs.bank_tilemax_reference(pq, q, sc, valid))
    assert got[0, 0].item() == 2.0 ** 24


def test_bank_tilemax_never_takes_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel; the plain version is for the CPU."""
    pq, q, sc, valid = _bank(64, 5000, 128, 0.1, cuda)
    want = bs.bank_tilemax_reference(pq, q, sc, valid)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(bs, "bank_tilemax_reference", refuse)
    got = bs.bank_tilemax(pq, q, sc, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_bank_tilemax_unaligned_scale_and_mask(cuda):
    """Scales and mask that start off a 16-byte boundary (views into larger
    tensors): the kernel reads them through maps that start below them."""
    pq, q, sc, valid = _bank(100, 3000, 96, 0.2, cuda, seed=9)
    for s_off, v_off in ((1, 3), (2, 15), (3, 1)):
        sc_big = torch.rand(3000 + s_off, device=cuda)
        v_big = torch.rand(3000 + v_off, device=cuda) >= 0.2
        sc_v, valid_v = sc_big[s_off:], v_big[v_off:]
        assert sc_v.data_ptr() % 16 and valid_v.data_ptr() % 16
        got = bs.bank_tilemax(pq, q, sc_v, valid_v)
        torch.cuda.synchronize()
        assert torch.equal(got, bs.bank_tilemax_reference(pq, q, sc_v, valid_v))


def test_bank_tilemax_launch_plan(cuda):
    """One launch per call: probe groups are a grid dimension, one CTA per
    SM walks the tiles. 256 probes fit one group up to D = 512, 128 at
    D = 1024."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    serving = bs.bank_tilemax_info(256, 1 << 20, 512)
    assert serving["probe_groups"] == 1 and serving["probes_per_group"] == 256
    assert serving["ctas"] == sms and serving["spill_bytes"] == 0
    assert serving["smem_bytes"] <= 232448 and serving["stages"] >= 4
    wide = bs.bank_tilemax_info(300, 1 << 16, 1024)
    assert wide["probe_groups"] == 3 and wide["probes_per_group"] == 128
    assert wide["ctas"] == 3 * sms
    small = bs.bank_tilemax_info(7, 300, 48)
    assert small["probe_groups"] == 1 and small["ctas"] == 3 and small["threads"] == 160


def test_fused_path_equals_scan_on_card(cuda):
    """The three-phase path through the kernel against the int8 scan, on
    noisy copies of planted unit rows: top-1 the planted row, labels equal
    outside groups of equal scores, scores within 1e-6."""
    from crfr_torch.eval.bank import QuantBank, quantize_bank, streaming_topk_q, topk_matches_bank

    g = torch.Generator(device=cuda).manual_seed(5)
    rows = torch.nn.functional.normalize(torch.randn(40000, 512, generator=g, device=cuda), dim=1)
    bank = quantize_bank(rows.cpu().numpy()).to_device(cuda)
    planted = torch.randperm(40000, generator=g, device=cuda)[:64]
    probes = rows[planted] + 0.02 * torch.randn(64, 512, generator=g, device=cuda)
    before = bs.bank_tilemax.launches
    fs, fl = bs.bank_topk_fused(probes, bank.q, bank.scale, bank.labels, k=10)
    ss, sl = streaming_topk_q(probes, bank.q, bank.scale, bank.labels, k=10, block=8192)
    torch.cuda.synchronize()
    assert bs.bank_tilemax.launches == before + 1
    assert torch.equal(fl[:, 0], planted)
    torch.testing.assert_close(fs, ss, atol=1e-6, rtol=0)
    tie = torch.zeros_like(ss, dtype=torch.bool)
    tie[:, 1:] |= ss[:, 1:] == ss[:, :-1]
    tie[:, :-1] |= ss[:, :-1] == ss[:, 1:]
    assert torch.equal(fl[~tie], sl[~tie])
    _, lab = topk_matches_bank(probes, bank, k=10)          # CUDA default: fused
    assert bs.bank_tilemax.launches == before + 2
    assert isinstance(bank, QuantBank) and (lab == fl.cpu().numpy()).all()


def test_bank_tilemax_refuses_what_it_does_not_take(cuda):
    pq, q, sc, valid = _bank(8, 1000, 64, 0.0, cuda)
    with pytest.raises(TypeError, match="int8"):
        bs.bank_tilemax(pq.to(torch.int32), q, sc, valid)
    with pytest.raises(TypeError, match="bool"):
        bs.bank_tilemax(pq, q, sc, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        bs.bank_tilemax(pq, _bank(8, 1000, 128, 0.0, cuda)[1][:, ::2], sc, valid)
    with pytest.raises(ValueError, match="multiple of 16"):
        bs.bank_tilemax(pq[:, :40].contiguous(), q[:, :40].contiguous(), sc, valid)
    big_pq, big_q, _, _ = _bank(8, 1000, 1040, 0.0, cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        bs.bank_tilemax(big_pq, big_q, sc, valid)
    with pytest.raises(ValueError, match="tiles of 128"):
        bs.bank_tilemax(pq, q, sc, valid, tile=64)
    with pytest.raises(ValueError, match="is on"):
        bs.bank_tilemax(pq, q.cpu(), sc, valid)
    # a launch the library refuses raises through the wrapper's check
    lib = _build.load_library()
    out = torch.empty((8, 8), device=cuda)
    err = lib.crfr_bank_tilemax(pq.data_ptr(), q.data_ptr(), sc.data_ptr(), valid.data_ptr(),
                                out.data_ptr(), 8, 1000, 40, 128,
                                torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, err, "bank_tilemax")


# IR-50's 17 distinct convs at 112²: (in, out, kernel, stride, input side)
IR50_CONVS = [(3, 64, 3, 1, 112),
              (64, 64, 3, 1, 112), (64, 64, 3, 2, 112), (64, 64, 1, 2, 112), (64, 64, 3, 1, 56),
              (64, 128, 3, 1, 56), (128, 128, 3, 2, 56), (64, 128, 1, 2, 56), (128, 128, 3, 1, 28),
              (128, 256, 3, 1, 28), (256, 256, 3, 2, 28), (128, 256, 1, 2, 28),
              (256, 256, 3, 1, 14),
              (256, 512, 3, 1, 14), (512, 512, 3, 2, 14), (256, 512, 1, 2, 14), (512, 512, 3, 1, 7)]


@pytest.mark.parametrize("cin,cout,k,stride,side", IR50_CONVS)
def test_quantconv_on_card_equals_cpu(cuda, cin, cout, k, stride, side):
    import copy

    from crfr_torch.models.quant import QuantConv

    torch.manual_seed(side + cin + cout)
    conv = torch.nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
    x = torch.randn(2, cin, side, side).contiguous(memory_format=torch.channels_last)
    q = QuantConv(conv, x.abs().amax().item())
    qc = copy.deepcopy(q).to(cuda)
    want, shape = q.int_sums(x)
    got, got_shape = qc.int_sums(x.to(cuda))
    assert got_shape == shape and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    y = qc(x.to(cuda))
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y.cpu(), q(x), rtol=1e-6, atol=0)


@pytest.mark.parametrize("m,k,n", [(8, 27, 64), (1, 32, 60), (16, 8, 8), (17, 576, 64)])
def test_int8_matmul_pads_for_int_mm(cuda, m, k, n):
    from crfr_torch.models.quant import int8_matmul, int8_matmul_reference

    g = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = int8_matmul(a.to(cuda), b.to(cuda))
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8_matmul_reference(a, b))


def test_quantconv_emits_the_autocast_dtype(cuda):
    from crfr_torch.models.quant import QuantConv

    q = QuantConv(torch.nn.Conv2d(16, 32, 3, 1, 1), 2.0).to(cuda)
    x = torch.randn(2, 16, 8, 8, device=cuda).contiguous(memory_format=torch.channels_last)
    assert q(x).dtype == torch.float32
    with torch.autocast("cuda", dtype=torch.bfloat16):
        assert q(x).dtype == torch.bfloat16
    assert q.to(torch.bfloat16)(x).dtype == torch.bfloat16 and q.sw.dtype == torch.float32


def test_int8_embed_batch_launches_the_kernel_once(cuda):
    from crfr_torch.bench.throughput import build_embed_pipeline

    embed = build_embed_pipeline("ir_50", 16, 112, int8=True, device=cuda)
    x = _pixels((4, 112, 112, 3), torch.uint8, cuda, seed=3)
    before = (fp.fused_degrade_normalize.launches, fp.fused_degrade_normalize.lows_launches,
              fp.fused_resize_normalize.launches)
    emb = embed(x)
    torch.cuda.synchronize()
    assert (fp.fused_degrade_normalize.launches, fp.fused_degrade_normalize.lows_launches,
            fp.fused_resize_normalize.launches) == (before[0] + 1, before[1], before[2])
    assert emb.shape == (4, 512) and emb.dtype == torch.float32 and torch.isfinite(emb).all()


# photo-sized resizes: pyramid levels of a 640×480 photo at min_face 20 in
# bands of 16, 4 and 1 rows and by the two-pass plan, a level of a 1280×720
# photo by the two-pass plan, and the 24 and 48 px crops of a 400 px box;
# the plan is uint8 input's (float32 stages four times the bytes, so it may
# take the two-pass plan where uint8 fits in bands)
PHOTO_CASES = [((480, 640), (288, 384), "bands"), ((480, 640), (52, 69), "bands"),
               ((480, 640), (19, 25), "bands"), ((480, 640), (14, 18), "two_pass"),
               ((720, 1280), (55, 98), "two_pass"), ((400, 400), (24, 24), "bands"),
               ((400, 400), (48, 48), "bands")]


@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("hw,out_hw,plan", PHOTO_CASES)
def test_resize_kernel_at_photo_sizes(cuda, hw, out_hw, plan, in_dtype, out_dtype, atol):
    x = _pixels((1, *hw, 3), in_dtype, cuda, seed=out_hw[0])
    info = fp.resample_info(tuple(x.shape), out_hw, "pil", in_dtype, out_dtype)
    assert info["plan"] == plan or (in_dtype == torch.float32 and info["plan"] == "two_pass")
    if info["plan"] == "bands":
        assert info["rows"] < fp.RESIZE_ROWS and info["smem_bytes"] <= info["smem_limit"]
    before = fp.fused_resize_normalize.launches
    got = fp.fused_resize_normalize(x, out_hw, "pil", out_dtype)
    want = fp.fused_resize_normalize_reference(x, out_hw, "pil", out_dtype)
    torch.cuda.synchronize()
    assert fp.fused_resize_normalize.launches == before + 1
    assert got.shape == (1, *out_hw, 3) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out_hw", [((8, 160, 140, 3), (112, 112)),
                                          ((5, 37, 200, 3), (112, 96)),
                                          ((3, 64, 50, 3), (29, 31)),
                                          ((2, 480, 640, 3), (288, 384)),
                                          ((4, 112, 112, 1), (14, 14))])
def test_two_pass_plan_equals_the_bands_bit_for_bit(cuda, shape, out_hw, out_dtype):
    """Where both plans fit they run the same sums in the same order."""
    for in_dtype in (torch.uint8, torch.float32):
        x = _pixels(shape, in_dtype, cuda, seed=shape[1])
        key = fp.operator_key(shape[1], shape[2], out_hw, "pil")
        bands = fp._launch(x, key, *out_hw, out_dtype, "t")
        two = fp._launch(x, key, *out_hw, out_dtype, "t", rows=fp.TWO_PASS)
        torch.cuda.synchronize()
        assert torch.equal(bands, two)


def test_two_pass_plan_takes_any_width(cuda):
    x = _pixels((1, 64, 64, 3), torch.uint8, cuda)
    got = fp.fused_resize_normalize(x, (112, 20000), "pil", torch.float32)
    want = fp.fused_resize_normalize_reference(x, (112, 20000), "pil", torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_detect_on_the_card_equals_the_cpu(cuda):
    """The cascade (random nets, thresholds 0.3/0/0) on a 160×120 photo:
    three launches of kernel 2's ragged forms (the pyramid, the R-net crops,
    the O-net crops) and none a level or a crop; the detections equal the
    same cascade's on CPU tensors."""
    from crfr_torch.models.mtcnn import MTCNN

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (160, 120, 3)).astype(np.uint8)
    card = MTCNN(min_face=40, thresholds=(0.3, 0.0, 0.0))
    cpu = MTCNN(min_face=40, thresholds=(0.3, 0.0, 0.0), device="cpu")
    x = torch.from_numpy(img).cuda()
    assert len(card.stage2(x, card.stage1(x))) > 0          # both crop stages run
    before = _ragged_counts()
    got = card.detect(img)
    assert tuple(a - b for a, b in zip(_ragged_counts(), before)) == (0, 1, 2)
    want = cpu.detect(img)
    assert len(got.boxes) == len(want.boxes) > 0
    np.testing.assert_allclose(got.boxes, want.boxes, rtol=0, atol=1e-2)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.landmarks, want.landmarks, rtol=0, atol=1e-2)


def _ragged_counts():
    return (fp.fused_resize_normalize.launches, fp.fused_resize_normalize.pyramid_launches,
            fp.fused_resize_normalize.crop_launches)


def _boxes(n, h, w, seed=0):
    """Boxes inside, partly and wholly outside an (h, w) photo, one with no
    area, one the whole photo, sides 3 to 400, cw != ch for most."""
    from crfr_torch.bench.ragged_levels import photo_boxes

    b = photo_boxes(n, h, w, seed=seed, min_side=3, unequal=0.8)
    b[2] = [0, 0, w, h]
    return b


def _old_crops(img, boxes, size, out_dtype):
    """A launch a crop, as crop_resize made them before the crop form."""
    out = torch.full((len(boxes), size, size, img.shape[2]), -127.5 / 128.0, dtype=out_dtype,
                     device=img.device)
    for i, (x1, y1, x2, y2) in enumerate(boxes.tolist()):
        if x2 > x1 and y2 > y1:
            crop = fp.padded_crop(img, x1, y1, x2, y2).contiguous()[None]
            out[i] = fp.fused_resize_normalize(crop, (size, size), "pil", out_dtype)[0]
    return out


def _pyramid_sizes(h, w, min_face=20):
    from crfr_torch.models.mtcnn import MTCNN

    return [hw for _, hw in MTCNN(min_face=min_face, device="cpu").pyramid_sizes(h, w)]


@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("hw,c", [((480, 640), 3), ((720, 1280), 3), ((120, 160), 1),
                                  ((37, 411), 4)])
def test_pyramid_form_matches_plain_and_the_per_level_launches(cuda, hw, c, in_dtype,
                                                               out_dtype, atol):
    """Every level of a photo's pyramid at min_face 20 (a wide and a square
    level added) from one launch: each within ``atol`` of the plain version,
    bit for bit the per-level launch (no level splits a sum), a contiguous
    view into one buffer."""
    x = _pixels((1, *hw, c), in_dtype, cuda, seed=hw[0])
    sizes = _pyramid_sizes(*hw) + [(12, 400), (hw[0], hw[0])]
    before = _ragged_counts()
    got = fp.fused_pyramid_normalize(x, sizes, "pil", out_dtype)
    assert tuple(a - b for a, b in zip(_ragged_counts(), before)) == (0, 1, 0)
    want = fp.fused_pyramid_normalize_reference(x, sizes, "pil", out_dtype)
    torch.cuda.synchronize()
    base = got[0].untyped_storage().data_ptr()
    for hw_l, g, wn in zip(sizes, got, want):
        assert g.shape == (1, *hw_l, c) and g.dtype == out_dtype and g.is_contiguous()
        store, start = g.untyped_storage().data_ptr(), g.data_ptr()     # one buffer,
        assert store == base and start % (64 * g.element_size()) == 0   # 64-element aligned
        torch.testing.assert_close(g.float(), wn.float(), atol=atol, rtol=0)
        assert torch.equal(g, fp.fused_resize_normalize(x, hw_l, "pil", out_dtype))


@pytest.mark.parametrize("size", [12, 24, 48])
@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
def test_crop_form_matches_plain_and_the_per_crop_launches(cuda, in_dtype, out_dtype, atol,
                                                           size):
    """300 boxes of a 480×640 photo (inside, partly and wholly outside, no
    area, cw != ch) from one launch: within ``atol`` of the plain version,
    bit for bit a launch a zero-padded crop."""
    img = _pixels((480, 640, 3), in_dtype, cuda, seed=size)
    boxes = _boxes(300, 480, 640, seed=size)
    before = _ragged_counts()
    got = fp.fused_crop_resize_normalize(img, boxes, size, "pil", out_dtype)
    assert tuple(a - b for a, b in zip(_ragged_counts(), before)) == (0, 0, 1)
    want = fp.fused_crop_resize_normalize_reference(img, boxes, size, "pil", out_dtype)
    torch.cuda.synchronize()
    assert got.shape == (300, size, size, 3) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[0] == -127.5 / 128.0).all() and (got[1] == -127.5 / 128.0).all()
    assert torch.equal(got, _old_crops(img, boxes, size, out_dtype))


def test_crop_form_takes_an_unaligned_image_and_no_boxes(cuda):
    big = _pixels((100 * 90 * 3 + 1,), torch.uint8, cuda)
    img = big[1:].view(100, 90, 3)
    boxes = _boxes(40, 100, 90, seed=4)
    got = fp.fused_crop_resize_normalize(img, boxes, 24)
    torch.cuda.synchronize()
    assert torch.equal(got, _old_crops(img.contiguous(), boxes, 24, torch.float32))
    before = _ragged_counts()
    empty = fp.fused_crop_resize_normalize(img, boxes[:0], 24)
    assert empty.shape == (0, 24, 24, 3) and _ragged_counts() == before


def test_ragged_forms_never_take_the_plain_version(cuda, monkeypatch):
    x = _pixels((1, 240, 320, 3), torch.uint8, cuda)
    sizes = _pyramid_sizes(240, 320)
    boxes = _boxes(50, 240, 320)
    want = fp.fused_pyramid_normalize_reference(x, sizes)
    want_c = fp.fused_crop_resize_normalize_reference(x[0], boxes, 24)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("_reference", "fused_resize_normalize_reference",
                 "fused_pyramid_normalize_reference", "fused_crop_resize_normalize_reference",
                 "_launch"):
        monkeypatch.setattr(fp, name, refuse)
    got = fp.fused_pyramid_normalize(x, sizes)
    got_c = fp.fused_crop_resize_normalize(x[0], boxes, 24)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    torch.testing.assert_close(got_c, want_c, atol=1e-4, rtol=0)


def test_ragged_forms_refuse_what_they_do_not_take(cuda):
    x = _pixels((1, 64, 64, 3), torch.uint8, cuda)
    with pytest.raises(ValueError, match="one photo"):
        fp.fused_pyramid_normalize(_pixels((2, 64, 64, 3), torch.uint8, cuda), [(32, 32)])
    with pytest.raises(TypeError, match="uint8 or float32"):
        fp.fused_pyramid_normalize(x.int(), [(32, 32)])
    with pytest.raises(ValueError, match="on the host"):
        fp.fused_crop_resize_normalize(x[0], torch.zeros((1, 4), dtype=torch.int32,
                                                         device=cuda), 24)
    # one output row of a 24 px crop of a 40,000-row box reads ~6,700 rows
    with pytest.raises(ValueError, match="shared memory"):
        fp.fused_crop_resize_normalize(x[0], np.asarray([[0, 0, 30, 40000]]), 24)
    assert fp.fused_pyramid_normalize(x, []) == []


def test_mtcnn_train_step_launches_the_crop_form_once_a_net(cuda):
    """One scene batch of ``train_mtcnn_synthetic`` on the card: each net's
    crops of each scene in one launch of the crop form, no other launch."""
    from crfr_torch.models.mtcnn import MTCNN
    from crfr_torch.train.mtcnn_train import train_mtcnn_synthetic

    mt = MTCNN(min_face=40)
    before = _ragged_counts()
    losses = train_mtcnn_synthetic(mt, steps=1, batch_scenes=2, seed=0)
    assert tuple(a - b for a, b in zip(_ragged_counts(), before)) == (0, 0, 3 * 2)
    assert all(np.isfinite(v) for v in losses.values())


# IR-50's distinct train-mode BatchNorm2d shapes at 112²: (C, side), and how
# many of its 54 BNs take each
IR50_BNS = [(64, 112, 2), (64, 56, 7), (128, 28, 9), (256, 14, 29), (512, 7, 7)]


def _bn_inputs(b, c, side, seed):
    """float32 on the CPU: x with a mean of up to ±3 a channel (so the
    variance comes out of E[x²] − E[x]² with some cancellation), dy, and
    weight, bias and running statistics away from 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, side, side, generator=g) * 2 + 3 * torch.rand(1, c, 1, 1, generator=g)
    dy = torch.randn(b, c, side, side, generator=g)
    w, bias = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)
    return x, dy, w, bias, torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.5


def _bn_run(x, dy, w, bias, rm, rv, device, dtype, update=True):
    """``ops.batch_norm`` forward and backward on ``device`` in ``dtype``
    (the parameters and statistics float32): y, dx, dw, db, rm, rv on the
    CPU in float32."""
    cl = torch.channels_last
    xd = x.to(device, dtype).contiguous(memory_format=cl).requires_grad_(True)
    wd, bd = w.to(device).requires_grad_(True), bias.to(device).requires_grad_(True)
    rmd, rvd = rm.to(device).clone(), rv.to(device).clone()
    y = bn_op.batch_norm(xd, wd, bd, rmd, rvd, 0.1, 1e-5, update=update)
    y.backward(dy.to(device, dtype).contiguous(memory_format=cl))
    return [t.detach().float().cpu() for t in (y, xd.grad, wd.grad, bd.grad, rmd, rvd)]


def _bn_check(got, want, dtype, x, dy, stats=True):
    """The kernel on the card against the plain path on the CPU in float32,
    fed the same values (bf16 inputs upcast). Tolerances:
    - y and dx in bf16: within one bf16 ulp (2⁻⁸ to 2⁻⁷ of the value) of
      the float32 result, so rtol 2⁻⁷: the two float32 values differ in
      their last bits (the sums' order), and one that lies near a rounding
      edge rounds the other way (at B=512, dx did so for 278 of 411 M
      values); atol 1e-4 of the largest |value| for the values that cancel
      (dy − mean(dy) − x̂·mean(dy·x̂)). In float32: rtol 1e-5, the same atol.
    - dw, db: float32 sums of n products in another order than ATen's (a
      blocked tree either way): 1e-5 of the channel's sum of |terms|.
    - running statistics: float32 sums over the rows in another order than
      ATen's Welford: the batch's moments within 1e-5 of E|x| and E[x²] (at
      6.4 M rows the mean's sum of 760 terms a thread moved by 5.5e-6 of
      E|x|), of which the update takes 0.1; rtol 1e-5."""
    y, dx, dw, db, rm, rv = got
    wy, wdx, wdw, wdb, wrm, wrv = want
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y, wy, rtol=rtol, atol=1e-4 * wy.abs().max().item())
    torch.testing.assert_close(dx, wdx, rtol=rtol, atol=1e-4 * wdx.abs().max().item())
    dims = (0, 2, 3)
    xhat = (x - x.mean(dims, keepdim=True)) / x.std(dims, unbiased=False, keepdim=True)
    torch.testing.assert_close(db, wdb, rtol=0, atol=1e-5 * dy.abs().sum(dims).max().item())
    torch.testing.assert_close(dw, wdw, rtol=0,
                               atol=1e-5 * (dy * xhat).abs().sum(dims).max().item())
    if stats:
        torch.testing.assert_close(rm, wrm, rtol=1e-5,
                                   atol=1e-6 * x.abs().mean(dims).max().item())
        torch.testing.assert_close(rv, wrv, rtol=1e-5,
                                   atol=1e-6 * (x * x).mean(dims).max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,side,_n", IR50_BNS + [(24, 9, 0), (3, 5, 0)])
def test_batch_norm_kernel_matches_plain(cuda, c, side, _n, dtype):
    """Each of IR-50's BN shapes at B=4, plus C = 24 (16-byte loads, three
    CTAs across a row) and C = 3 (one channel a load): forward, input,
    weight and bias gradients and running statistics against the CPU's
    plain path, four launches."""
    x, dy, w, bias, rm, rv = _bn_inputs(4, c, side, seed=c + side)
    x, dy = x.to(dtype).float(), dy.to(dtype).float()
    before = bn_op.batch_norm.launches
    got = _bn_run(x, dy, w, bias, rm, rv, cuda, dtype)
    torch.cuda.synchronize()
    assert bn_op.batch_norm.launches == before + 4
    want = _bn_run(x, dy, w, bias, rm, rv, "cpu", torch.float32)
    _bn_check(got, want, dtype, x, dy)


def test_batch_norm_kernel_at_b512_stage_one(cuda):
    """64 channels over 512·112² = 6.4 M rows in bf16 (264 CTAs of 24 K
    rows): output and gradients against the CPU's plain path, the running
    statistics against float64 moments on the card (rtol 1e-5). At this
    size the CPU's float32 sums, serial over far more rows a thread than
    the kernel's 760, leave its running variance 2.8e-4 off the float64
    one, beyond the 1e-5 the kernel holds."""
    x, dy, w, bias, rm, rv = _bn_inputs(512, 64, 112, seed=7)
    x, dy = x.bfloat16().float(), dy.bfloat16().float()
    got = _bn_run(x, dy, w, bias, rm, rv, cuda, torch.bfloat16)
    want = _bn_run(x, dy, w, bias, rm, rv, "cpu", torch.float32)
    x64 = x.to(cuda, torch.float64)
    moments = (x64.mean((0, 2, 3)), x64.var((0, 2, 3), unbiased=False))
    del x64
    for stat, old, batch in zip(got[4:], (rm, rv), moments):
        exact = (0.9 * old.double() + 0.1 * batch.cpu()).float()
        torch.testing.assert_close(stat, exact, rtol=1e-5, atol=0)
    _bn_check(got, want, torch.bfloat16, x, dy, stats=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_norm_kernel_is_bit_identical_and_recomputes_frozen(cuda, dtype):
    """Two calls give the same bits (no float atomics); a call with
    ``update=False`` (a remat block's recomputation) gives the same output
    and gradients and leaves the running statistics as they were, through
    ``irse.BatchNorm2d`` under ``_recomputing`` too."""
    from crfr_torch.models import irse

    x, dy, w, bias, rm, rv = _bn_inputs(16, 128, 28, seed=3)
    runs = [_bn_run(x, dy, w, bias, rm, rv, cuda, dtype) for _ in range(2)]
    frozen = _bn_run(x, dy, w, bias, rm, rv, cuda, dtype, update=False)
    for a, b, f in zip(runs[0], runs[1], frozen[:4]):
        assert torch.equal(a, b)
        assert torch.equal(a, f)
    assert torch.equal(frozen[4], rm) and torch.equal(frozen[5], rv)
    assert not torch.equal(runs[0][5], rv)
    m = irse.BatchNorm2d(128, **irse._BN).to(cuda).train()
    xd = x.to(cuda, dtype).contiguous(memory_format=torch.channels_last)
    with irse._recomputing():
        m(xd)
    assert torch.equal(m.running_mean, torch.zeros_like(m.running_mean))
    assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    m(xd)
    assert not torch.equal(m.running_var, torch.ones_like(m.running_var))


def test_batch_norm_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    w, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    rm, rv = torch.zeros(8, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        bn_op.batch_norm(x, w, b, rm, rv, 0.1, 1e-5)
    cl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bn_op.batch_norm(cl.half(), w, b, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="weight must be"):
        bn_op.batch_norm(cl, w.cpu(), b, rm, rv, 0.1, 1e-5)
    # a launch the library refuses raises through the wrapper's check
    lib = _build.load_library()
    err = lib.crfr_batch_norm_transform(cl.data_ptr(), cl.data_ptr(), 0, 32, 8, 4, 3, 1, 1,
                                        rm.data_ptr(), rv.data_ptr(), w.data_ptr(),
                                        b.data_ptr(), torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, err, "batch_norm")


def test_batch_norm_sends_other_ranks_to_the_plain_path(cuda):
    """A (N, C) input on the card (the float32 ``BatchNorm1d`` at the end of
    the backbone) takes the plain path: no launch, and the plain path's
    result and running statistics bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(64, 512, generator=g, device=cuda) * 2 + 1
    w, b = torch.rand(512, generator=g, device=cuda) + 0.5, torch.zeros(512, device=cuda)
    stats = [(torch.zeros(512, device=cuda), torch.ones(512, device=cuda)) for _ in range(2)]
    before = bn_op.batch_norm.launches
    y = bn_op.batch_norm(x, w, b, *stats[0], 0.1, 1e-5)
    assert bn_op.batch_norm.launches == before
    want = bn_op.batch_norm_reference(x, w, b, *stats[1], 0.1, 1e-5)
    assert torch.equal(y, want)
    assert all(torch.equal(s, t) for s, t in zip(*stats))


@pytest.mark.parametrize("backbone,b", [("ir_50", 512), ("mobilefacenet", 64)])
def test_train_step_runs_every_bn2d_through_the_kernels(cuda, backbone, b):
    """One train step on the card (IR-50 at the benchmark's batch of 512,
    MobileFaceNet at 64, both in bf16 under autocast): four launches of the
    kernels for each ``BatchNorm2d``, and in the step's trace none of
    ATen's BN kernels in bf16. The float32 BatchNorm1d at the end (512
    features) keeps ATen's kernels: one forward and backward, at most five
    launches."""
    from crfr_torch.configs import get_config
    from crfr_torch.models import irse
    from crfr_torch.train.loop import Trainer

    cfg = get_config("casia_arcface", [f"model.backbone={backbone}", "data.num_classes=1024",
                                       f"train.batch_size={b}"])
    tr = Trainer(cfg, device=cuda)
    x = _pixels((b, 112, 112, 3), torch.uint8, cuda)
    y = torch.arange(b, device=cuda) % 1024
    tr.train_step(x, y)
    torch.cuda.synchronize()
    n_bn2d = sum(isinstance(m, irse.BatchNorm2d) for m in tr.model.modules())
    before = bn_op.batch_norm.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        m = tr.train_step(x, y)
        torch.cuda.synchronize()
    assert bn_op.batch_norm.launches - before == 4 * n_bn2d
    if backbone == "ir_50":
        assert n_bn2d == 54
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if "crfr_batch_norm" in n]
    assert len(ours) == 4 * n_bn2d, sorted(set(names))
    aten = [n for n in names if "at::native" in n and "batch_norm" in n]
    assert len(aten) <= 5 and not any("BFloat16" in n for n in aten), sorted(set(aten))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


# The streamed head at the train-ir100-ms1m cell's widths. Loss: rtol 1e-5.
# Gradients of the embeddings and of W: rtol 1e-5 with an atol of 1e-5 of
# the tensor's largest entry, as on the CPU (tests/test_torch_streaming_head.py):
# an entry near 0 is a difference of near-equal terms and keeps their
# rounding. Program and reference are float32 with TF32 off; cuBLAS may take
# other kernels for their products, which moves a logit by float32 rounding
# (~1e-7 of it) and no more.
HEAD_RTOL = 1e-5


def _streamed_head(device, classes=85742, b=512, seed=0):
    """Loss and gradients of ``Trainer._loss`` on the streaming path (the
    ms1m_ijbc preset on one card) and of the plain reference."""
    from benchmark.reference.arcface import arcface_ce
    from crfr_torch.configs import get_config
    from crfr_torch.train.loop import Trainer

    cfg = get_config("ms1m_ijbc", ["mesh.data=1", "mesh.model=1", f"train.batch_size={b}",
                                   f"data.num_classes={classes}", "model.backbone=ir_18"])
    tr = Trainer(cfg, device=device)
    assert tr._ce_impl == "streaming" and cfg.loss.ce_block == 8192
    g = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn(b, 512, generator=g, device=device)
    y = torch.randint(0, classes, (b,), generator=g, device=device)
    w = tr.model.head.weight
    e = emb.clone().requires_grad_(True)
    loss = tr._loss(e, y)
    loss.backward()
    got = (loss.detach(), e.grad, w.grad)
    with strict_fp32():
        e2 = emb.clone().requires_grad_(True)
        w2 = w.detach().clone().requires_grad_(True)
        ref = arcface_ce(e2, w2, y, s=cfg.loss.scale, m=cfg.loss.margin)
        want = (ref.detach(), *torch.autograd.grad(ref, [e2, w2]))
    return got, want


def _head_excess(got, want) -> list[float]:
    """Each tensor's largest |a - b| over its tolerance (over 1 fails)."""
    return [float(((a - b).abs() / (HEAD_RTOL * (b.abs() + (b.abs().max() if a.dim() else 0))))
                  .max()) for a, b in zip(got, want)]


def test_streamed_head_matches_the_reference_at_the_cells_widths(cuda):
    got, want = _streamed_head(cuda)
    excess = _head_excess(got, want)
    print("streamed head, excess over the tolerance (loss, emb grad, W grad):", excess)
    assert max(excess) <= 1.0, excess


def test_streamed_head_with_tf32_fails_the_comparison(cuda, monkeypatch):
    """The control: the program's products in TF32 (10 mantissa bits)."""
    import contextlib

    from crfr_torch.losses import arcface

    @contextlib.contextmanager
    def tf32(device):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.autocast(device.type, enabled=False):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    monkeypatch.setattr(arcface, "true_f32", tf32)
    got, want = _streamed_head(cuda)
    excess = _head_excess(got, want)
    print("streamed head in TF32, excess over the tolerance:", excess)
    assert max(excess) > 1.0, excess

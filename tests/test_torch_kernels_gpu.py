"""The port's CUDA kernels against their plain versions, on the card: the
preprocessing kernel (with an int low, a low per image, or a resize, the
SR probe's ↓ among them), ``bank_tilemax`` with the fused gallery path,
and the one launch of the preprocessing kernel in a train step, an SR
train step, a hallucinated extract batch, and a residual-KD step on each
input path (a fixed low, a low per batch, a low per image, a frozen G, G
trained jointly), the teacher's KD term on the trainer included.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor crfr, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from crfr_torch.device import strict_fp32
from crfr_torch.ops import _build
from crfr_torch.ops import bank_scan as bs
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
    # a band's 13 rows of 20000 x 3 f32 in shared memory: 3 MB, beyond any CTA's share
    before = fp.fused_resize_normalize.launches
    with pytest.raises(ValueError, match="limit"):
        fp.fused_resize_normalize(_pixels((1, 64, 64, 3), torch.uint8, cuda), (112, 20000))
    assert fp.fused_resize_normalize.launches == before


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
    assert resize["rows"] == fp.RESIZE_ROWS
    with pytest.raises(RuntimeError, match="CUDA error"):
        fp.resample_info((1, 64, 64, 3), (112, 20000))


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
    """The plan for lows 8-112: the tallest band height that fits, buffers
    for the largest low, within the device's shared memory."""
    lows = _lows(512, "random", cuda)
    for in_dtype, out_dtype in ((torch.uint8, torch.bfloat16), (torch.float32, torch.float32)):
        info = fp.resample_info((512, 112, 112, 3), lows, "pil", in_dtype, out_dtype,
                                lows=(8, 112))
        assert info["lows"] == [8, 112] and 0 < info["smem_bytes"] <= info["smem_limit"]
        assert info["ctas"] == 512 * -(-112 // info["rows"])
        assert (info["span"], info["in_span"]) == fp.band_spans(fp.lows_key(112, (8, 112), "pil"),
                                                                info["rows"])
        taller = [r for r in (112, 56, 28, 16) if r > info["rows"]]
        for r in taller:
            with pytest.raises(RuntimeError, match="CUDA error"):
                fp.resample_info((512, 112, 112, 3), lows, "pil", in_dtype, out_dtype, rows=r,
                                 lows=(8, 112))


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

"""crfr_torch.ops.fused_preprocess on the CPU against the Pallas kernels of
crfr.ops.fused_pallas (interpreter mode), at tests/test_pallas.py's shapes
and tolerances: float32 out atol 2e-3 / rtol 1e-3, bf16 out 2e-2. The
kernel itself is held against the same plain versions on the card in
tests/test_torch_kernels_gpu.py."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.ops import fused_pallas as ref
from crfr_torch.ops import fused_preprocess as port
from crfr_torch.ops.bicubic import resize_matrix

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_TOL = {torch.float32: dict(atol=2e-3, rtol=1e-3),
        torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _pixels(rng, shape, dtype):
    return rng.integers(0, 256, shape).astype(dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_degrade_matches_pallas(rng, mode, in_dtype, out_dtype):
    x = _pixels(rng, (3, 112, 112, 3), in_dtype)
    want = ref.fused_degrade_normalize(jnp.asarray(x), 16, mode,
                                       out_dtype=_JNP[out_dtype], interpret=True)
    got = port.fused_degrade_normalize(torch.from_numpy(x), 16, mode,
                                       out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (3, 112, 112, 3)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[out_dtype])


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_resize_matches_pallas(rng, out_dtype):
    x = _pixels(rng, (2, 160, 140, 3), np.float32)
    want = ref.fused_resize_normalize(jnp.asarray(x), (112, 112), "pil",
                                      out_dtype=_JNP[out_dtype], interpret=True)
    got = port.fused_resize_normalize(torch.from_numpy(x), (112, 112), "pil",
                                      out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 112, 112, 3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[out_dtype])


def test_output_is_channels_last_nchw(rng):
    x = torch.from_numpy(_pixels(rng, (2, 32, 32, 3), np.uint8))
    nchw = port.fused_degrade_normalize(x, 8).permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)


def test_cpu_tensor_takes_plain_version_without_counting(rng):
    before = (port.fused_degrade_normalize.launches,
              port.fused_resize_normalize.launches)
    x = torch.from_numpy(_pixels(rng, (2, 32, 32, 3), np.uint8))
    a = port.fused_degrade_normalize(x, 8, out_dtype=torch.float32)
    b = port.fused_resize_normalize(x, (16, 16), out_dtype=torch.float32)
    torch.testing.assert_close(
        a, port.fused_degrade_normalize_reference(x, 8, out_dtype=torch.float32),
        rtol=0, atol=0)
    torch.testing.assert_close(
        b, port.fused_resize_normalize_reference(x, (16, 16), out_dtype=torch.float32),
        rtol=0, atol=0)
    assert (port.fused_degrade_normalize.launches,
            port.fused_resize_normalize.launches) == before


def test_kernel_path_refuses_cpu_tensors(rng):
    x = torch.from_numpy(_pixels(rng, (1, 16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port._launch(x, ("degrade", 16, 16, 8, "pil"), 16, 16, torch.float32, "t")


def test_non_square_degrade_raises(rng):
    x = torch.from_numpy(_pixels(rng, (1, 16, 12, 3), np.uint8))
    with pytest.raises(ValueError, match="square"):
        port.fused_degrade_normalize(x, 8)


# ---- the kernel's band tables and its pass order ---------------------------

_TABLE_SIZES = [(112, 16), (16, 112), (112, 15), (15, 112), (160, 112), (140, 112),
                (37, 112), (200, 96), (32, 8), (8, 32)]


@pytest.mark.parametrize("mode", ["pil", "cv2"])
@pytest.mark.parametrize("n_in,n_out", _TABLE_SIZES)
def test_band_table_rebuilds_resize_matrix(mode, n_in, n_out):
    """Scattered back to dense form, the table is resize_matrix bit for bit;
    its windows lie inside the input, in order."""
    start, taps = port.band_table(n_in, n_out, mode)
    assert start.dtype == np.int32 and taps.dtype == np.float32
    assert taps.shape[0] == n_out and (np.diff(start) >= 0).all()
    assert start.min() >= 0 and start.max() + taps.shape[1] <= n_in
    dense = np.zeros((n_out, n_in), np.float32)
    np.put_along_axis(dense, start[:, None] + np.arange(taps.shape[1]), taps, axis=1)
    want = resize_matrix(n_in, n_out, mode)
    assert np.array_equal(dense.view(np.uint32), want.view(np.uint32))
    # as the kernel reads them: contiguous, the weights transposed to (T, n_out)
    d_start, d_taps = port._device_table(n_in, n_out, mode, torch.device("cpu"))
    assert d_start.is_contiguous() and d_taps.is_contiguous()
    assert d_start.dtype == torch.int32 and np.array_equal(d_start.numpy(), start)
    assert np.array_equal(d_taps.numpy(), taps.T)


@pytest.mark.parametrize("rows", [112, 28, 16, 7, 1])
@pytest.mark.parametrize("arg,mode", [(16, "pil"), (15, "pil"), (16, "cv2"), (15, "cv2"),
                                      ((112, 112), "pil"), ((112, 96), "cv2")])
def test_band_span_holds_every_band(arg, mode, rows):
    """Every band of ``rows`` output rows reads at most ``band_spans`` rows
    (low-res rows of a degrade, input rows of a 160-row resize) from its
    first row's window start on, as the kernel sizes them, and every
    nonzero weight of its rows lies in that window."""
    h = 112 if isinstance(arg, int) else 160
    key = port.operator_key(h, 140, arg, mode)
    span = port.band_spans(key, rows)[0]
    n_in, n_out = (arg, h) if isinstance(arg, int) else (h, arg[0])
    start, taps = port.band_table(n_in, n_out, mode)
    dense = resize_matrix(n_in, n_out, mode)
    for r0 in range(0, n_out, rows):
        r1 = min(r0 + rows, n_out)
        assert start[r1 - 1] + taps.shape[1] - start[r0] <= span <= n_in
        cols = np.nonzero(dense[r0:r1].any(0))[0]
        assert start[r0] <= cols.min() and cols.max() < start[r0] + span


def _along(a: np.ndarray, factor, axis: int) -> np.ndarray:
    """One 1-D factor applied along H (axis 1) or W (axis 2) from its band
    table, in float32, as the kernel applies it."""
    start, taps = port.band_table(*factor)
    g = np.take(a, start[:, None] + np.arange(taps.shape[1]), axis=axis)
    spec = "botwc,ot->bowc" if axis == 1 else "bhotc,ot->bhoc"
    return np.einsum(spec, g, taps).astype(np.float32)


def _replay(x: np.ndarray, key: tuple) -> np.ndarray:
    """The kernel's pass order in float32: degrade down H, down W, up W, up
    H; resize W, then H; then (y - 127.5) / 128."""
    a = x.astype(np.float32)
    factors = port._factors(key)
    order = ((0, 1), (1, 2), (3, 2), (2, 1)) if key[0] == "degrade" else ((1, 2), (0, 1))
    for i, axis in order:
        a = _along(a, factors[i], axis)
    return ((a - np.float32(127.5)) * np.float32(1.0 / 128.0)).astype(np.float32)


def _as(y: np.ndarray, out_dtype) -> np.ndarray:
    return torch.from_numpy(y).to(out_dtype).float().numpy()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("low", [16, 15])
@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_kernel_order_degrade_matches_pallas(rng, mode, low, out_dtype):
    x = _pixels(rng, (3, 112, 112, 3), np.uint8)
    want = ref.fused_degrade_normalize(jnp.asarray(x), low, mode,
                                       out_dtype=_JNP[out_dtype], interpret=True)
    got = _as(_replay(x, port.operator_key(112, 112, low, mode)), out_dtype)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **_TOL[out_dtype])


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out_hw", [((2, 160, 140, 3), (112, 112)),
                                          ((2, 37, 200, 3), (112, 96))])
def test_kernel_order_resize_matches_pallas(rng, shape, out_hw, out_dtype):
    x = _pixels(rng, shape, np.uint8)
    want = ref.fused_resize_normalize(jnp.asarray(x), out_hw, "pil",
                                      out_dtype=_JNP[out_dtype], interpret=True)
    got = _as(_replay(x, port.operator_key(shape[1], shape[2], out_hw, "pil")), out_dtype)
    assert got.shape == (shape[0], *out_hw, 3)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **_TOL[out_dtype])


# ---- a low per image: the train step's degrade ------------------------------

@pytest.mark.parametrize("in_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_per_image_lows_match_crfr_train_step(rng, mode, in_dtype):
    """The tensor form's plain version is crfr's train-step degrade: the
    (L, S, S) table indexed per image, one batched einsum, then normalize
    (crfr/train/loop.py:263-278), within 1e-5; each image also equals the
    int form at its own low."""
    from crfr.ops.bicubic import degrade_matrix as ref_degrade_matrix
    from crfr.ops.normalize import normalize as ref_normalize

    x = _pixels(rng, (6, 32, 32, 3), in_dtype)
    lows = np.array([8, 32, 17, 9, 8, 31], np.int32)
    table = jnp.asarray(np.stack([ref_degrade_matrix(32, low, mode) for low in range(8, 33)]))
    w = table[lows - 8]
    want = ref_normalize(jnp.einsum("boi,bijc,bpj->bopc", w, jnp.asarray(x, jnp.float32), w,
                                    preferred_element_type=jnp.float32))
    before = port.fused_degrade_normalize.lows_launches
    got = port.fused_degrade_normalize(torch.from_numpy(x), torch.from_numpy(lows), mode,
                                       torch.float32, lows=(8, 32))
    assert port.fused_degrade_normalize.lows_launches == before        # the CPU launches nothing
    assert got.shape == x.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for i, low in enumerate(lows):
        one = port.fused_degrade_normalize(torch.from_numpy(x[i:i + 1]), int(low), mode,
                                           torch.float32)
        np.testing.assert_allclose(got[i:i + 1].numpy(), one.numpy(), atol=1e-5, rtol=0)


def test_per_image_lows_refuse_bad_arguments(rng):
    x = torch.from_numpy(_pixels(rng, (3, 16, 16, 3), np.uint8))
    with pytest.raises(TypeError, match="int32"):
        port.fused_degrade_normalize(x, torch.tensor([8, 8, 8]), lows=(8, 16))
    with pytest.raises(TypeError, match="int32"):
        port.fused_degrade_normalize(x, torch.tensor([8, 8], dtype=torch.int32), lows=(8, 16))
    with pytest.raises(ValueError, match="outside 8..16"):
        port.fused_degrade_normalize(x, torch.tensor([8, 17, 8], dtype=torch.int32),
                                     lows=(8, 16))
    with pytest.raises(ValueError, match="outside 9..16"):
        port.fused_degrade_normalize(x, torch.tensor([8, 9, 9], dtype=torch.int32),
                                     lows=(9, 16))
    with pytest.raises(ValueError, match="range"):
        port.lows_key(16, (9, 8), "pil")
    # no range given: every low of 1 ... S
    full = port.fused_degrade_normalize(x, torch.tensor([1, 16, 5], dtype=torch.int32))
    assert torch.isfinite(full.float()).all()


# an H100's shared memory: an SM's, reserved for each CTA, the most a CTA
# may have (cudaDevAttrMaxSharedMemoryPerMultiprocessor,
# ReservedSharedMemoryPerBlock, MaxSharedMemoryPerBlockOptin)
H100_SMEM = (233_472, 1_024, 232_448)


def test_lows_plan_takes_the_largest_over_the_lows(monkeypatch):
    """The plan of the tensor form: the budget of the most CTAs an SM (at
    most the kernel's two) at which every low fits a band height; each low
    at the tallest height (S, 56, 28, ...) whose buffers fit that budget;
    each low's bands cover S; the launch takes the largest of the lows'
    shared memory and the most bands; the kernel's records and spans are
    each low's own layout; and the band structs of every low in one table,
    four a low, in order."""
    heights = (112, 56, 28, 16, 8, 4, 2, 1)
    assert [port.lows_budget(H100_SMEM, n) for n in (1, 2, 3)] == [232_448, 115_712, 76_800]
    for mode in ("pil", "cv2"):
        key = port.lows_key(112, (8, 112), mode)
        for in_bytes in (1, 4):
            plan = port.lows_plan(key, 3, in_bytes, H100_SMEM, 2)
            budget = plan["budget"]
            sizes = []
            for i, (low, rows) in enumerate(zip(range(8, 113), plan["rows"])):
                k = port.operator_key(112, 112, low, mode)

                def size(r, k=k):
                    return port.degrade_layout(k, r, 3, in_bytes)[2]

                assert size(rows) <= budget
                assert all(size(r) > budget for r in heights if r > rows), (mode, low)
                bands = -(-112 // rows)
                assert (bands - 1) * rows < 112 <= bands * rows
                rows_off, low_off, smem = port.degrade_layout(k, rows, 3, in_bytes)
                assert plan["records"][i].tolist() == [rows, rows_off, low_off, smem]
                assert tuple(plan["spans"][i]) == port.band_spans(k, rows)
                sizes.append(size(rows))
            assert plan["smem"] == max(sizes)
            assert plan["bands"] == max(-(-112 // r) for r in plan["rows"])
            if budget < port.lows_budget(H100_SMEM, 1):
                continue
            # one CTA an SM: some low fits no height in half an SM
            assert any(all(port.degrade_layout(port.operator_key(112, 112, low, mode), r, 3,
                                               in_bytes)[2] > port.lows_budget(H100_SMEM, 2)
                           for r in heights) for low in range(8, 113))
        # uint8: two CTAs an SM, whole images up to low 57, then 56 and 28 rows
        u8 = port.lows_plan(key, 3, 1, H100_SMEM, 2)
        assert u8["budget"] == port.lows_budget(H100_SMEM, 2)
        assert u8["rows"] == (112,) * 50 + (56,) * 34 + (28,) * 21
    # float32 pil: an output row of low 8 reads ~100 input rows of 1,344 bytes,
    # more than half an SM at any height, so one CTA an SM: whole images up to
    # low 60, then 56 rows
    f32 = port.lows_plan(port.lows_key(112, (8, 112), "pil"), 3, 4, H100_SMEM, 2)
    assert f32["budget"] == port.lows_budget(H100_SMEM, 1)
    assert f32["rows"] == (112,) * 53 + (56,) * 52
    # low 16, uint8, whole images: 112 staged rows of 336 bytes and 16 of slack
    # (9,412 floats), under them [16][16*3] (768), then [16][112*3] (5,376)
    assert port.degrade_layout(port.operator_key(112, 112, 16, "pil"), 112, 3, 1) == (
        9412, 0, 4 * (9412 + 5376))
    # low 112 (the identity, one tap) in bands of 28: [28][112*3] over the 28
    # staged rows (2,356 floats), then [28][112*3]
    assert port.degrade_layout(port.operator_key(112, 112, 112, "pil"), 28, 3, 1) == (
        28 * 336, 0, 4 * 2 * 28 * 336)
    import ctypes

    arr, dev, _ = port._lows_bands(port.lows_key(32, (8, 12), "cv2"), torch.device("cpu"))
    assert len(arr) == 4 * 5 and dev.numel() == 4 * 5 * ctypes.sizeof(port._Band)
    assert [arr[4 * i + 1].n_out for i in range(5)] == [8, 9, 10, 11, 12]
    assert [arr[4 * i + 2].n_in for i in range(5)] == [8, 9, 10, 11, 12]
    # the wrapper plans with the device's sizes and the kernel's CTAs an SM
    monkeypatch.setattr(port, "_lows_device", lambda device: (H100_SMEM, 2))
    port._lows_records.cache_clear()
    plan, dev_rec = port._lows_records(port.lows_key(32, (8, 12), "cv2"), 1, 4, None,
                                       torch.device("cpu"))
    port._lows_records.cache_clear()
    rec = plan["records"]
    assert dev_rec.dtype == torch.int32 and dev_rec.tolist() == rec.tolist()
    assert rec.shape == (5, 4) and plan["spans"].shape == (5, 2) and (rec[:, 0] == 32).all()


@pytest.mark.parametrize("mode", ["pil", "cv2"])
@pytest.mark.parametrize("in_bytes", [1, 4])
def test_lows_plan_gives_two_ctas_an_sm(mode, in_bytes):
    """The budget leaves two CTAs an SM for every low, uint8 in and float32
    cv2 in: the launch's shared memory (the largest low's) and the 1 KB an
    SM reserves for each CTA, twice, within the SM's 228 KB. Float32 pil
    in plans one CTA an SM (its lows 8-10 fit no height in half an SM) and
    then fits the most a CTA may have. A uniform height gives the lows one
    layout each and no more than the plan of old (one layout for all, sized
    by the largest span, input span and width)."""
    key = port.lows_key(112, (8, 112), mode)
    plan = port.lows_plan(key, 3, in_bytes, H100_SMEM, 2)
    ctas = 1 if (mode, in_bytes) == ("pil", 4) else 2
    sm, reserved, per_cta = H100_SMEM
    assert plan["budget"] == port.lows_budget(H100_SMEM, ctas)
    assert ctas * (plan["smem"] + reserved) <= sm and plan["smem"] <= per_cta
    assert plan["bands"] <= 7 and min(plan["rows"]) >= 16
    rows = 56 if in_bytes == 1 else 28          # the plan of old, read on the card
    old = {("pil", 1): 188512, ("pil", 4): 224464, ("cv2", 1): 178096,
           ("cv2", 4): 182800}[mode, in_bytes]
    uniform = port.lows_plan(key, 3, in_bytes, H100_SMEM, 2, rows)
    assert uniform["smem"] <= old and uniform["budget"] is None
    assert uniform["rows"] == (rows,) * 105


@pytest.mark.parametrize("s, c, in_bytes, ctas", [(128, 1, 1, 2), (128, 3, 4, 1), (96, 3, 1, 2),
                                                   (64, 3, 4, 2)])
def test_lows_plan_at_other_sizes(s, c, in_bytes, ctas):
    """Sizes other than 112²x3: the plan takes the most CTAs an SM at which
    every low fits, and each low its tallest height in that budget."""
    key = port.lows_key(s, (8, s), "pil")
    plan = port.lows_plan(key, c, in_bytes, H100_SMEM, 2)
    assert plan["budget"] == port.lows_budget(H100_SMEM, ctas)
    assert plan["smem"] <= plan["budget"] and len(plan["rows"]) == s - 7
    for low, rows in zip(range(8, s + 1), plan["rows"]):
        k = port.operator_key(s, s, low, "pil")
        assert port.degrade_layout(k, rows, c, in_bytes)[2] <= plan["budget"]
        taller = [r for r in (s, 56, 28, 16, 8, 4, 2, 1) if rows < r <= s]
        assert all(port.degrade_layout(k, r, c, in_bytes)[2] > plan["budget"] for r in taller)


def test_lows_plan_refuses_a_size_no_height_fits():
    """A low that fits no band height in the most a CTA may have raises,
    naming the low, rather than plan a launch the kernel would refuse."""
    with pytest.raises(ValueError, match="low 8 of 512x512x3 .* fits no band height"):
        port.lows_plan(port.lows_key(512, (8, 9), "pil"), 3, 4, H100_SMEM, 2)

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


def test_lows_plan_takes_the_largest_over_the_lows():
    """The shared-memory plan of the tensor form: ``band_spans`` the largest
    over the lows at every band height, and the band structs of every low
    in one table, four a low, in order."""
    key = port.lows_key(112, (8, 112), "pil")
    for rows in (112, 56, 28):
        spans = [port.band_spans(port.operator_key(112, 112, low, "pil"), rows)
                 for low in range(8, 113)]
        assert port.band_spans(key, rows) == (max(s for s, _ in spans), max(s for _, s in spans))
    import ctypes

    arr, dev, _ = port._lows_bands(port.lows_key(32, (8, 12), "cv2"), torch.device("cpu"))
    assert len(arr) == 4 * 5 and dev.numel() == 4 * 5 * ctypes.sizeof(port._Band)
    assert [arr[4 * i + 1].n_out for i in range(5)] == [8, 9, 10, 11, 12]
    assert [arr[4 * i + 2].n_in for i in range(5)] == [8, 9, 10, 11, 12]

"""crfr_torch.ops.bicubic against crfr.ops.bicubic on the CPU: the matrix
builders bit for bit, the float resizes at float32 tolerance (atol 1e-4).

The uint8 pipelines round ``floor(x + 0.5)`` after float32 sums. Where the
exact value of a sum lies within float32 rounding error of a half-integer,
the two stacks' summation orders decide the rounding. The tests therefore
replay each pipeline in float64 and mark every pixel that depends on such a
tie (a pre-rounding value within 1e-4 of k + 0.5, at any stage, carried
through the later passes' taps). Every other pixel must equal both crfr's
output and the float64 ``floor(x + 0.5)`` result exactly; a marked pixel may
differ by one level. Exact ties are pinned to half-up by their own test."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.ops import bicubic as ref
from crfr_torch.ops import bicubic as port

# the sizes of tests/test_bicubic.py
SIZES = [(112, 16), (112, 8), (16, 112), (112, 112), (100, 37), (24, 112),
         (112, 56), (56, 112), (50, 20)]


@pytest.mark.parametrize("mode", ["pil", "cv2"])
@pytest.mark.parametrize("in_size,out_size", SIZES)
def test_matrix_builders_bit_equal(mode, in_size, out_size):
    build = {"pil": (ref._pil_matrix, port._pil_matrix),
             "cv2": (ref._cv2_matrix, port._cv2_matrix)}[mode]
    want, got = (f(in_size, out_size) for f in build)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.array_equal(port.resize_matrix(in_size, out_size, mode),
                          ref.resize_matrix(in_size, out_size, mode))


@pytest.mark.parametrize("mode", ["pil", "cv2"])
@pytest.mark.parametrize("size,low", [(112, 16), (112, 8), (32, 8), (56, 37)])
def test_degrade_matrix_bit_equal(mode, size, low):
    got = port.degrade_matrix(size, low, mode)
    want = ref.degrade_matrix(size, low, mode)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown resize mode"):
        port.resize_matrix(10, 5, "lanczos")


TIE = 1e-4


def _u8_oracle(x, passes):
    """float64 replay of a chain of rounding passes ``(matrix, axis)``:
    the rounded result and the mask of pixels that depend on a near-tie."""
    y = x.astype(np.float64)
    tied = np.zeros(y.shape, bool)
    for w, axis in passes:
        taps = (w != 0).astype(np.float64)
        eq = "...ijc,pj->...ipc" if axis == "cols" else "...ijc,oi->...ojc"
        pre = np.einsum(eq, y, w.astype(np.float64))
        fed = np.einsum(eq, tied.astype(np.float64), taps) > 0
        tied = fed | (np.abs(pre - np.floor(pre) - 0.5) < TIE)
        y = np.clip(np.floor(pre + 0.5), 0.0, 255.0)
    return y, tied


def _assert_u8_equal(got, want, x, passes):
    exact, tied = _u8_oracle(x, passes)
    assert tied.mean() < 0.05, tied.mean()
    np.testing.assert_array_equal(got[~tied], want[~tied])
    np.testing.assert_array_equal(got[~tied], exact[~tied])
    assert np.array_equal(got, np.clip(np.round(got), 0, 255))
    assert np.abs(got - want).max() <= 1


def _resize_passes(shape, out_hw, mode):
    h, w = shape[-3:-1]
    return [(ref.resize_matrix(w, out_hw[1], mode), "cols"),
            (ref.resize_matrix(h, out_hw[0], mode), "rows")]


def _img(rng, shape):
    return rng.integers(0, 256, size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["pil", "cv2"])
@pytest.mark.parametrize("shape,out_hw", [((2, 112, 112, 3), (16, 16)),
                                          ((40, 30, 3), (56, 64)),
                                          ((24, 24), (112, 112))])
def test_resize_float_matches(rng, mode, shape, out_hw):
    x = _img(rng, shape)
    want = np.asarray(ref.resize_bicubic(jnp.asarray(x), out_hw, mode))
    got = port.resize_bicubic(torch.from_numpy(x), out_hw, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["pil", "cv2"])
@pytest.mark.parametrize("shape,out_hw", [((2, 112, 112, 3), (16, 16)),
                                          ((2, 16, 16, 3), (112, 112))])
def test_resize_u8_pipeline_matches(rng, mode, shape, out_hw):
    x = _img(rng, shape)
    want = np.asarray(ref.resize_bicubic(jnp.asarray(x), out_hw, mode,
                                         u8_pipeline=True))
    got = port.resize_bicubic(torch.from_numpy(x), out_hw, mode,
                              u8_pipeline=True).numpy()
    _assert_u8_equal(got, want, x, _resize_passes(shape, out_hw, mode))


@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_degrade_float_matches(rng, mode):
    x = _img(rng, (3, 112, 112, 3))
    want = np.asarray(ref.degrade_updown(jnp.asarray(x), 16, mode))
    got = port.degrade_updown(torch.from_numpy(x), 16, mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_degrade_round_intermediate_matches(rng, mode):
    x = _img(rng, (2, 112, 112, 3))
    want = np.asarray(ref.degrade_updown(jnp.asarray(x), 16, mode,
                                         round_intermediate=True))
    got = port.degrade_updown(torch.from_numpy(x), 16, mode,
                              round_intermediate=True).numpy()
    passes = _resize_passes(x.shape, (16, 16), mode) + _resize_passes((16, 16, 3), (112, 112), mode)
    _assert_u8_equal(got, want, x, passes)


@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_u8_pipeline_rounds_exact_ties_half_up(mode):
    """A same-size resize is the identity, so half-integer pixels reach the
    rounding exactly: floor(x + 0.5), clipped, as crfr rounds them."""
    x = (np.arange(-2, 64, dtype=np.float32).reshape(1, 2, 11, 3) * 4.0 + 0.5)
    x[0, 0, 0] = [254.5, 255.5, 256.5]
    want = np.asarray(ref.resize_bicubic(jnp.asarray(x), (2, 11), mode, u8_pipeline=True))
    got = port.resize_bicubic(torch.from_numpy(x), (2, 11), mode, u8_pipeline=True).numpy()
    np.testing.assert_array_equal(got, np.clip(np.floor(x + 0.5), 0, 255))
    np.testing.assert_array_equal(got, want)


def test_uint8_input_promotes(rng):
    x = rng.integers(0, 256, size=(1, 32, 32, 3)).astype(np.uint8)
    got = port.degrade_updown(torch.from_numpy(x), 8)
    assert got.dtype == torch.float32
    want = np.asarray(ref.degrade_updown(jnp.asarray(x, jnp.float32), 8))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

"""Kernel 2's ragged forms on the CPU: the pyramid (every level of one
photo) and the crops (every box of one stage), against ``crfr``'s native
level and crop resizes, and their launch plans.

``crfr``'s detector resizes on the host with its C++ bicubic in float64
(``crfr/models/mtcnn.py:206-228`` for crops, ``:294`` for levels); the
plain versions here resize in float32 and normalize. Tolerance 2e-5 in
normalized units (2.6e-3 of a pixel level), as ``test_torch_mtcnn.py``
holds ``crop_resize``: the float32 sums of up to ~140 taps of values up to
255 round to a few 1e-6. The CUDA kernels run only on the card
(``tests/test_torch_kernels_gpu.py``); here the wrappers take the plain
versions, and the plans (which tiles and bands a launch would run, and
what shared memory they take) are checked as pure Python.
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

from crfr.models import mtcnn as rm
from crfr_torch.models import mtcnn as pm
from crfr_torch.ops import fused_preprocess as fp
from tests.test_torch_align import crfr_native  # noqa: F401 (fixture)
from tests.test_torch_mtcnn import twins  # noqa: F401 (fixture)

ATOL = 2e-5


def _norm(a: np.ndarray) -> np.ndarray:
    return (a - 127.5) / 128.0


def _photo(rng, h, w, dtype):
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return img if dtype == np.uint8 else img.astype(np.float32)


# (x1, y1, x2, y2) on a 240×320 photo, by what they exercise
BOXES = {
    "inside": [[10, 20, 58, 68], [100, 50, 500 // 2, 200], [30, 30, 42, 42]],
    "partly_outside": [[-30, -20, 50, 60], [280, 200, 360, 280], [-5, 100, 40, 145]],
    "wholly_outside": [[-90, -60, -10, -5], [330, 10, 400, 80], [0, 250, 30, 280]],
    "no_area": [[20, 20, 20, 60], [40, 50, 80, 50], [60, 60, 30, 90]],
    "cw_ne_ch": [[10, 10, 90, 40], [50, 0, 62, 200], [100, 100, 300, 113]],
    "sides_12_to_400": [[0, 0, 12, 12], [-40, -80, 360, 320], [150, 100, 350, 300]],
}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size", [24, 48])
@pytest.mark.parametrize("kind", sorted(BOXES))
def test_crop_plain_version_matches_crfrs_native_crop(crfr_native, kind, size, dtype):
    rng = np.random.default_rng(len(kind) + size)
    img = _photo(rng, 240, 320, dtype)
    boxes = np.asarray(BOXES[kind], np.int32)
    want = _norm(rm.crop_resize(img.astype(np.float32), boxes.astype(np.float32), size))
    got = fp.fused_crop_resize_normalize_reference(torch.from_numpy(img), boxes, size)
    assert got.dtype == torch.float32 and got.shape == (3, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(fp.fused_crop_resize_normalize(torch.from_numpy(img), boxes, size), got)
    if kind == "no_area":
        assert (got == -127.5 / 128.0).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pyramid_plain_version_matches_crfrs_native_levels(crfr_native, dtype):
    """A 640×480 photo at min_face 20: its ten levels, each from the photo."""
    img = _photo(np.random.default_rng(3), 480, 640, dtype)
    sizes = [hw for _, hw in pm.MTCNN(min_face=20, device="cpu").pyramid_sizes(480, 640)]
    assert len(sizes) == 10 and sizes[-1] == (14, 18)
    x = torch.from_numpy(img)[None]
    got = fp.fused_pyramid_normalize_reference(x, sizes)
    assert [tuple(g.shape) for g in got] == [(1, *hw, 3) for hw in sizes]
    for hw, g in zip(sizes, got):
        want = _norm(crfr_native.resize_bicubic(img.astype(np.float32), hw, "pil"))
        np.testing.assert_allclose(g[0].numpy(), want, rtol=0, atol=ATOL)
    wrapped = fp.fused_pyramid_normalize(x, sizes)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("hw", [(120, 160), (117, 200)])
def test_detect_on_the_cpu_equals_crfrs(twins, crfr_native, hw):  # noqa: F811
    """The cascade at thresholds (0.3, 0, 0) through the ragged forms' plain
    versions: crfr's detections (boxes and landmarks within 1e-3 px, scores
    within 1e-5, as test_torch_mtcnn.py)."""
    ref, port = twins
    img = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3)).astype(np.uint8)
    want, got = ref.detect(img), port.detect(img)
    assert len(want.boxes) > 0
    assert got.boxes.shape == want.boxes.shape and got.landmarks.shape == want.landmarks.shape
    np.testing.assert_allclose(got.boxes, want.boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.landmarks, want.landmarks, rtol=0, atol=1e-3)


def _coverage(plan, sizes):
    cover = [np.zeros(hw, np.int32) for hw in sizes]
    for level, o0, n, q0, m in plan["tiles"]:
        cover[level][o0:o0 + n, q0:q0 + m] += 1
    return cover


@pytest.mark.parametrize("in_bytes", [1, 4])
@pytest.mark.parametrize("hw,deepest_ctas", [((480, 640), 10), ((720, 1280), 10),
                                             ((37, 411), 1)])
def test_pyramid_plan_covers_every_output_once(hw, deepest_ctas, in_bytes):
    """Each level's outputs in exactly one tile; every tile's sums and one
    staged row within the shared memory asked for; the costliest first;
    each level's output 64-element aligned in one buffer."""
    h, w = hw
    sizes = tuple(hw for _, hw in pm.MTCNN(min_face=20, device="cpu").pyramid_sizes(h, w))
    plan = fp.pyramid_plan(h, w, 3, in_bytes, sizes, "pil")
    assert all((c == 1).all() for c in _coverage(plan, sizes))
    costs = []
    for level, o0, n, q0, m in plan["tiles"]:
        (oh, ow) = sizes[level]
        vs, vt = fp.band_table(h, oh)
        hs, ht = fp.band_table(w, ow)
        nl = int(vs[o0 + n - 1]) + vt.shape[1] - int(vs[o0])
        pitch = (int(hs[q0 + m - 1]) + ht.shape[1] - int(hs[q0])) * 3 * in_bytes
        assert nl * m * 3 * 4 <= plan["taps_off"] <= fp.TILE_SUMS_BYTES
        assert m * ht.shape[1] * 4 <= plan["stage_off"] - plan["taps_off"]
        assert pitch <= plan["smem"] - plan["stage_off"] <= fp.STAGE_BYTES
        costs.append(nl * m * 3 * ht.shape[1] + n * m * 3 * vt.shape[1])
    assert costs == sorted(costs, reverse=True)
    ends = [o + oh * ow * 3 for o, (oh, ow) in zip(plan["offsets"], sizes)]
    assert all(o % 64 == 0 for o in plan["offsets"]) and plan["total"] >= ends[-1]
    assert all(e <= o for e, o in zip(ends, plan["offsets"][1:]))
    # a photo's deepest level gets tens of CTAs, not the two of a launch a level
    assert sum(t[0] == len(sizes) - 1 for t in plan["tiles"]) >= deepest_ctas


def test_crop_plan_bands_and_refusal():
    """Bands of CROP_ROWS output rows across the crop for small boxes,
    shorter bands, then narrower tiles, for long downscales, within the
    shared memory asked for; a box whose one output reads more raises."""
    small = fp.crop_plan([20, 30, 40], [20, 35], 24, 3, 1, "pil")
    assert small["rows"] == fp.CROP_ROWS and small["taps_off"] <= fp.TILE_SUMS_BYTES
    big = fp.crop_plan([400, 20], [400], 48, 3, 4, "pil")
    assert big["rows"] < fp.CROP_ROWS
    assert big["taps_off"] <= fp.TILE_SUMS_BYTES and big["taps_off"] < big["stage_off"] < big["smem"]
    assert big["smem"] - big["stage_off"] <= fp.STAGE_BYTES
    assert fp.crop_plan([], [], 24, 3, 1, "pil")["rows"] == fp.CROP_ROWS
    # a 703 px box (an R-net candidate of a 1280×720 photo): one-row bands
    # of narrower column tiles
    wide = fp.crop_plan([703, 30], [703], 24, 3, 1, "pil")
    assert wide["rows"] == 1 and wide["cols"] < 24
    assert wide["taps_off"] <= fp.TILE_SUMS_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        fp.crop_plan([40000], [30], 24, 3, 1, "pil")


def test_crop_windows_point_at_each_sides_tables():
    """The per-crop records: each box's origin, its two factors' cached band
    tables (one a side), zeros for a box with no area, one output a crop."""
    boxes = np.asarray([[5, 6, 35, 46], [-3, 2, 27, 12], [4, 4, 4, 9]], np.int64)
    win, heights, widths, tables = fp._crop_windows(boxes, 24, 3, "pil", torch.device("cpu"))
    assert fp._WINDOW_DTYPE.itemsize == 80             # crfr_window: two 32-byte bands, 16
    assert list(heights) == [40, 10] and list(widths) == [30, 30]
    assert len(tables) == 3                          # sides 10, 30, 40, each once
    for rec, side in ((win["v"], 40), (win["h"], 30)):
        start, taps = fp._device_table(side, 24, "pil", torch.device("cpu"))
        assert rec["start"][0] == start.data_ptr() and rec["taps"][0] == taps.data_ptr()
        assert (rec["n_in"][0], rec["n_out"][0], rec["n_taps"][0]) == (side, 24, taps.shape[0])
    assert win["v"]["n_in"][2] == 0 and win["v"]["start"][2] == 0
    assert list(win["x0"]) == [5, -3, 4] and list(win["y0"]) == [6, 2, 4]
    assert list(win["out"]) == [0, 24 * 24 * 3, 2 * 24 * 24 * 3]


def test_ragged_forms_refuse_bad_arguments():
    img = torch.zeros((20, 30, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match=r"\(N, 4\)"):
        fp.fused_crop_resize_normalize(img, np.zeros((2, 3), np.int32), 24)
    with pytest.raises(TypeError, match=r"\(N, 4\)"):
        fp.fused_crop_resize_normalize(img, np.zeros((2, 4), np.float32), 24)
    with pytest.raises(ValueError, match="one image"):
        fp.fused_crop_resize_normalize(img[None], np.zeros((1, 4), np.int32), 24)
    with pytest.raises(ValueError, match="one photo"):
        fp.fused_pyramid_normalize(torch.zeros((2, 20, 30, 3), dtype=torch.uint8), [(12, 12)])
    with pytest.raises(ValueError, match="positive"):
        fp.fused_pyramid_normalize(img[None], [(0, 12)])
    assert fp.fused_crop_resize_normalize(img, np.zeros((0, 4), np.int32), 24).shape == \
        (0, 24, 24, 3)
    assert fp.fused_pyramid_normalize(img[None], []) == []

"""crfr_torch.ops.similarity and ops.warp against crfr's on the CPU, and
the aligned uint8 crops of ``FaceRecognizer.detect_and_align`` and
``pack_aligned_list`` against crfr's (its C++ ``align_crop``).

Tolerances. The matrices: the 2×2 part within 1e-5; the translation within
1e-5 plus 2e-7 of the coordinates' scale (the largest source plus the
largest template coordinate, ~250 px here). It is the difference of two
terms of ~100 px (mean target − M·mean source), so a few float32 ulps of
those terms (7.6e-6 each) decide it, and crfr's own translation stands
~1.6e-5 off a float64 solve. The float warp
of the same matrix: within 1e-3, plus 5e-5 px of coordinate error times the
bilinear gradient at the pixel (the two stacks round the inverse-mapped
coordinates differently; on noise images a gradient of 255 a pixel turns
one ulp of a 200 px coordinate into ~4e-3). The uint8 crops round
``floor(x + 0.5)``: a float64 replay of the solve and the warp marks every
pixel within float32 error of a half-integer (1e-3 plus the gradient times
a coordinate error of 1e-4 px + 2e-7 of the coordinate); every other pixel must equal crfr's and the replay's exactly,
a marked one may differ by one level (the rule of test_torch_bicubic.py).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr import native
from crfr.data import records as ref_records
from crfr.ops import similarity as rs
from crfr.ops import warp as rw
from crfr_torch.data.records import PackSource, pack_aligned_list
from crfr_torch.ops import REFERENCE_LANDMARKS_112 as PORT_TEMPLATE
from crfr_torch.ops import similarity as ps
from crfr_torch.ops import warp as pw
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)

T = rs.REFERENCE_LANDMARKS_112


def assert_mats(got, want, src, dst=T):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-5)
    scale = np.abs(src).max() + np.abs(dst).max()
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5 + 2e-7 * scale)


def _landmarks(rng, n, mirror=False):
    lm = (T[None] * rng.uniform(0.8, 2.0, (n, 1, 1)) + rng.normal(0, 3, (n, 5, 2)) + 30)
    if mirror:
        lm[..., 0] = 200 - lm[..., 0]
    return lm.astype(np.float32)


def test_templates_are_crfrs():
    assert np.array_equal(PORT_TEMPLATE, rs.REFERENCE_LANDMARKS_112)
    assert np.array_equal(ps.REFERENCE_LANDMARKS_96x112, rs.REFERENCE_LANDMARKS_96x112)


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("reflect", [False, True])
def test_solve_matches_crfr(rng, reflect, mirror):
    lms = _landmarks(rng, 8, mirror)
    want = np.stack([np.asarray(rs.similarity_transform(jnp.asarray(x), jnp.asarray(T), reflect))
                     for x in lms])
    got = ps.similarity_transform(lms, T, reflect)
    assert got.dtype == torch.float32 and got.shape == (8, 2, 3)
    assert_mats(got, want, lms)
    if reflect and mirror:        # the mirrored faces take the reflected solve
        assert (np.linalg.det(want[:, :, :2]) < 0).all()


def test_umeyama_matches_crfr(rng):
    lms = _landmarks(rng, 8)
    want = np.stack([np.asarray(rs.umeyama_transform(jnp.asarray(x), jnp.asarray(T)))
                     for x in lms])
    assert_mats(ps.umeyama_transform(lms, T), want, lms)
    np.testing.assert_allclose(ps.umeyama_transform(lms, T).numpy(),
                               ps.similarity_transform(lms, T).numpy(), rtol=1e-4, atol=1e-3)


def test_inverse_and_batch_match_crfr(rng):
    lms = _landmarks(rng, 8)
    want = np.asarray(rs.align_matrix_batch(jnp.asarray(lms), jnp.asarray(T), False))
    got = ps.align_matrix_batch(lms)
    assert_mats(got, want, lms)
    inv = np.stack([np.asarray(rs.invert_affine(jnp.asarray(m))) for m in want])
    assert_mats(ps.invert_affine(want), inv, lms)
    # one face through align_matrix equals its row of the batch
    assert torch.equal(ps.align_matrix(lms[3]), got[3])


def _replay(img, lm, out_size):
    """float64 solve + inverse-map bilinear warp, as crfr's C++ computes
    them: the values at each output pixel and their float32 slack."""
    img = img.astype(np.float64)
    src, dst = lm.astype(np.float64), T.astype(np.float64)
    ms, md = src.mean(0), dst.mean(0)
    x, y = (src - ms).T
    u, v = (dst - md).T
    den = (x * x + y * y).sum()
    a, b = (x * u + y * v).sum() / den, (x * v - y * u).sum() / den
    m = np.array([[a, -b], [b, a]])
    t = md - m @ ms
    mi = np.linalg.inv(m)
    ti = -mi @ t
    yo, xo = np.mgrid[0:out_size, 0:out_size].astype(np.float64)
    xs = mi[0, 0] * xo + mi[0, 1] * yo + ti[0]
    ys = mi[1, 0] * xo + mi[1, 1] * yo + ti[1]
    val, grad = _bilinear64(img, xs, ys)
    coord = np.maximum(np.abs(xs), np.abs(ys))[..., None]
    return val, 1e-3 + (1e-4 + 2e-7 * coord) * grad


def _bilinear64(img, xs, ys):
    h, w = img.shape[:2]
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]

    def at(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return img[yy.clip(0, h - 1), xx.clip(0, w - 1)] * ok[..., None]

    v00, v01, v10, v11 = at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    val = (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy
    grad = (np.abs((v01 - v00) * (1 - fy) + (v11 - v10) * fy)
            + np.abs((v10 - v00) * (1 - fx) + (v11 - v01) * fx))
    return val, grad


def test_float_warp_matches_crfr(rng):
    img = rng.integers(0, 256, (4, 200, 180, 3)).astype(np.float32)
    mats = np.asarray(rs.align_matrix_batch(jnp.asarray(_landmarks(rng, 4)), jnp.asarray(T),
                                            False))
    want = np.asarray(rw.warp_affine_batch(jnp.asarray(img), jnp.asarray(mats), (112, 112)))
    got = pw.warp_affine_batch(torch.from_numpy(img), torch.from_numpy(mats), (112, 112))
    assert got.dtype == torch.float32 and got.shape == (4, 112, 112, 3)
    inv = np.stack([np.asarray(rs.invert_affine(jnp.asarray(m))) for m in mats]).astype(np.float64)
    yo, xo = np.mgrid[0:112, 0:112].astype(np.float64)
    for i in range(4):
        xs = inv[i, 0, 0] * xo + inv[i, 0, 1] * yo + inv[i, 0, 2]
        ys = inv[i, 1, 0] * xo + inv[i, 1, 1] * yo + inv[i, 1, 2]
        _, grad = _bilinear64(img[i], xs, ys)
        diff = np.abs(got[i].numpy() - want[i])
        assert (diff <= 1e-3 + 5e-5 * grad).all(), (diff - 5e-5 * grad).max()
    assert np.median(np.abs(got.numpy() - want)) < 1e-4
    # one image warped by several matrices = the image repeated
    rep = pw.warp_affine_batch(torch.from_numpy(img[:1]), torch.from_numpy(mats), (112, 112))
    each = pw.warp_affine_batch(torch.from_numpy(np.repeat(img[:1], 4, 0)),
                                torch.from_numpy(mats), (112, 112))
    assert torch.equal(rep, each)
    one = pw.align_crop(torch.from_numpy(img[0]), torch.from_numpy(_landmarks(rng, 1)[0]))
    assert one.shape == (112, 112, 3)


def assert_u8_crops(got, want, img, lms, out_size=112):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    tied_all = 0
    for g, w, lm in zip(got, want, lms):
        val, slack = _replay(img, lm, out_size)
        tied = np.abs(val - np.floor(val) - 0.5) < slack
        exact = np.clip(np.floor(val + 0.5), 0, 255)
        np.testing.assert_array_equal(g[~tied], w[~tied])
        np.testing.assert_array_equal(g[~tied], exact[~tied])
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        tied_all += tied.sum()
    assert tied_all < 0.05 * got.size, tied_all / got.size


def test_align_faces_match_crfrs_native_crop(rng):
    assert native.available()
    img = rng.integers(0, 256, (200, 180, 3)).astype(np.uint8)
    lms = _landmarks(rng, 5)
    want = np.stack([native.align_crop(img, lm, out_size=112) for lm in lms])
    got = pw.align_faces(img, lms, 112, device="cpu").numpy()
    assert_u8_crops(got, want, img, lms)


def _write_pngs(rng, tmp_path, n=4):
    from PIL import Image

    lines = []
    for i in range(n):
        img = rng.integers(0, 256, (150 + 10 * i, 140, 3)).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / f"f{i}.png")
        lm = _landmarks(rng, 1)[0] * 0.9
        lines.append(f"f{i}.png {i % 3} " + " ".join(f"{v:.4f}" for v in lm.reshape(-1)))
    lines.insert(2, "a line without landmarks 7")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    return tmp_path / "list.txt"


def test_pack_aligned_list_matches_crfrs(rng, tmp_path):
    from PIL import Image

    lst = _write_pngs(rng, tmp_path)
    n_ref = ref_records.pack_aligned_list(str(lst), str(tmp_path / "ref.crfrpack"),
                                          root=str(tmp_path), writer=ref_records.write_pack)
    n = pack_aligned_list(str(lst), str(tmp_path / "port.crfrpack"), root=str(tmp_path),
                          device="cpu")
    assert n == n_ref == 4
    ref_src = ref_records.PackSource(str(tmp_path / "ref.crfrpack"))
    port_src = PackSource(str(tmp_path / "port.crfrpack"))
    lines = [ln.split() for ln in lst.read_text().splitlines() if len(ln.split()) == 12]
    for i, parts in enumerate(lines):
        (lw, w), (lg, g) = ref_src[i], port_src[i]
        assert lw == lg == int(parts[1])
        img = np.asarray(Image.open(os.path.join(tmp_path, parts[0])).convert("RGB"))
        lm = np.asarray(parts[2:], np.float32).reshape(1, 5, 2)
        assert_u8_crops(g[None], w[None], img, lm)


def test_pack_aligned_list_needs_pil(monkeypatch, tmp_path):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        pack_aligned_list(str(tmp_path / "l.txt"), str(tmp_path / "o"), device="cpu")

"""Procedural identity renderer (crfr/data/render.py), numpy only.

Face-like images where identity lives in geometry (eye spacing and height,
face shape, mouth width) and fine texture (a per-identity high-frequency
skin pattern and id-specific marks), while the nuisances of the
cross-resolution setting vary per sample: pose (in-plane rotation, scale
and translation by a bilinear affine warp), illumination (a directional
gradient, global gain and bias), a smooth random background, and sensor
noise. ``hard > 0`` adds, each with a probability scaled by ``hard``,
face-attached occlusion (before the pose warp), scene occlusion, motion or
defocus blur, a JPEG round trip and wider pose with a shear term.

``render(..., return_landmarks=True)`` also returns the 5-point landmarks
(le, re, nose, lmouth, rmouth, pixel (x, y)) mapped through the same pose
warp: the targets that supervise the prior estimator in the headline's SR
stage (``experiments.headline``).

A copy of the reference: the same seed gives the same arrays and landmarks.
The JPEG nuisance at ``hard > 0`` needs PIL (the pillow package) and raises
an error naming it where PIL is not installed; nothing else does I/O.
"""

from __future__ import annotations

import numpy as np

# canonical landmark layout the per-identity geometry perturbs, in
# face-relative [0,1] coords
_EYE_Y, _EYE_DX = 0.46, 0.185
_NOSE_Y, _MOUTH_Y = 0.64, 0.82


def _bilinear_up(img: np.ndarray, size: int) -> np.ndarray:
    """(h, w[, c]) → (size, size[, c]) bilinear, edge-clamped."""
    h, w = img.shape[:2]
    ys = np.linspace(0, h - 1, size)
    xs = np.linspace(0, w - 1, size)
    y0 = np.floor(ys).astype(int).clip(0, h - 2)
    x0 = np.floor(xs).astype(int).clip(0, w - 2)
    fy = (ys - y0).reshape(-1, 1)
    fx = (xs - x0).reshape(1, -1)
    if img.ndim == 2:
        fy, fx = fy, fx
    else:
        fy, fx = fy[..., None], fx[..., None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x0 + 1] * (1 - fy) * fx
    c = img[y0 + 1][:, x0] * fy * (1 - fx)
    d = img[y0 + 1][:, x0 + 1] * fy * fx
    return (a + b + c + d).astype(np.float32)


def _affine_sample(img: np.ndarray, mat: np.ndarray, tvec: np.ndarray
                   ) -> np.ndarray:
    """Inverse-map bilinear warp: out(p) = img(mat @ p + tvec).

    img (s, s, c) float32; mat (2, 2), tvec (2,) in pixel coords (y, x).
    Out-of-range samples clamp to the edge (the head mask is warped with
    the same operator, so clamped pixels never show through composites)."""
    s = img.shape[0]
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    sy = mat[0, 0] * yy + mat[0, 1] * xx + tvec[0]
    sx = mat[1, 0] * yy + mat[1, 1] * xx + tvec[1]
    sy = sy.clip(0, s - 1 - 1e-3)
    sx = sx.clip(0, s - 1 - 1e-3)
    y0 = np.floor(sy).astype(int)
    x0 = np.floor(sx).astype(int)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    return (img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0 + 1, x0 + 1] * fy * fx).astype(np.float32)


def _shift_clamped(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Edge-clamped integer shift (no wraparound): used by the blur
    kernels so crop borders smear instead of leaking the opposite edge."""
    s = img.shape[0]
    y = np.clip(np.arange(s) + dy, 0, s - 1)
    x = np.clip(np.arange(s) + dx, 0, s - 1)
    return img[y][:, x]


def _box3(img: np.ndarray) -> np.ndarray:
    """3×3 box filter; k applications ≈ Gaussian σ≈0.55·√k (defocus)."""
    acc = np.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc += _shift_clamped(img, dy, dx)
    return acc / 9.0


def _motion_blur(img: np.ndarray, length: int, dy: int, dx: int
                 ) -> np.ndarray:
    acc = np.zeros_like(img)
    for t in range(length):
        k = t - length // 2
        acc += _shift_clamped(img, dy * k, dx * k)
    return acc / length


def _jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the JPEG nuisance of a renderer with hard > 0 needs PIL (the "
                          "pillow package), which is not installed") from e

    im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=quality)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())),
                      dtype=np.float32)


class RenderedIdentities:
    """num_ids procedurally generated identities at image_size².

    Identity latents are drawn once from ``seed``; per-sample nuisances come
    from the Generator passed to ``sample``/``batches`` — two datasets built
    with the same seed render the SAME people (train/eval identity splits
    are taken by index range on one instance instead)."""

    _EAGER_TEX_MAX = 4096            # above: lazy per-render upsampling

    def __init__(self, num_ids: int, image_size: int = 112, seed: int = 0,
                 texture_weight: float = 42.0, fine: int = 24,
                 hard: float = 0.0):
        self.num_ids = num_ids
        self.image_size = image_size
        self.hard = float(hard)          # HR-nuisance intensity, 0 = legacy
        g = np.random.default_rng(seed)
        n = num_ids
        self.geom = {
            # landmark geometry offsets (face-relative units)
            "eye_y": _EYE_Y + g.uniform(-0.03, 0.03, n),
            "eye_dx": _EYE_DX + g.uniform(-0.035, 0.035, n),
            "eye_rx": g.uniform(0.055, 0.095, n),
            "eye_ry": g.uniform(0.032, 0.058, n),
            "nose_y": _NOSE_Y + g.uniform(-0.03, 0.03, n),
            "nose_w": g.uniform(0.18, 0.38, n),
            "mouth_y": _MOUTH_Y + g.uniform(-0.025, 0.025, n),
            "mouth_w": g.uniform(0.10, 0.17, n),
            "mouth_h": g.uniform(0.022, 0.05, n),
            "head_rx": g.uniform(0.36, 0.46, n),
            "head_ry": g.uniform(0.42, 0.52, n),
            "brow": g.uniform(0.0, 1.0, n),          # eyebrow darkness
        }
        # NARROW skin band + strong per-sample photometric jitter below:
        # tone must not identify anyone at 8 px (identity belongs to
        # geometry + fine texture, which downsampling destroys)
        base = g.uniform(160, 190, (n, 1))
        self.skin = (base + g.uniform(-8, 8, (n, 3))).astype(np.float32)
        self.mouth_rgb = (np.asarray([150, 50, 50], np.float32)
                          * g.uniform(0.7, 1.3, (n, 1))).astype(np.float32)
        # per-identity fine skin texture: high-frequency pattern, zero-mean
        tex = g.uniform(-1, 1, (n, fine, fine))
        if n <= self._EAGER_TEX_MAX:
            self.texture = np.stack([_bilinear_up(t, image_size)
                                     for t in tex])
            self.texture -= self.texture.mean(axis=(1, 2), keepdims=True)
            self._tex_fine = None
        else:
            # MS1M-scale id counts: 85,742 ids × 112² f32 upsampled
            # textures = 4.3 GB — keep the (n, fine, fine) latents and
            # upsample per render instead (bitwise the same values)
            self.texture = None
            self._tex_fine = tex
        self.texture_weight = texture_weight
        # id-specific marks (moles/scars): dark spots at fixed face coords
        self.marks = g.uniform(0.25, 0.8, (n, 3, 2)).astype(np.float32)
        self.mark_r = g.uniform(0.012, 0.03, (n, 3)).astype(np.float32)

        s = image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        self._yy, self._xx = yy, xx

    def _tex(self, i: int) -> np.ndarray:
        if self.texture is not None:
            return self.texture[i]
        up = _bilinear_up(self._tex_fine[i], self.image_size)
        return up - up.mean()

    # -- canonical (pose-free) render of one identity ------------------
    def _canonical(self, i: int, rng: np.random.Generator) -> np.ndarray:
        gm, yy, xx = self.geom, self._yy, self._xx
        img = np.zeros((self.image_size, self.image_size, 3), np.float32)
        head = (((xx - 0.5) / gm["head_rx"][i]) ** 2
                + ((yy - 0.52) / gm["head_ry"][i]) ** 2) <= 1.0
        skin = self.skin[i] * rng.uniform(0.96, 1.04)
        img[head] = skin
        # fine texture + marks only inside the head (identity detail)
        img += (self.texture_weight * self._tex(i)[..., None]
                * head[..., None])
        for (my, mx), r in zip(self.marks[i], self.mark_r[i]):
            m = ((xx - mx) ** 2 + (yy - my) ** 2 <= r ** 2) & head
            img[m] *= 0.55
        # eyes + brows
        ey, edx = gm["eye_y"][i], gm["eye_dx"][i]
        for ex in (0.5 - edx, 0.5 + edx):
            m = (((xx - ex) / gm["eye_rx"][i]) ** 2
                 + ((yy - ey) / gm["eye_ry"][i]) ** 2) <= 1.0
            img[m] = rng.uniform(15, 50)
            b = (np.abs(xx - ex) <= gm["eye_rx"][i] * 1.3) & \
                (np.abs(yy - (ey - 0.07)) <= 0.012 + 0.012 * gm["brow"][i])
            img[b] = skin * (0.45 + 0.2 * gm["brow"][i])
        # nose wedge
        ny = gm["nose_y"][i]
        m = (np.abs(xx - 0.5) <= (yy - (ny - 0.16)) * gm["nose_w"][i]) \
            & (yy <= ny) & (yy >= ny - 0.16)
        img[m] = skin * 1.12
        # mouth
        mw, mh, my_ = gm["mouth_w"][i], gm["mouth_h"][i], gm["mouth_y"][i]
        m = (np.abs(xx - 0.5) <= mw) & (np.abs(yy - my_) <= mh)
        img[m] = self.mouth_rgb[i] * rng.uniform(0.85, 1.15)
        return img, head.astype(np.float32)

    # -- face-attached occluders (pre-warp, so they ride the head) -----
    def _occlude_face(self, face: np.ndarray, i: int,
                      rng: np.random.Generator) -> None:
        gm, yy, xx = self.geom, self._yy, self._xx
        kind = int(rng.integers(3))
        if kind == 0:                                    # sunglasses band
            hh = rng.uniform(0.05, 0.09)
            band = (np.abs(yy - gm["eye_y"][i]) <= hh) & \
                   (np.abs(xx - 0.5) <= gm["eye_dx"][i] + 0.13)
            face[band] = rng.uniform(8, 45)
        elif kind == 1:                                  # mask/scarf
            top = rng.uniform(gm["nose_y"][i] - 0.04, gm["nose_y"][i] + 0.06)
            fabric = rng.uniform(40, 220, 3).astype(np.float32)
            band = yy >= top
            face[band] = fabric + rng.normal(0, 8, (int(band.sum()), 3))
        else:                                            # random facial patch
            cy, cx = rng.uniform(0.3, 0.85), rng.uniform(0.2, 0.8)
            r = rng.uniform(0.08, 0.16)
            m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r ** 2
            face[m] = rng.uniform(10, 230, 3)

    # -- one posed/lit sample ------------------------------------------
    def render(self, i: int, rng: np.random.Generator,
               return_landmarks: bool = False):
        s = self.image_size
        h = self.hard
        face, mask = self._canonical(i, rng)
        if h > 0 and rng.uniform() < 0.5 * h:
            self._occlude_face(face, i, rng)
        # pose: rotation + scale + shift (+ shear when hard); inverse map:
        # out → source coords
        th = rng.uniform(-1, 1) * (0.22 + 0.14 * h)      # ±12.6° … ±20.6°
        sc = 1.0 / rng.uniform(0.9 - 0.08 * h, 1.1 + 0.14 * h)
        shear = rng.uniform(-0.16, 0.16) * h             # out-of-plane proxy
        rot = np.asarray([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]], np.float32)
        rot = rot @ np.asarray([[1.0, shear], [0.0, 1.0]], np.float32) * sc
        c = (s - 1) / 2.0
        shift = rng.uniform(-1, 1, 2) * (0.05 + 0.03 * h) * s
        t = np.asarray([c, c]) - rot @ np.asarray([c + shift[0],
                                                   c + shift[1]])
        face = _affine_sample(face, rot, t)
        mask = _affine_sample(mask[..., None], rot, t)[..., 0]
        # illumination: directional gradient across the crop + gain/bias
        ldir = rng.uniform(0, 2 * np.pi)
        lstr = rng.uniform(0.0, 0.35 + 0.15 * h)
        light = 1.0 + lstr * ((self._xx - 0.5) * np.cos(ldir)
                              + (self._yy - 0.5) * np.sin(ldir)) * 2
        # strong per-sample photometric jitter incl. per-CHANNEL gain:
        # color/tone becomes an unreliable cue, per-identity appearance
        # overlaps across the narrow skin band drawn in __init__
        gain = rng.uniform(0.78, 1.22, 3)
        bias = rng.uniform(-18, 18)
        face = face * light[..., None] * gain + bias
        # background: smooth random gradient
        bg = _bilinear_up(rng.uniform(0, 255, (4, 4, 3)), s)
        out = mask[..., None] * face + (1 - mask[..., None]) * bg
        if h > 0:
            if rng.uniform() < 0.25 * h:                 # scene occluder
                oy, ox = rng.integers(0, s, 2)
                hh, ww = rng.integers(s // 8, s // 3, 2)
                out[oy:oy + hh, ox:ox + ww] = rng.uniform(0, 255, 3)
            if rng.uniform() < 0.5 * h:                  # blur
                if rng.uniform() < 0.5:                  # defocus
                    for _ in range(int(rng.integers(1, 4))):
                        out = _box3(out)
                else:                                    # motion
                    length = int(rng.choice([3, 5, 7]))
                    dy, dx = [(0, 1), (1, 0), (1, 1), (1, -1)][
                        int(rng.integers(4))]
                    out = _motion_blur(out, length, dy, dx)
        out += rng.normal(0, 5, out.shape)
        if h > 0 and rng.uniform() < 0.45 * h:           # JPEG artifacts
            out = _jpeg_roundtrip(out, int(rng.integers(25, 70)))
        out = np.clip(out, 0, 255).astype(np.float32)
        if not return_landmarks:
            return out
        # 5-pt landmarks through the SAME warp: the inverse map samples
        # src = rot @ dst + t, so a canonical (src) point lands at
        # dst = rot⁻¹ @ (src − t). Canonical coords are face-relative
        # [0,1]·s in (y, x); returned landmarks are pixel (x, y) in the
        # (le, re, nose, lmouth, rmouth) order ops/heatmaps.py expects.
        gm = self.geom
        ey, edx = gm["eye_y"][i], gm["eye_dx"][i]
        canon_yx = np.asarray([
            [ey, 0.5 - edx],                             # left eye
            [ey, 0.5 + edx],                             # right eye
            [gm["nose_y"][i], 0.5],                      # nose tip
            [gm["mouth_y"][i], 0.5 - gm["mouth_w"][i]],  # mouth left
            [gm["mouth_y"][i], 0.5 + gm["mouth_w"][i]],  # mouth right
        ], np.float32) * s
        inv = np.linalg.inv(rot)
        dst_yx = (canon_yx - t) @ inv.T
        return out, dst_yx[:, ::-1].astype(np.float32)   # (y,x) → (x,y)

    # -- dataset-style samplers ----------------------------------------
    def sample_for_ids(self, rng: np.random.Generator, ids,
                       return_landmarks: bool = False):
        ids = np.asarray(ids)
        if not return_landmarks:
            return np.stack([self.render(int(i), rng) for i in ids])
        outs = [self.render(int(i), rng, return_landmarks=True)
                for i in ids]
        return (np.stack([o for o, _ in outs]),
                np.stack([lm for _, lm in outs]))

    def sample(self, rng: np.random.Generator, n: int,
               id_range: tuple[int, int] | None = None):
        lo, hi = id_range or (0, self.num_ids)
        labels = rng.integers(lo, hi, n).astype(np.int32)
        return self.sample_for_ids(rng, labels), labels

    def batches(self, batch_size: int, steps: int, seed: int = 1,
                id_range: tuple[int, int] | None = None):
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            yield self.sample(rng, batch_size, id_range)

    def eval_pairs(self, rng: np.random.Generator, n_pairs: int,
                   id_range: tuple[int, int] | None = None):
        """→ (imgs1, imgs2, issame): n_pairs genuine + n_pairs impostor,
        INTERLEAVED (genuine at even indices) — the LFW-bin convention.
        The 10-fold protocol's test folds are contiguous index blocks
        (eval/verification._fold_masks), so block-ordered polarities
        would make every fold single-polarity: a degenerate (early-
        training, collapsed-embedding) model then reads accuracy ≈ 0
        instead of ≈ 0.5, because each train fold's majority polarity
        anti-predicts its opposite-polarity test fold."""
        lo, hi = id_range or (0, self.num_ids)
        same = rng.integers(lo, hi, n_pairs)
        a, b = rng.integers(lo, hi, n_pairs), rng.integers(lo, hi, n_pairs)
        b = np.where(b == a, lo + (b + 1 - lo) % (hi - lo), b)
        i1 = np.empty(2 * n_pairs, np.int64)
        i2 = np.empty(2 * n_pairs, np.int64)
        issame = np.zeros(2 * n_pairs, bool)
        i1[0::2], i1[1::2] = same, a
        i2[0::2], i2[1::2] = same, b
        issame[0::2] = True
        return (self.sample_for_ids(rng, i1), self.sample_for_ids(rng, i2),
                issame)

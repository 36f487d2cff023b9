"""Synthetic identity-labeled face-like dataset (a copy of
crfr/data/synthetic.py: the same seed gives the same arrays).

Each identity is a smooth random "prototype" image (low-frequency pattern —
identity information lives at coarse scales, which survives the bicubic
degradation realistically); samples are the prototype + per-sample photometric
jitter, small shifts and noise. Linearly separable enough that a few hundred
ArcFace steps reach high accuracy, hard enough that chance ≈ 1/C.
"""

from __future__ import annotations

import numpy as np


class SyntheticFaces:
    def __init__(self, num_classes: int = 8, image_size: int = 112,
                 seed: int = 0, coarse: int = 7, fine_detail: bool = False,
                 fine: int = 28, fine_weight: float = 35.0):
        """fine_detail=True makes identity live at FINE spatial scales (a
        per-identity high-frequency pattern on a shared coarse background) —
        bicubic degradation then genuinely destroys identity information,
        which is the regime the cross-resolution methods (hallucination,
        residual KD) exist for. Default (False): identity is coarse-scale
        and survives degradation (easy, good for fast integration tests)."""
        self.num_classes = num_classes
        self.image_size = image_size
        rng = np.random.default_rng(seed)
        if fine_detail:
            shared = _bilinear_upsample(
                rng.uniform(60, 195, size=(coarse, coarse, 3)), image_size)
            protos = []
            for i in range(num_classes):
                detail = _bilinear_upsample(
                    rng.uniform(-1, 1, size=(fine, fine, 3)), image_size)
                protos.append(shared + fine_weight * detail)
            self.prototypes = np.clip(np.stack(protos), 0, 255).astype(np.float32)
        else:
            # Low-frequency prototypes: coarse grid upsampled bilinearly.
            base = rng.uniform(40, 215, size=(num_classes, coarse, coarse, 3))
            self.prototypes = np.stack([
                _bilinear_upsample(base[i], image_size)
                for i in range(num_classes)
            ]).astype(np.float32)

    def sample(self, rng: np.random.Generator, n: int):
        """→ (images (n,S,S,3) float32 in [0,255], labels (n,) int32)."""
        labels = rng.integers(0, self.num_classes, n).astype(np.int32)
        imgs = self.prototypes[labels].copy()
        # photometric jitter + noise
        gain = rng.uniform(0.8, 1.2, size=(n, 1, 1, 1))
        bias = rng.uniform(-15, 15, size=(n, 1, 1, 1))
        noise = rng.normal(0, 8, size=imgs.shape)
        shift = rng.integers(-3, 4, size=(n, 2))
        out = np.clip(imgs * gain + bias + noise, 0, 255).astype(np.float32)
        for i in range(n):
            out[i] = np.roll(out[i], tuple(shift[i]), axis=(0, 1))
        return out, labels

    def batches(self, batch_size: int, steps: int, seed: int = 1):
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            yield self.sample(rng, batch_size)

    def eval_pairs(self, rng: np.random.Generator, n_pairs: int):
        """Verification fixture: (img1, img2, issame)."""
        issame = np.arange(n_pairs) % 2 == 0
        l1 = rng.integers(0, self.num_classes, n_pairs).astype(np.int32)
        off = rng.integers(1, self.num_classes, n_pairs).astype(np.int32)
        l2 = np.where(issame, l1, (l1 + off) % self.num_classes)
        i1, _ = self._of_labels(rng, l1)
        i2, _ = self._of_labels(rng, l2)
        return i1, i2, issame

    def _of_labels(self, rng, labels):
        imgs = self.prototypes[labels].copy()
        noise = rng.normal(0, 8, size=imgs.shape)
        return np.clip(imgs + noise, 0, 255).astype(np.float32), labels


def _bilinear_upsample(img: np.ndarray, size: int) -> np.ndarray:
    h, w, c = img.shape
    ys = np.linspace(0, h - 1, size)
    xs = np.linspace(0, w - 1, size)
    y0 = np.floor(ys).astype(int).clip(0, h - 2)
    x0 = np.floor(xs).astype(int).clip(0, w - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    tl = img[y0][:, x0]
    tr = img[y0][:, x0 + 1]
    bl = img[y0 + 1][:, x0]
    br = img[y0 + 1][:, x0 + 1]
    return (tl * (1 - fy) * (1 - fx) + tr * (1 - fy) * fx
            + bl * fy * (1 - fx) + br * fy * fx)

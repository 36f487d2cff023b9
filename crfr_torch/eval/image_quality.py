"""Image quality of the hallucination stage (crfr/eval/image_quality.py):
PSNR and SSIM on the [0, 255] scale. SSIM follows Wang et al. 2004 with
the 11×11 Gaussian window (σ=1.5), K1=0.01, K2=0.03, as
``skimage.metrics.structural_similarity(gaussian_weights=True,
use_sample_covariance=False)``; the window runs as a depthwise
``F.conv2d`` with VALID padding. Both compute in float32 on the inputs'
device."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """Per image: (B, H, W, C) → (B,), (H, W, C) → a scalar."""
    a, b = a.float(), b.float()
    dims = tuple(range(a.ndim - 3, a.ndim)) if a.ndim >= 3 else None
    mse = (a - b).square().mean(dim=dims)
    return 10.0 * torch.log10(max_val * max_val / mse.clamp_min(1e-12))


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """Mean SSIM per image pair, averaged over channels: (B, H, W, C) → (B,)."""
    a, b = a.float(), b.float()
    if a.ndim == 3:
        a, b = a[None], b[None]
    c = a.shape[-1]
    kern = torch.from_numpy(_gaussian_kernel()).to(a.device)[None, None].expand(c, 1, 11, 11)

    def filt(x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.permute(0, 3, 1, 2), kern, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = filt(a * a) - mu_a2
    var_b = filt(b * b) - mu_b2
    cov = filt(a * b) - mu_ab
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    num = (2 * mu_ab + c1) * (2 * cov + c2)
    den = (mu_a2 + mu_b2 + c1) * (var_a + var_b + c2)
    return (num / den).mean(dim=(1, 2, 3))

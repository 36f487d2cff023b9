"""Bicubic degrade and normalization in plain float32 PyTorch.

The 1-D operator builders are a frozen copy of the published resamplers'
rules: ``pil`` is PIL's BICUBIC (a = -0.5, antialiased on a downscale,
weights renormalised over the in-bounds taps), ``cv2`` is OpenCV's
INTER_CUBIC (a = -0.75, four taps, replicated border). They are built in
float64 and rounded to float32; a degrade to ``low`` is the composed
operator up(low -> S) . down(S -> low), applied to each channel plane as
``D . X . D^T``. The pixels are then normalized as ``(x - 127.5) / 128``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(ax <= 1.0, (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
                    np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0))


def _pil(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    w = np.zeros((out_size, in_size))
    for o in range(out_size):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        taps = _cubic((np.arange(lo, hi) + 0.5 - center) / fscale, -0.5)
        total = taps.sum()
        w[o, lo:hi] = taps / total if total != 0 else taps
    return w


def _cv2(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    w = np.zeros((out_size, in_size))
    for o in range(out_size):
        fx = (o + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        frac = fx - sx
        taps = _cubic(np.array([1.0 + frac, frac, 1.0 - frac, 2.0 - frac]), -0.75)
        for t, wt in zip((sx - 1, sx, sx + 1, sx + 2), taps):
            w[o, min(max(t, 0), in_size - 1)] += wt
    return w


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) float32 bicubic resampling matrix."""
    if mode == "pil":
        return _pil(in_size, out_size).astype(np.float32)
    if mode == "cv2":
        return _cv2(in_size, out_size).astype(np.float32)
    raise ValueError(f"unknown resize mode {mode!r}")


@functools.lru_cache(maxsize=None)
def degrade_matrix(size: int, low: int, mode: str) -> np.ndarray:
    """(size, size) float32: down to ``low``, then back up to ``size``."""
    down = resize_matrix(size, low, mode).astype(np.float64)
    up = resize_matrix(low, size, mode).astype(np.float64)
    return (up @ down).astype(np.float32)


def degrade_normalize(x: torch.Tensor, lows, mode: str) -> torch.Tensor:
    """(B, S, S, C) raw pixels → (B, S, S, C) float32, each image degraded
    to its own low (``lows``: an int, or one int per image) and normalized."""
    b, s = x.shape[0], x.shape[1]
    lows = np.full(b, int(lows)) if np.ndim(lows) == 0 else np.asarray(lows).reshape(b)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for low in np.unique(lows):
        idx = torch.from_numpy(np.nonzero(lows == low)[0]).to(x.device)
        d = torch.from_numpy(degrade_matrix(s, int(low), mode)).to(x.device)
        out[idx] = torch.einsum("oi,bijc,pj->bopc", d, x[idx].float(), d)
    return (out - 127.5) / 128.0

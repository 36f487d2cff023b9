"""Bicubic resize as static weight-matrix products (crfr/ops/bicubic.py).

Separable resampling along one axis is a linear map, so a resize is
``out[b, o, p, c] = Σ_i Σ_j Wr[o, i] · img[b, i, j, c] · Wc[p, j]`` with
(out × in) interpolation matrices built once on the host in float64.

- ``mode='pil'``: cubic a=−0.5, antialiased on downscale, weights
  renormalised over in-bounds taps (``PIL.Image.resize(..., BICUBIC)``).
- ``mode='cv2'``: cubic a=−0.75, 4 taps, no antialias, replicate border
  (``cv2.resize(..., INTER_CUBIC)``).

The matrix builders are copies of the reference's and are bit-equal to it.
The tensor functions keep NHWC (or HWC / HW) and compute in float32 on the
tensor's own device; call them under ``device.strict_fp32()`` on CUDA when
float32 parity matters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel with free parameter ``a``."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, mode: str = "pil") -> np.ndarray:
    """Exact 1-D bicubic resampling matrix (out_size, in_size), float32.

    Cached per static (in, out, mode) triple; built in float64 on host.
    """
    if mode == "pil":
        return _pil_matrix(in_size, out_size).astype(np.float32)
    if mode == "cv2":
        return _cv2_matrix(in_size, out_size).astype(np.float32)
    raise ValueError(f"unknown resize mode {mode!r} (want 'pil' or 'cv2')")


def _pil_matrix(in_size: int, out_size: int) -> np.ndarray:
    # Mirrors PIL's ImagingResampleHorizontal precompute_coeffs():
    # scale = in/out; filterscale = max(scale, 1) gives downscale antialiasing;
    # support = 2 * filterscale; weights normalized over in-bounds taps.
    a = -0.5
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax)
        w = _cubic((taps + 0.5 - center) / filterscale, a)
        s = w.sum()
        if s != 0:
            w = w / s
        W[o, xmin:xmax] = w
    return W


def _cv2_matrix(in_size: int, out_size: int) -> np.ndarray:
    # cv2 INTER_CUBIC: a=-0.75, always 4 taps around fx=(o+0.5)*scale-0.5,
    # no antialias, taps clamped to the image (replicate border).
    a = -0.75
    scale = in_size / out_size
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        fx = (o + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        frac = fx - sx
        taps = np.array([sx - 1, sx, sx + 1, sx + 2])
        w = _cubic(np.array([1.0 + frac, frac, 1.0 - frac, 2.0 - frac]), a)
        # cv2 weights sum to 1 exactly for the untruncated stencil; replicate
        # border folds out-of-range taps onto the edge pixel.
        for t, wt in zip(taps, w):
            W[o, min(max(t, 0), in_size - 1)] += wt
    return W


@functools.lru_cache(maxsize=256)
def degrade_matrix(size: int, low: int, mode: str = "pil") -> np.ndarray:
    """Composed (size×size) operator: bicubic down to ``low`` then back up."""
    down = resize_matrix(size, low, mode).astype(np.float64)
    up = resize_matrix(low, size, mode).astype(np.float64)
    return (up @ down).astype(np.float32)


def degrade_table(size: int, lows, mode: str = "pil") -> np.ndarray:
    """(L, size, size) f32: ``degrade_matrix(size, low, mode)`` for each
    low of ``lows``, stacked (the training step's operator table)."""
    return np.stack([degrade_matrix(size, int(low), mode) for low in lows])


def _spatial(img: torch.Tensor) -> tuple[int, int]:
    if img.ndim not in (2, 3, 4):
        raise ValueError(f"rank-{img.ndim} input not supported")
    return (img.shape[0], img.shape[1]) if img.ndim <= 3 else (img.shape[1], img.shape[2])


def _float(img: torch.Tensor) -> torch.Tensor:
    return img if img.is_floating_point() else img.to(torch.float32)


def _matrix(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(w).to(device=like.device, dtype=like.dtype)


_SEPARABLE = {2: "oi,ij,pj->op", 3: "oi,ijc,pj->opc", 4: "oi,bijc,pj->bopc"}
_ROWS = {2: "oi,ij->oj", 3: "oi,ijc->ojc", 4: "oi,bijc->bojc"}
_COLS = {2: "ij,pj->ip", 3: "ijc,pj->ipc", 4: "bijc,pj->bipc"}


def _apply_separable(img: torch.Tensor, wr: np.ndarray, wc: np.ndarray) -> torch.Tensor:
    """out = Wr · img · Wcᵀ over the two spatial axes."""
    x = _float(img)
    return torch.einsum(_SEPARABLE[img.ndim], _matrix(wr, x), x, _matrix(wc, x))


def resize_bicubic(img: torch.Tensor, out_hw: tuple[int, int],
                   mode: str = "pil", u8_pipeline: bool = False) -> torch.Tensor:
    """Bicubic resize of (B,H,W,C) / (H,W,C) / (H,W) to ``out_hw``; float out.

    ``u8_pipeline=True`` emulates PIL's 8-bit pipeline: horizontal pass
    first, a uint8 intermediate rounded half-up (``floor(x + 0.5)``) and
    clipped, then the vertical pass, rounded and clipped the same way.
    """
    h, w = _spatial(img)
    oh, ow = out_hw
    wr = resize_matrix(h, oh, mode)
    wc = resize_matrix(w, ow, mode)
    if not u8_pipeline:
        return _apply_separable(img, wr, wc)
    x = _float(img)
    tmp = torch.einsum(_COLS[img.ndim], x, _matrix(wc, x))       # horizontal
    tmp = torch.clamp(torch.floor(tmp + 0.5), 0.0, 255.0)
    out = torch.einsum(_ROWS[img.ndim], _matrix(wr, x), tmp)     # vertical
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)


def degrade_updown(img: torch.Tensor, low: int, mode: str = "pil",
                   round_intermediate: bool = False) -> torch.Tensor:
    """Bicubic down to ``low``×``low`` and back up to the input size.

    Without ``round_intermediate`` the pair is one composed operator per
    axis; with it the low-res image is materialised as uint8 in between
    (``u8_pipeline`` on both resizes), as a PIL/cv2-on-files pipeline does.
    """
    h, w = _spatial(img)
    if round_intermediate:
        small = resize_bicubic(img, (low, low), mode, u8_pipeline=True)
        return resize_bicubic(small, (h, w), mode, u8_pipeline=True)
    return _apply_separable(img, degrade_matrix(h, low, mode),
                            degrade_matrix(w, low, mode))


def random_degrade(img: torch.Tensor, generator: torch.Generator, low_min: int, low_max: int,
                   mode: str = "pil") -> torch.Tensor:
    """Degrade a batch (or one image) to one ``low`` drawn uniformly from
    [low_min, low_max] by ``generator`` (on the image's device): the
    composed operators of every low stacked as one table, indexed by the
    draw on the device, so nothing waits for the host."""
    size = img.shape[-3] if img.ndim >= 3 else img.shape[0]
    table = torch.from_numpy(degrade_table(size, range(low_min, low_max + 1), mode))
    x = _float(img)
    table = table.to(device=x.device, dtype=x.dtype)
    idx = torch.randint(0, low_max - low_min + 1, (), generator=generator,
                        device=generator.device)
    w = table[idx.to(x.device)]
    return torch.einsum(_SEPARABLE[img.ndim], w, x, w)

"""Fused bicubic resample + normalize + cast (crfr/ops/fused_pallas.py).

``fused_degrade_normalize`` computes ``normalize(degrade_updown(x, low))``
and ``fused_resize_normalize`` computes ``normalize(resize_bicubic(x, out_hw))``,
each with the result cast to ``out_dtype``, in one pass: per (image, channel)
plane ``Y = Wr·X·Wcᵀ``, then ``(Y − 127.5) / 128``. Input and output are NHWC;
the output is contiguous NHWC, which is the ``channels_last`` layout of the
NCHW tensor ``out.permute(0, 3, 1, 2)``.

A tensor on the CPU goes through the plain version beside each function
(``*_reference``). A CUDA tensor goes through the hand-written kernel in
``csrc/fused_preprocess.cu`` or the call raises: there is no fallback.
Each function counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import functools

import torch

from crfr_torch.ops import _build
from crfr_torch.ops.bicubic import degrade_matrix, resize_matrix
from crfr_torch.ops.normalize import MEAN, STD

_IN_CODES = {torch.uint8: 0, torch.float32: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=64)
def _operators(key: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Wr, Wc) f32 on ``device`` for ('degrade', h, w, low, mode) or
    ('resize', h, w, oh, ow, mode)."""
    if key[0] == "degrade":
        _, h, w, low, mode = key
        wr, wc = degrade_matrix(h, low, mode), degrade_matrix(w, low, mode)
    else:
        _, h, w, oh, ow, mode = key
        wr, wc = resize_matrix(h, oh, mode), resize_matrix(w, ow, mode)
    return (torch.from_numpy(wr).to(device), torch.from_numpy(wc).to(device))


@functools.lru_cache(maxsize=64)
def _operators_t(key: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Wrᵀ, Wcᵀ) contiguous, as the kernel reads them."""
    wr, wc = _operators(key, device)
    return wr.t().contiguous(), wc.t().contiguous()


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"expected NHWC (B, H, W, C), got shape {tuple(x.shape)}")


def _reference(x: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    xc = x.to(torch.float32).permute(0, 3, 1, 2)          # (B, C, H, W)
    y = torch.matmul(torch.matmul(wr, xc), wc.t())        # (B, C, OH, OW)
    y = (y - MEAN) * (1.0 / STD)
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def _launch(x: torch.Tensor, key: tuple, oh: int, ow: int,
            out_dtype: torch.dtype, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _IN_CODES:
        raise TypeError(f"{what}: input must be uint8 or float32, got {x.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"{what}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous NHWC")
    b, h, w, c = x.shape
    lib = _build.load_library()
    if h + w > lib.crfr_resample_max_hw():
        raise ValueError(f"{what}: H + W = {h + w} exceeds the kernel's "
                         f"limit of {lib.crfr_resample_max_hw()}")
    wr_t, wc_t = _operators_t(key, x.device)
    out = torch.empty((b, oh, ow, c), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.crfr_resample_normalize(
            x.data_ptr(), _IN_CODES[x.dtype], wr_t.data_ptr(), wc_t.data_ptr(),
            out.data_ptr(), _OUT_CODES[out_dtype], b, c, h, w, oh, ow, stream)
    _build.check(lib, err, what)
    return out


def fused_degrade_normalize_reference(x: torch.Tensor, low: int, mode: str = "pil",
                                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of ``fused_degrade_normalize``."""
    _check_input(x)
    _, s, s2, _ = x.shape
    if s != s2:
        raise ValueError("square inputs only")
    wr, wc = _operators(("degrade", s, s, low, mode), x.device)
    return _reference(x, wr, wc, out_dtype)


def fused_degrade_normalize(x: torch.Tensor, low: int, mode: str = "pil",
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, S, S, C) raw pixels, uint8 or f32 → degraded (bicubic down to
    ``low``, back up to S) and normalized (B, S, S, C) ``out_dtype``."""
    _check_input(x)
    _, s, s2, _ = x.shape
    if s != s2:
        raise ValueError("square inputs only")
    if x.device.type == "cpu":
        return fused_degrade_normalize_reference(x, low, mode, out_dtype)
    out = _launch(x, ("degrade", s, s, low, mode), s, s, out_dtype,
                  "fused_degrade_normalize")
    fused_degrade_normalize.launches += 1
    return out


fused_degrade_normalize.launches = 0


def fused_resize_normalize_reference(x: torch.Tensor, out_hw: tuple[int, int],
                                     mode: str = "pil",
                                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of ``fused_resize_normalize``."""
    _check_input(x)
    _, h, w, _ = x.shape
    oh, ow = out_hw
    wr, wc = _operators(("resize", h, w, oh, ow, mode), x.device)
    return _reference(x, wr, wc, out_dtype)


def fused_resize_normalize(x: torch.Tensor, out_hw: tuple[int, int],
                           mode: str = "pil",
                           out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W, C) raw pixels → bicubic-resized to ``out_hw`` and normalized
    (B, oh, ow, C) ``out_dtype``: the serving-ingest resize."""
    _check_input(x)
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if x.device.type == "cpu":
        return fused_resize_normalize_reference(x, out_hw, mode, out_dtype)
    out = _launch(x, ("resize", h, w, oh, ow, mode), oh, ow, out_dtype,
                  "fused_resize_normalize")
    fused_resize_normalize.launches += 1
    return out


fused_resize_normalize.launches = 0

"""Fused bicubic resample + normalize + cast (crfr/ops/fused_pallas.py).

``fused_degrade_normalize`` computes ``normalize(degrade_updown(x, low))``
and ``fused_resize_normalize`` computes ``normalize(resize_bicubic(x, out_hw))``,
each with the result cast to ``out_dtype``, in one pass: per (image, channel)
plane ``Y = Wr·X·Wcᵀ``, then ``(Y − 127.5) / 128``. Input and output are NHWC;
the output is contiguous NHWC, which is the ``channels_last`` layout of the
NCHW tensor ``out.permute(0, 3, 1, 2)``.

A tensor on the CPU goes through the plain version beside each function
(``*_reference``, the dense composed product). A CUDA tensor goes through the
hand-written kernel in ``csrc/fused_preprocess.cu`` or the call raises: there
is no fallback. The kernel applies the 1-D bicubic factors one at a time from
band tables (``band_table``): a degrade goes down along H, down along W, up
along W, up along H; a resize along W, then along H. Each function counts its
kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from crfr_torch.ops import _build
from crfr_torch.ops.bicubic import degrade_matrix, resize_matrix
from crfr_torch.ops.normalize import MEAN, STD

_IN_CODES = {torch.uint8: 0, torch.float32: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# output rows per CTA: the fastest band heights measured (PERF.md §6)
DEGRADE_ROWS = 112
RESIZE_ROWS = 32
_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "ctas", "rows", "threads",
              "smem_limit")


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


def operator_key(h: int, w: int, arg, mode: str) -> tuple:
    """The operators' key for an (h, w) input: ``arg`` is ``low`` (an int, a
    degrade) or ``out_hw`` (a pair, a resize)."""
    if isinstance(arg, int):
        return ("degrade", h, w, arg, mode)
    oh, ow = arg
    return ("resize", h, w, oh, ow, mode)


@functools.lru_cache(maxsize=256)
def band_table(n_in: int, n_out: int, mode: str = "pil") -> tuple[np.ndarray, np.ndarray]:
    """``resize_matrix(n_in, n_out, mode)`` as a band table: ``start``
    (n_out,) int32, nondecreasing, and ``taps`` (n_out, T) f32 with
    ``M[o, start[o] + t] = taps[o, t]`` and every other entry of row ``o``
    zero. T is the widest window that holds every row's nonzeros and keeps
    the starts in order; shorter rows carry zeros."""
    m = resize_matrix(n_in, n_out, mode)
    nz = m != 0
    first = np.where(nz.any(1), nz.argmax(1), n_in - 1)
    last = np.where(nz.any(1), n_in - 1 - nz[:, ::-1].argmax(1), 0)
    start = np.minimum.accumulate(first[::-1])[::-1]       # in order, ≤ first
    taps = int((last - start + 1).max())
    start = np.minimum(start, n_in - taps)                  # windows inside the input
    window = np.take_along_axis(m, start[:, None] + np.arange(taps), axis=1)
    start, window = start.astype(np.int32), np.ascontiguousarray(window, np.float32)
    start.flags.writeable = window.flags.writeable = False     # shared by the cache
    return start, window


def _factors(key: tuple) -> tuple[tuple[int, int, str], ...]:
    """(n_in, n_out, mode) of each 1-D factor as the kernel takes them: a
    degrade's down H, down W, up H, up W; a resize's H, W."""
    if key[0] == "degrade":
        _, h, w, low, mode = key
        return (h, low, mode), (w, low, mode), (low, h, mode), (low, w, mode)
    _, h, w, oh, ow, mode = key
    return (h, oh, mode), (w, ow, mode)


@functools.lru_cache(maxsize=256)
def band_spans(key: tuple, rows: int) -> tuple[int, int]:
    """(span, in_span): the most rows one band of ``rows`` output rows reads
    through the vertical factor into the output (rows of the low-res image
    for a degrade, of the input for a resize), and the most input rows it
    reads: the kernel's shared-memory plan."""
    factors = _factors(key)
    start, taps = band_table(*factors[2 if key[0] == "degrade" else 0])
    n = len(start)
    rows = min(rows, n)
    span = in_span = 0
    for r0 in range(0, n, rows):
        lo = int(start[r0])
        nl = int(start[min(r0 + rows, n) - 1]) + taps.shape[1] - lo
        span = max(span, nl)
        if key[0] == "degrade":
            down, down_taps = band_table(*factors[0])
            nl = int(down[lo + nl - 1]) + down_taps.shape[1] - int(down[lo])
        in_span = max(in_span, nl)
    return span, in_span


def _rows(key: tuple, rows: int | None) -> int:
    return rows or (DEGRADE_ROWS if key[0] == "degrade" else RESIZE_ROWS)


class _Band(ctypes.Structure):
    """``crfr_band`` of csrc/fused_preprocess.cu."""
    _fields_ = [("start", ctypes.c_void_p), ("taps", ctypes.c_void_p),
                ("n_in", ctypes.c_int), ("n_out", ctypes.c_int), ("n_taps", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _device_table(n_in: int, n_out: int, mode: str,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, taps transposed to (T, n_out)) on ``device``: threads on
    neighbouring outputs load neighbouring weights."""
    start, taps = band_table(n_in, n_out, mode)
    return (torch.tensor(start, device=device),
            torch.tensor(np.ascontiguousarray(taps.T), device=device))


@functools.lru_cache(maxsize=64)
def _bands(key: tuple, device: torch.device) -> tuple[ctypes.Array, tuple]:
    """The kernel's band tables on ``device`` as a ``crfr_band`` array, with
    the tensors that hold them (cached together, so they outlive the array)."""
    tables = tuple(_device_table(*f, device) for f in _factors(key))
    arr = (_Band * len(tables))(*[
        _Band(s.data_ptr(), t.data_ptr(), n_in, n_out, t.shape[0])
        for (s, t), (n_in, n_out, _) in zip(tables, _factors(key))])
    return arr, tables


def _info(lib, key: tuple, b: int, c: int, in_code: int, out_code: int, rows: int,
          device: torch.device) -> tuple[int, dict]:
    arr, _ = _bands(key, device)
    info = (ctypes.c_int * len(_INFO_KEYS))()
    err = lib.crfr_resample_info(in_code, out_code, b, c, ctypes.addressof(arr), len(arr),
                                 rows, *band_spans(key, rows), ctypes.addressof(info))
    return err, dict(zip(_INFO_KEYS, info))


@functools.lru_cache(maxsize=64)
def _check_plan(key: tuple, c: int, in_code: int, out_code: int, rows: int,
                device: torch.device, what: str) -> None:
    """Raise before the launch if the plan exceeds the kernel's shared memory."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        err, info = _info(lib, key, 1, c, in_code, out_code, rows, device)
    if err != 0 and not 0 <= info["smem_bytes"] <= info["smem_limit"]:
        raise ValueError(f"{what}: {info['smem_bytes']} bytes of shared memory for "
                         f"{key[1]}x{key[2]}x{c} in bands of {rows} rows exceed the "
                         f"kernel's limit of {info['smem_limit']}")
    _build.check(lib, err, what)


def resample_info(shape: tuple[int, int, int, int], arg, mode: str = "pil",
                  in_dtype: torch.dtype = torch.uint8,
                  out_dtype: torch.dtype = torch.bfloat16, rows: int | None = None) -> dict:
    """What one kernel call on a (B, H, W, C) input launches on the current
    CUDA device: registers and local-memory (spill) bytes per thread as
    compiled, dynamic shared memory, CTAs, output rows per CTA, threads per
    CTA, the device's shared-memory limit per CTA, and ``span`` and
    ``in_span`` (``band_spans``). ``arg`` is ``low`` (a degrade) or
    ``out_hw`` (a resize)."""
    b, h, w, c = shape
    key = operator_key(h, w, arg, mode)
    rows = _rows(key, rows)
    lib = _build.load_library()
    device = torch.device("cuda", torch.cuda.current_device())
    err, info = _info(lib, key, b, c, _IN_CODES[in_dtype], _OUT_CODES[out_dtype], rows, device)
    _build.check(lib, err, "resample_info")
    span, in_span = band_spans(key, rows)
    return {**info, "span": span, "in_span": in_span}


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"expected NHWC (B, H, W, C), got shape {tuple(x.shape)}")


def _reference(x: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    xc = x.to(torch.float32).permute(0, 3, 1, 2)          # (B, C, H, W)
    y = torch.matmul(torch.matmul(wr, xc), wc.t())        # (B, C, OH, OW)
    y = (y - MEAN) * (1.0 / STD)
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def _launch(x: torch.Tensor, key: tuple, oh: int, ow: int, out_dtype: torch.dtype,
            what: str, rows: int | None = None) -> torch.Tensor:
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
    rows = _rows(key, rows)
    in_code, out_code = _IN_CODES[x.dtype], _OUT_CODES[out_dtype]
    _check_plan(key, c, in_code, out_code, rows, x.device, what)
    lib = _build.load_library()
    arr, _ = _bands(key, x.device)
    out = torch.empty((b, oh, ow, c), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.crfr_resample_normalize(
            x.data_ptr(), in_code, out.data_ptr(), out_code, b, c, ctypes.addressof(arr),
            len(arr), rows, *band_spans(key, rows), stream)
    _build.check(lib, err, what)
    return out


def fused_degrade_normalize_reference(x: torch.Tensor, low: int, mode: str = "pil",
                                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of ``fused_degrade_normalize``."""
    _check_input(x)
    _, s, s2, _ = x.shape
    if s != s2:
        raise ValueError("square inputs only")
    wr, wc = _operators(operator_key(s, s, low, mode), x.device)
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
    out = _launch(x, operator_key(s, s, low, mode), s, s, out_dtype,
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
    wr, wc = _operators(operator_key(h, w, (oh, ow), mode), x.device)
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
    out = _launch(x, operator_key(h, w, (oh, ow), mode), oh, ow, out_dtype,
                  "fused_resize_normalize")
    fused_resize_normalize.launches += 1
    return out


fused_resize_normalize.launches = 0

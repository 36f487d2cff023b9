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

The degrade with one low and the resize are custom ops,
``torch.ops.crfr_torch.fused_degrade_normalize(x, low, mode, out_dtype)`` and
``torch.ops.crfr_torch.fused_resize_normalize(x, out_hw, mode, out_dtype)``,
each with a CPU body (the plain version), a CUDA body (the launch, which
counts it) and a fake body (the output's shape and dtype). ``torch.export``
records each as one node, so a loaded program (``crfr_torch.serve``) runs
and counts the kernel; importing ``crfr_torch.ops`` registers them. Eager
calls of the public functions run the same bodies directly.

``fused_degrade_normalize`` also takes ``low`` as an int32 tensor of shape
(B,): a low per image, as the training step draws them. The kernel then
reads each image's low and takes that low's four band tables from a device
table holding every low of the range ``lows`` (cached per size, range and
mode); its plain version is the batched product with each image's composed
operator, ``einsum('boi,bijc,bpj->bopc', W[low], x, W[low])``. Those
launches count in ``fused_degrade_normalize.lows_launches``; ``launches``
counts the int form's alone.

A band height is ``DEGRADE_ROWS`` (the whole image) for a degrade and
``RESIZE_ROWS`` for a resize where that plan fits the device's shared
memory, else the tallest of ``_SHORTER_ROWS`` below it that fits: a large
low needs large buffers (low 112 at 112² in whole-image bands would need
about 330 KB), and a photo's pyramid level or a large face box read through
a long downscale stages many wide input rows (640×480 → 18×14: 138 input
rows of 1,920 bytes for one output row). A resize for which no band height
fits takes the two-pass plan (``rows=TWO_PASS``): the horizontal pass over
every input row into a float32 (B, H, OW, C) scratch on the device, then
the vertical pass and the epilogue from it, with no shared memory, so at
any size. The sums are the same in the same order in every plan, so the
results do not depend on the height or the plan; ``resample_info`` says
which plan a shape takes. A degrade that fits no band height raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from crfr_torch.ops import _build
from crfr_torch.ops.bicubic import degrade_matrix, degrade_table, resize_matrix
from crfr_torch.ops.normalize import MEAN, STD

_IN_CODES = {torch.uint8: 0, torch.float32: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# output rows per CTA: the fastest band heights measured (PERF.md §6)
DEGRADE_ROWS = 112
RESIZE_ROWS = 32
_SHORTER_ROWS = (56, 28, 16, 8, 4, 2, 1)   # the band heights when the default does not fit
TWO_PASS = 0                               # ``rows`` of a resize's two-pass plan
# entries of the per-shape caches: a detector's crops come in hundreds of sizes
_SHAPES = 1024
_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "ctas", "rows", "threads",
              "smem_limit")


@functools.lru_cache(maxsize=256)
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


@functools.lru_cache(maxsize=_SHAPES)
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


@functools.lru_cache(maxsize=_SHAPES)
def band_spans(key: tuple, rows: int) -> tuple[int, int]:
    """(span, in_span): the most rows one band of ``rows`` output rows reads
    through the vertical factor into the output (rows of the low-res image
    for a degrade, of the input for a resize), and the most input rows it
    reads: the kernel's shared-memory plan. For a low per image, the
    largest of each over the lows."""
    if key[0] == "lows":
        spans = [band_spans(k, rows) for k in _low_keys(key)]
        return max(s for s, _ in spans), max(s for _, s in spans)
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


def lows_key(s: int, lows: tuple[int, int] | None, mode: str) -> tuple:
    """The key of a degrade of (B, s, s, C) with a low per image, each in
    ``lows`` = (first, last), inclusive; all of 1 ... s when None."""
    lo, hi = lows if lows is not None else (1, s)
    if not 1 <= lo <= hi:
        raise ValueError(f"lows must be a range (first, last) with 1 <= first <= last, "
                         f"got {lows}")
    return ("lows", s, int(lo), int(hi), mode)


def _low_keys(key: tuple) -> list[tuple]:
    _, s, lo, hi, mode = key
    return [operator_key(s, s, low, mode) for low in range(lo, hi + 1)]


class _Band(ctypes.Structure):
    """``crfr_band`` of csrc/fused_preprocess.cu."""
    _fields_ = [("start", ctypes.c_void_p), ("taps", ctypes.c_void_p),
                ("n_in", ctypes.c_int), ("n_out", ctypes.c_int), ("n_taps", ctypes.c_int)]


@functools.lru_cache(maxsize=_SHAPES)
def _device_table(n_in: int, n_out: int, mode: str,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, taps transposed to (T, n_out)) on ``device``: threads on
    neighbouring outputs load neighbouring weights."""
    start, taps = band_table(n_in, n_out, mode)
    return (torch.tensor(start, device=device),
            torch.tensor(np.ascontiguousarray(taps.T), device=device))


@functools.lru_cache(maxsize=_SHAPES)
def _bands(key: tuple, device: torch.device) -> tuple[ctypes.Array, tuple]:
    """The kernel's band tables on ``device`` as a ``crfr_band`` array, with
    the tensors that hold them (cached together, so they outlive the array)."""
    tables = tuple(_device_table(*f, device) for f in _factors(key))
    arr = (_Band * len(tables))(*[
        _Band(s.data_ptr(), t.data_ptr(), n_in, n_out, t.shape[0])
        for (s, t), (n_in, n_out, _) in zip(tables, _factors(key))])
    return arr, tables


@functools.lru_cache(maxsize=16)
def _lows_bands(key: tuple, device: torch.device) -> tuple[ctypes.Array, torch.Tensor, tuple]:
    """Four ``crfr_band`` structs per low of a lows key, on the host and as
    bytes on ``device`` (the table the kernel indexes by low), with what
    holds their band tables."""
    per_low = [_bands(k, device) for k in _low_keys(key)]
    arr = (_Band * (4 * len(per_low)))(*[b for a, _ in per_low for b in a])
    dev = torch.frombuffer(bytearray(bytes(arr)), dtype=torch.uint8).to(device)
    return arr, dev, tuple(per_low)


@functools.lru_cache(maxsize=64)
def _lows_spans(key: tuple, rows: int) -> ctypes.Array:
    """(span, in_span) of each low of a lows key, as the kernel takes them."""
    spans = [v for k in _low_keys(key) for v in band_spans(k, rows)]
    return (ctypes.c_int * len(spans))(*spans)


def _info(lib, key: tuple, b: int, c: int, in_code: int, out_code: int, rows: int,
          device: torch.device) -> tuple[int, dict]:
    info = (ctypes.c_int * len(_INFO_KEYS))()
    if rows == TWO_PASS:
        arr, _ = _bands(key, device)
        err = lib.crfr_resize_two_pass_info(in_code, out_code, b, c, ctypes.addressof(arr),
                                            ctypes.addressof(info))
    elif key[0] == "lows":
        arr, _, _ = _lows_bands(key, device)
        err = lib.crfr_degrade_lows_info(in_code, out_code, b, c, ctypes.addressof(arr),
                                         len(arr) // 4, rows,
                                         ctypes.addressof(_lows_spans(key, rows)),
                                         ctypes.addressof(info))
    else:
        arr, _ = _bands(key, device)
        err = lib.crfr_resample_info(in_code, out_code, b, c, ctypes.addressof(arr), len(arr),
                                     rows, *band_spans(key, rows), ctypes.addressof(info))
    return err, dict(zip(_INFO_KEYS, info))


@functools.lru_cache(maxsize=_SHAPES)
def _fit_rows(key: tuple, c: int, in_code: int, out_code: int, device: torch.device) -> int:
    """The default band height: ``RESIZE_ROWS`` for a resize, ``DEGRADE_ROWS``
    for a degrade, or the tallest of ``_SHORTER_ROWS`` below it whose plan
    fits the device's shared memory. When none does, ``TWO_PASS`` for a
    resize, and for a degrade ``DEGRADE_ROWS`` again, so that the launch
    raises with its size."""
    first = RESIZE_ROWS if key[0] == "resize" else DEGRADE_ROWS
    lib = _build.load_library()
    with torch.cuda.device(device):
        for rows in (first, *(r for r in _SHORTER_ROWS if r < first)):
            if _info(lib, key, 1, c, in_code, out_code, rows, device)[0] == 0:
                return rows
    return TWO_PASS if key[0] == "resize" else first


@functools.lru_cache(maxsize=_SHAPES)
def _check_plan(key: tuple, c: int, in_code: int, out_code: int, rows: int,
                device: torch.device, what: str) -> None:
    """Raise before the launch if the plan exceeds the kernel's shared memory,
    or is the two-pass plan of a degrade or of an image beyond its int
    offsets (2^31 elements)."""
    if rows == TWO_PASS and key[0] != "resize":
        raise ValueError(f"{what}: the two-pass plan is a resize's")
    lib = _build.load_library()
    with torch.cuda.device(device):
        err, info = _info(lib, key, 1, c, in_code, out_code, rows, device)
    if rows == TWO_PASS and err != 0:
        raise ValueError(f"{what}: a {key[1]}x{key[2]}x{c} -> {key[3]}x{key[4]} resize is "
                         f"beyond the two-pass plan's int offsets")
    if err != 0 and not 0 <= info["smem_bytes"] <= info["smem_limit"]:
        size = f"{key[1]}x{key[1]}" if key[0] == "lows" else f"{key[1]}x{key[2]}"
        raise ValueError(f"{what}: {info['smem_bytes']} bytes of shared memory for "
                         f"{size}x{c} in bands of {rows} rows exceed the "
                         f"kernel's limit of {info['smem_limit']}")
    _build.check(lib, err, what)


def resample_info(shape: tuple[int, int, int, int], arg, mode: str = "pil",
                  in_dtype: torch.dtype = torch.uint8,
                  out_dtype: torch.dtype = torch.bfloat16, rows: int | None = None,
                  lows: tuple[int, int] | None = None) -> dict:
    """What one kernel call on a (B, H, W, C) input launches on the current
    CUDA device: its ``plan`` ("bands", or "two_pass" for a resize that fits
    no band height), registers and local-memory (spill) bytes per thread as
    compiled, dynamic shared memory, CTAs, output rows per CTA, threads per
    CTA, the device's shared-memory limit per CTA, and ``span`` and
    ``in_span`` (``band_spans``; None for the two-pass plan, which also
    reports its float32 ``scratch_bytes``). ``arg`` is ``low`` (a
    degrade), a tensor of lows (a degrade with a low per image in the range
    ``lows``) or ``out_hw`` (a resize). ``rows`` defaults to the height a
    call takes; ``TWO_PASS`` asks for the two-pass plan. The two-pass
    plan's registers and spills are the larger of its two kernels', its
    CTAs those of both, its rows those of a vertical-pass CTA."""
    b, h, w, c = shape
    key = lows_key(h, lows, mode) if isinstance(arg, torch.Tensor) else operator_key(h, w, arg, mode)
    lib = _build.load_library()
    device = torch.device("cuda", torch.cuda.current_device())
    in_code, out_code = _IN_CODES[in_dtype], _OUT_CODES[out_dtype]
    rows = _fit_rows(key, c, in_code, out_code, device) if rows is None else rows
    err, info = _info(lib, key, b, c, in_code, out_code, rows, device)
    _build.check(lib, err, "resample_info")
    if rows == TWO_PASS:
        return {**info, "plan": "two_pass", "span": None, "in_span": None,
                "scratch_bytes": 4 * b * h * key[4] * c}
    span, in_span = band_spans(key, rows)
    out = {**info, "plan": "bands", "span": span, "in_span": in_span}
    if key[0] == "lows":
        out["lows"] = [key[2], key[3]]
    return out


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
            what: str, rows: int | None = None, low: torch.Tensor | None = None) -> torch.Tensor:
    """One launch on ``x``, in bands of ``rows`` output rows (the default
    plan when None; ``TWO_PASS`` for a resize's two-pass plan); ``low`` the
    (B,) int32 lows of a lows key."""
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
    in_code, out_code = _IN_CODES[x.dtype], _OUT_CODES[out_dtype]
    rows = _fit_rows(key, c, in_code, out_code, x.device) if rows is None else rows
    _check_plan(key, c, in_code, out_code, rows, x.device, what)
    lib = _build.load_library()
    out = torch.empty((b, oh, ow, c), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if rows == TWO_PASS:
            arr, _ = _bands(key, x.device)
            scratch = torch.empty((b, h, ow, c), dtype=torch.float32, device=x.device)
            err = lib.crfr_resize_two_pass(x.data_ptr(), in_code, scratch.data_ptr(),
                                           out.data_ptr(), out_code, b, c,
                                           ctypes.addressof(arr), stream)
        elif key[0] == "lows":
            arr, dev, _ = _lows_bands(key, x.device)
            err = lib.crfr_degrade_lows_normalize(
                x.data_ptr(), in_code, out.data_ptr(), out_code, b, c, ctypes.addressof(arr),
                dev.data_ptr(), len(arr) // 4, key[2], low.data_ptr(), rows,
                ctypes.addressof(_lows_spans(key, rows)), stream)
        else:
            arr, _ = _bands(key, x.device)
            err = lib.crfr_resample_normalize(
                x.data_ptr(), in_code, out.data_ptr(), out_code, b, c, ctypes.addressof(arr),
                len(arr), rows, *band_spans(key, rows), stream)
    _build.check(lib, err, what)
    return out


@functools.lru_cache(maxsize=16)
def _table(key: tuple, device: torch.device) -> torch.Tensor:
    """``degrade_table`` of a lows key, (L, S, S) f32 on ``device``."""
    _, s, lo, hi, mode = key
    return torch.from_numpy(degrade_table(s, range(lo, hi + 1), mode)).to(device)


def _square(x: torch.Tensor) -> int:
    _check_input(x)
    _, s, s2, _ = x.shape
    if s != s2:
        raise ValueError("square inputs only")
    return s


def _check_lows(x: torch.Tensor, low: torch.Tensor) -> None:
    if low.dtype != torch.int32 or low.shape != (x.shape[0],):
        raise TypeError(f"a low per image is an int32 tensor of shape ({x.shape[0]},), got "
                        f"{low.dtype} {tuple(low.shape)}")
    if low.device != x.device:
        raise ValueError(f"the lows are on {low.device}, the images on {x.device}")


def fused_degrade_normalize_reference(x: torch.Tensor, low, mode: str = "pil",
                                      out_dtype: torch.dtype = torch.bfloat16,
                                      lows: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``fused_degrade_normalize``."""
    s = _square(x)
    if isinstance(low, torch.Tensor):
        _check_lows(x, low)
        key = lows_key(s, lows, mode)
        idx = low.long() - key[2]
        if bool(((idx < 0) | (idx > key[3] - key[2])).any()):
            raise ValueError(f"lows outside {key[2]}..{key[3]}")
        w = _table(key, x.device)[idx]                                  # (B, S, S)
        y = torch.einsum("boi,bijc,bpj->bopc", w, x.to(torch.float32), w)
        return ((y - MEAN) * (1.0 / STD)).to(out_dtype).contiguous()
    wr, wc = _operators(operator_key(s, s, low, mode), x.device)
    return _reference(x, wr, wc, out_dtype)


def fused_degrade_normalize(x: torch.Tensor, low, mode: str = "pil",
                            out_dtype: torch.dtype = torch.bfloat16,
                            lows: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, S, S, C) raw pixels, uint8 or f32 → degraded (bicubic down to
    ``low``, back up to S) and normalized (B, S, S, C) ``out_dtype``.
    ``low`` is an int, or an int32 (B,) tensor on ``x``'s device holding
    each image's low, every one in ``lows`` = (first, last) (1 ... S when
    None); on the card an image whose low lies outside comes out NaN.
    With an int ``low``, a traced call (``torch.export``) is one node of the
    op ``crfr_torch::fused_degrade_normalize``; an eager one runs the op's
    body for its device without the dispatcher, which costs the host about
    as much again as the launch (PERF.md §6)."""
    s = _square(x)
    if not isinstance(low, torch.Tensor):
        if torch.compiler.is_compiling():
            return torch.ops.crfr_torch.fused_degrade_normalize(x, int(low), mode, out_dtype)
        if x.device.type == "cpu":
            return fused_degrade_normalize_reference(x, low, mode, out_dtype)
        return _degrade_cuda(x, int(low), mode, out_dtype)
    if x.device.type == "cpu":
        return fused_degrade_normalize_reference(x, low, mode, out_dtype, lows)
    _check_lows(x, low)
    out = _launch(x, lows_key(s, lows, mode), s, s, out_dtype, "fused_degrade_normalize",
                  low=low.contiguous())
    fused_degrade_normalize.lows_launches += 1
    return out


fused_degrade_normalize.launches = 0        # the launches with one low (an int)
fused_degrade_normalize.lows_launches = 0   # the launches with a low per image


@torch.library.custom_op("crfr_torch::fused_degrade_normalize", mutates_args=(),
                         device_types="cpu")
def _degrade_op(x: torch.Tensor, low: int, mode: str, out_dtype: torch.dtype) -> torch.Tensor:
    """The op's body for a CPU tensor: the plain version."""
    return fused_degrade_normalize_reference(x, low, mode, out_dtype)


@_degrade_op.register_kernel("cuda")
def _degrade_cuda(x: torch.Tensor, low: int, mode: str, out_dtype: torch.dtype) -> torch.Tensor:
    """The op's body for a CUDA tensor: one launch of the kernel, counted."""
    s = x.shape[1]
    out = _launch(x, operator_key(s, s, low, mode), s, s, out_dtype, "fused_degrade_normalize")
    fused_degrade_normalize.launches += 1
    return out


@_degrade_op.register_fake
def _degrade_fake(x: torch.Tensor, low: int, mode: str, out_dtype: torch.dtype) -> torch.Tensor:
    return x.new_empty(x.shape, dtype=out_dtype)


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
    (B, oh, ow, C) ``out_dtype``: the serving-ingest resize. A traced call
    is one node of the op ``crfr_torch::fused_resize_normalize``; an eager
    one runs the op's body for its device, as ``fused_degrade_normalize``."""
    _check_input(x)
    oh, ow = out_hw
    if torch.compiler.is_compiling():
        return torch.ops.crfr_torch.fused_resize_normalize(x, [int(oh), int(ow)], mode, out_dtype)
    if x.device.type == "cpu":
        return fused_resize_normalize_reference(x, out_hw, mode, out_dtype)
    return _resize_cuda(x, [int(oh), int(ow)], mode, out_dtype)


fused_resize_normalize.launches = 0


@torch.library.custom_op("crfr_torch::fused_resize_normalize", mutates_args=(),
                         device_types="cpu")
def _resize_op(x: torch.Tensor, out_hw: list[int], mode: str,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The op's body for a CPU tensor: the plain version."""
    return fused_resize_normalize_reference(x, tuple(out_hw), mode, out_dtype)


@_resize_op.register_kernel("cuda")
def _resize_cuda(x: torch.Tensor, out_hw: list[int], mode: str,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The op's body for a CUDA tensor: one launch of the kernel, counted."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    out = _launch(x, operator_key(h, w, (oh, ow), mode), oh, ow, out_dtype,
                  "fused_resize_normalize")
    fused_resize_normalize.launches += 1
    return out


@_resize_op.register_fake
def _resize_fake(x: torch.Tensor, out_hw: list[int], mode: str,
                 out_dtype: torch.dtype) -> torch.Tensor:
    b, _, _, c = x.shape
    return x.new_empty((b, out_hw[0], out_hw[1], c), dtype=out_dtype)

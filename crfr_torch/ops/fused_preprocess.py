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
(B,): a low per image, as the training step draws them. The host never
reads those lows (that would synchronize every train step): it plans every
low of the range ``lows`` once (``lows_plan``, cached per size, range,
mode, channels and input type), each low at its own band height, the
tallest whose buffers fit the shared memory of one of the CTAs an SM that
the kernel is built for (two; fewer where some low fits no height in that).
The kernel
reads each image's low and takes that low's plan and four band tables
from device tables; its plain version is the batched product with each
image's composed operator, ``einsum('boi,bijc,bpj->bopc', W[low], x,
W[low])``. Each call is one launch, counted in
``fused_degrade_normalize.lows_launches``; ``launches`` counts the int
form's alone.

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

Two ragged forms of the resize serve a detector's photo, each one launch
(not custom ops: no exported program traces a detector).
``fused_pyramid_normalize`` resizes one photo to every size of a pyramid,
each level from the photo itself, into one buffer: ``pyramid_plan`` cuts
the levels into (row band, column tile) tiles, one a CTA, so the deep
levels spread over the card. ``fused_crop_resize_normalize`` cuts N boxes
of one image, zeros outside it, each resized to size²: the host looks up
each box side's band tables and copies one table of per-crop records to
the device (``crop_plan`` sets the tiles). Their sums are the resize's, in
the same order, so each level and crop equals a ``fused_resize_normalize``
launch of its own bit for bit. Their launches count in
``fused_resize_normalize.pyramid_launches`` and ``.crop_launches``.
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
              "smem_limit", "ctas_per_sm")

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


def degrade_layout(key: tuple, rows: int, c: int, in_bytes: int) -> tuple[int, int, int]:
    """Shared memory of one low of a degrade with a low per image (an
    operator key) in bands of ``rows`` output rows, ``in_bytes`` a staged
    input element: (rows_off, low_off, smem), the float offsets of its
    [span][S*C] and [span][low*C] buffers and its bytes. The staged rows
    start at 0 (with 16 bytes of slack); the [span][low*C] buffer lies over
    them, which (a) has read before (b) writes it, and the [span][S*C]
    buffer follows the larger of the two. The only definition of this
    layout: the kernel's host code checks that it fits."""
    _, _, w, low, _ = key
    span, in_span = band_spans(key, rows)
    rows_off = max(-(-(in_span * w * c * in_bytes + 16) // 16) * 4, -(-span * low * c // 4) * 4)
    return rows_off, 0, 4 * (rows_off + span * w * c)


def lows_budget(device_smem: tuple[int, int, int], ctas: int) -> int:
    """The shared memory each of ``ctas`` CTAs an SM may take; ``device_smem``
    is (an SM's, what the device reserves for each CTA, the most one CTA may
    have), in bytes."""
    sm, reserved, per_cta = device_smem
    return min(per_cta, sm // ctas - reserved)


@functools.lru_cache(maxsize=64)
def lows_plan(key: tuple, c: int, in_bytes: int, device_smem: tuple[int, int, int],
              ctas_per_sm: int, rows: int | None = None) -> dict:
    """The plan of a degrade with a low per image (a lows key), ``c``
    channels of ``in_bytes`` bytes, on a device of ``device_smem``
    (``lows_budget``) for a kernel built for ``ctas_per_sm`` CTAs an SM.
    Each low takes the tallest band height of S, then ``_SHORTER_ROWS``,
    whose buffers (``degrade_layout``) fit ``lows_budget(device_smem, n)``,
    for the most CTAs an SM n <= ``ctas_per_sm`` at which every low fits a
    height: uint8 at 112²x3 plans two, float32 pil at 112²x3 one (at low 8 a
    row of output reads ~100 input rows, 134 KB). Raises ValueError where a
    low fits no height at one CTA an SM. With ``rows``, every low takes that
    height (the launch checks the device's limit). → ``rows`` per low,
    ``records`` (the kernel's crfr_low_plan per low: rows, rows_off,
    low_off, smem; int32), ``spans`` ((span, in_span) per low at its height,
    int32), ``smem`` and ``bands`` (the most of any low: the launch's), and
    ``budget`` (None with ``rows``)."""
    s = key[1]
    keys = _low_keys(key)
    heights = (s, *(r for r in _SHORTER_ROWS if r < s))
    budget = None
    if rows is not None:
        picks = [min(rows, s)] * len(keys)
    else:
        for n in range(ctas_per_sm, 0, -1):
            budget = lows_budget(device_smem, n)
            picks = [next((r for r in heights
                           if degrade_layout(k, r, c, in_bytes)[2] <= budget), None)
                     for k in keys]
            if None not in picks:
                break
        else:
            raise ValueError(f"a low per image: low {key[2] + picks.index(None)} of "
                             f"{s}x{s}x{c} ({in_bytes}-byte input) fits no band height "
                             f"in the {budget} bytes of shared memory a CTA may have")
    layouts = [degrade_layout(k, r, c, in_bytes) for k, r in zip(keys, picks)]
    rec = np.asarray([(r, *lay) for r, lay in zip(picks, layouts)], np.int32)
    rec.flags.writeable = False
    spans = np.asarray([band_spans(k, r) for k, r in zip(keys, picks)], np.int32)
    spans.flags.writeable = False
    return {"rows": tuple(picks), "records": rec, "spans": spans,
            "smem": max(lay[2] for lay in layouts), "bands": max(-(-s // r) for r in picks),
            "budget": budget}


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


@functools.lru_cache(maxsize=16)
def _lows_device(device: torch.device) -> tuple[tuple[int, int, int], int]:
    """``lows_plan``'s device_smem and ctas_per_sm for ``device``, from the
    device's attributes and the kernel's own constant."""
    lib = _build.load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _build.check(lib, lib.crfr_degrade_lows_device(ctypes.addressof(out)),
                     "crfr_degrade_lows_device")
    return (out[0], out[1], out[2]), out[3]


@functools.lru_cache(maxsize=64)
def _lows_records(key: tuple, c: int, in_bytes: int, rows: int | None,
                  device: torch.device) -> tuple[dict, torch.Tensor]:
    """``lows_plan`` on ``device``, and its records there (the table the
    kernel indexes by low)."""
    plan = lows_plan(key, c, in_bytes, *_lows_device(device), rows)
    return plan, torch.from_numpy(plan["records"].copy()).to(device)


def _info(lib, key: tuple, b: int, c: int, in_code: int, out_code: int, rows: int | None,
          device: torch.device) -> tuple[int, dict]:
    info = (ctypes.c_int * len(_INFO_KEYS))()
    if key[0] == "lows":
        arr, _, _ = _lows_bands(key, device)
        plan, _ = _lows_records(key, c, 1 if in_code == 0 else 4, rows, device)
        err = lib.crfr_degrade_lows_info(in_code, out_code, b, c, ctypes.addressof(arr),
                                         len(arr) // 4, plan["records"].ctypes.data,
                                         plan["spans"].ctypes.data, ctypes.addressof(info))
    elif rows == TWO_PASS:
        arr, _ = _bands(key, device)
        err = lib.crfr_resize_two_pass_info(in_code, out_code, b, c, ctypes.addressof(arr),
                                            ctypes.addressof(info))
    else:
        arr, _ = _bands(key, device)
        err = lib.crfr_resample_info(in_code, out_code, b, c, ctypes.addressof(arr), len(arr),
                                     rows, *band_spans(key, rows), ctypes.addressof(info))
    return err, dict(zip(_INFO_KEYS, info))


@functools.lru_cache(maxsize=_SHAPES)
def _fit_rows(key: tuple, c: int, in_code: int, out_code: int,
              device: torch.device) -> int | None:
    """The default band height: ``RESIZE_ROWS`` for a resize, ``DEGRADE_ROWS``
    for a degrade, or the tallest of ``_SHORTER_ROWS`` below it whose plan
    fits the device's shared memory. When none does, ``TWO_PASS`` for a
    resize, and for a degrade ``DEGRADE_ROWS`` again, so that the launch
    raises with its size. None for a low per image: each low takes its own
    (``lows_plan``)."""
    if key[0] == "lows":
        return None
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
        bands = "each low's bands" if rows is None else f"bands of {rows} rows"
        raise ValueError(f"{what}: {info['smem_bytes']} bytes of shared memory for "
                         f"{size}x{c} in {bands} exceed the "
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
    CTA, the device's shared-memory limit per CTA, the CTAs an SM holds at
    once (``ctas_per_sm``), and ``span`` and ``in_span`` (``band_spans``;
    None for the two-pass plan, which also reports its float32
    ``scratch_bytes``). ``arg`` is ``low`` (a degrade), a tensor of lows (a
    degrade with a low per image in the range ``lows``) or ``out_hw`` (a
    resize). ``rows`` defaults to the height a call takes; ``TWO_PASS`` asks
    for the two-pass plan. The two-pass plan's registers and spills are the
    larger of its two kernels', its CTAs those of both, its rows those of a
    vertical-pass CTA. A low per image reports ``lows_plan``'s: the band
    height of each low (``rows_by_low``), the most bands of any low and the
    budget each low's shared memory fit; ``rows`` is the
    shortest height, CTAs are B times the most bands (band-major; a CTA past
    its low's bands returns at once), and ``span``/``in_span`` are None (each
    low has its own)."""
    b, h, w, c = shape
    key = lows_key(h, lows, mode) if isinstance(arg, torch.Tensor) else operator_key(h, w, arg, mode)
    lib = _build.load_library()
    device = torch.device("cuda", torch.cuda.current_device())
    in_code, out_code = _IN_CODES[in_dtype], _OUT_CODES[out_dtype]
    rows = _fit_rows(key, c, in_code, out_code, device) if rows is None else rows
    err, info = _info(lib, key, b, c, in_code, out_code, rows, device)
    _build.check(lib, err, "resample_info")
    if key[0] == "lows":
        plan, _ = _lows_records(key, c, 1 if in_code == 0 else 4, rows, device)
        return {**info, "plan": "bands", "span": None, "in_span": None,
                "lows": [key[2], key[3]], "rows_by_low": list(plan["rows"]),
                "bands": plan["bands"], "smem_budget": plan["budget"]}
    if rows == TWO_PASS:
        return {**info, "plan": "two_pass", "span": None, "in_span": None,
                "scratch_bytes": 4 * b * h * key[4] * c}
    span, in_span = band_spans(key, rows)
    return {**info, "plan": "bands", "span": span, "in_span": in_span}


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"expected NHWC (B, H, W, C), got shape {tuple(x.shape)}")


def _reference(x: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    xc = x.to(torch.float32).permute(0, 3, 1, 2)          # (B, C, H, W)
    y = torch.matmul(torch.matmul(wr, xc), wc.t())        # (B, C, OH, OW)
    y = (y - MEAN) * (1.0 / STD)
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def _check_launch(x: torch.Tensor, out_dtype: torch.dtype, what: str) -> None:
    """Raise unless the kernel takes ``x`` and ``out_dtype``."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _IN_CODES:
        raise TypeError(f"{what}: input must be uint8 or float32, got {x.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"{what}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous NHWC")


def _launch(x: torch.Tensor, key: tuple, oh: int, ow: int, out_dtype: torch.dtype,
            what: str, rows: int | None = None, low: torch.Tensor | None = None) -> torch.Tensor:
    """One launch on ``x``, in bands of ``rows`` output rows (the default
    plan when None; ``TWO_PASS`` for a resize's two-pass plan); ``low`` the
    (B,) int32 lows of a lows key, whose ``rows`` gives every low that
    height (None: each its own)."""
    _check_launch(x, out_dtype, what)
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
            plan, dev_rec = _lows_records(key, c, x.element_size(), rows, x.device)
            err = lib.crfr_degrade_lows_normalize(
                x.data_ptr(), in_code, out.data_ptr(), out_code, b, c, ctypes.addressof(arr),
                dev.data_ptr(), len(arr) // 4, key[2], low.data_ptr(),
                plan["records"].ctypes.data, dev_rec.data_ptr(), plan["spans"].ctypes.data,
                stream)
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


# ---------------------------------------------------------------------------
# The ragged forms: every level of a photo's pyramid, every crop of a stage
# ---------------------------------------------------------------------------

# What one CTA of a ragged launch may hold and do: its tile's horizontal sums
# ([nl][m*C] f32), the input it stages at a time, and (the pyramid) its
# multiply-adds. A crop takes bands of CROP_ROWS output rows where they fit.
TILE_SUMS_BYTES = 32 << 10
STAGE_BYTES = 48 << 10
TILE_FMAS = 1 << 18
CROP_ROWS = 8
_LEVEL_ALIGN = 64         # elements: each level's output starts at a multiple (256 B of f32)


# ``crfr_window`` of csrc/fused_preprocess.cu as a numpy record (a
# ``crfr_tile`` is five int32): a stage's crops are filled without a loop
_BAND_DTYPE = np.dtype([("start", "<u8"), ("taps", "<u8"), ("n_in", "<i4"), ("n_out", "<i4"),
                        ("n_taps", "<i4"), ("pad", "<i4")])
_WINDOW_DTYPE = np.dtype([("v", _BAND_DTYPE), ("h", _BAND_DTYPE), ("y0", "<i4"), ("x0", "<i4"),
                          ("out", "<i8")])


def _spans(start: np.ndarray, taps: int, step: int) -> np.ndarray:
    """The input extent that each run of ``step`` outputs reads: for the
    outputs [o, o + step) (the last run cut short), start[last] + taps − start[o]."""
    first = np.arange(0, len(start), step)
    last = np.minimum(first + step, len(start)) - 1
    return start[last] + taps - start[first]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _tile_shape(h: int, w: int, oh: int, ow: int, c: int, in_bytes: int,
                mode: str) -> tuple[int, int]:
    """(rows, cols) of a pyramid level's tiles: from bands of ``RESIZE_ROWS``
    rows across the whole width, halve the columns down to 8, then the
    rows down to 1, then the columns down to 1, until a tile's sums and a
    staged row fit and its multiply-adds are at most ``TILE_FMAS``. Column
    tiles cost nothing twice; shorter bands redo the horizontal sums of the
    input rows two bands share."""
    vs, vt = band_table(h, oh, mode)
    hs, ht = band_table(w, ow, mode)
    vt, ht = vt.shape[1], ht.shape[1]
    n, m = min(RESIZE_ROWS, oh), ow
    while True:
        nl, cs = int(_spans(vs, vt, n).max()), int(_spans(hs, ht, m).max())
        fits = nl * m * c * 4 <= TILE_SUMS_BYTES and cs * c * in_bytes <= STAGE_BYTES
        if fits and nl * m * c * ht + n * m * c * vt <= TILE_FMAS:
            return n, m
        if m > 8:
            m = -(-m // 2)
        elif n > 1:
            n = -(-n // 2)
        elif m > 1:
            m = -(-m // 2)
        elif fits:
            return n, m
        else:
            raise ValueError(f"fused_pyramid_normalize: one output of a {h}x{w}x{c} -> "
                             f"{oh}x{ow} level reads {nl} rows of {cs} pixels, beyond "
                             f"the kernel's shared memory")


@functools.lru_cache(maxsize=64)
def pyramid_plan(h: int, w: int, c: int, in_bytes: int, sizes: tuple, mode: str) -> dict:
    """The one launch of a pyramid of an (h, w, c) photo (``in_bytes`` a
    pixel channel) at ``sizes``: ``tiles``, one (level, o0, n, q0, m) a CTA
    (output rows [o0, o0 + n), columns [q0, q0 + m)), the costliest first;
    ``offsets`` of each level's output in the one buffer (multiples of 64
    elements) and its ``total``; ``shapes``, each level's (rows, cols) a
    tile; ``taps_off``, ``stage_off`` and ``smem``, the shared memory a CTA
    takes (the largest tile's sums below ``taps_off``, its horizontal
    weights below ``stage_off``, the staging area above)."""
    tiles, offsets, shapes, off = [], [], [], 0
    sums = weights = stage = 0
    for level, (oh, ow) in enumerate(sizes):
        n, m = _tile_shape(h, w, oh, ow, c, in_bytes, mode)
        vs, vt = band_table(h, oh, mode)
        hs, ht = band_table(w, ow, mode)
        vt, ht = vt.shape[1], ht.shape[1]
        for o0, nl in zip(range(0, oh, n), _spans(vs, vt, n)):
            for q0, cs in zip(range(0, ow, m), _spans(hs, ht, m)):
                nn, mm = min(n, oh - o0), min(m, ow - q0)
                cost = int(nl) * mm * c * ht + nn * mm * c * vt
                tiles.append((cost, (level, o0, nn, q0, mm)))
                sums = max(sums, int(nl) * mm * c * 4)
                weights = max(weights, mm * ht * 4)
                stage = max(stage, min(STAGE_BYTES, int(nl) * int(cs) * c * in_bytes))
        offsets.append(off)
        shapes.append((n, m))
        off += -(-oh * ow * c // _LEVEL_ALIGN) * _LEVEL_ALIGN
    tiles.sort(key=lambda t: -t[0])                    # stable: ties keep their order
    taps_off = _round16(sums)
    stage_off = taps_off + _round16(weights)
    return {"tiles": [t for _, t in tiles], "offsets": offsets, "total": off,
            "shapes": shapes, "taps_off": taps_off, "stage_off": stage_off,
            "smem": stage_off + _round16(stage)}


def _band_record(table: tuple[torch.Tensor, torch.Tensor], n_in: int, n_out: int) -> tuple:
    s, t = table
    return s.data_ptr(), t.data_ptr(), n_in, n_out, t.shape[0], 0


@functools.lru_cache(maxsize=16)
def _pyramid_tables(h: int, w: int, c: int, in_bytes: int, sizes: tuple, mode: str,
                    device: torch.device) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """A pyramid plan's windows and tiles on ``device``, with the band
    tables they point to (cached together, so those outlive the records)."""
    plan = pyramid_plan(h, w, c, in_bytes, sizes, mode)
    tables = tuple((_device_table(h, oh, mode, device), _device_table(w, ow, mode, device))
                   for oh, ow in sizes)
    wins = np.array([(_band_record(tv, h, oh), _band_record(th, w, ow), 0, 0, off)
                     for (oh, ow), (tv, th), off in zip(sizes, tables, plan["offsets"])],
                    _WINDOW_DTYPE)
    tiles = np.asarray(plan["tiles"], np.int32)
    return (torch.from_numpy(wins.view(np.uint8)).to(device),
            torch.from_numpy(tiles.view(np.uint8).ravel()).to(device), tables)


def _pyramid_sizes(sizes) -> tuple[tuple[int, int], ...]:
    sizes = tuple((int(a), int(b)) for a, b in sizes)
    if any(a < 1 or b < 1 for a, b in sizes):
        raise ValueError(f"pyramid sizes must be positive, got {sizes}")
    return sizes


def _check_photo(x: torch.Tensor) -> None:
    _check_input(x)
    if x.shape[0] != 1:
        raise ValueError(f"a pyramid takes one photo (1, H, W, C), got {tuple(x.shape)}")


def fused_pyramid_normalize_reference(x: torch.Tensor, sizes, mode: str = "pil",
                                      out_dtype: torch.dtype = torch.float32
                                      ) -> list[torch.Tensor]:
    """Plain PyTorch version of ``fused_pyramid_normalize``: each level by
    ``fused_resize_normalize_reference``."""
    _check_photo(x)
    return [fused_resize_normalize_reference(x, hw, mode, out_dtype)
            for hw in _pyramid_sizes(sizes)]


def fused_pyramid_normalize(x: torch.Tensor, sizes, mode: str = "pil",
                            out_dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """One photo (1, H, W, C) of raw pixels, uint8 or f32 → each of
    ``sizes`` ((h, w) pairs, e.g. ``MTCNN.pyramid_sizes``) bicubic-resized
    from the photo itself and normalized: a list of (1, h, w, C)
    ``out_dtype``. On a CUDA tensor every level comes from one launch, each
    a contiguous view into one buffer, counted in
    ``fused_resize_normalize.pyramid_launches``; each level equals
    ``fused_resize_normalize`` of the photo at its size bit for bit. Not a
    custom op: no exported program traces a detector."""
    _check_photo(x)
    sizes = _pyramid_sizes(sizes)
    if x.device.type == "cpu":
        return fused_pyramid_normalize_reference(x, sizes, mode, out_dtype)
    what = "fused_pyramid_normalize"
    _check_launch(x, out_dtype, what)
    if not sizes:
        return []
    _, h, w, c = x.shape
    in_code, out_code = _IN_CODES[x.dtype], _OUT_CODES[out_dtype]
    plan = pyramid_plan(h, w, c, x.element_size(), sizes, mode)
    wins, tiles, _ = _pyramid_tables(h, w, c, x.element_size(), sizes, mode, x.device)
    lib = _build.load_library()
    out = torch.empty(plan["total"], dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.crfr_pyramid_normalize(
            x.data_ptr(), in_code, out.data_ptr(), out_code, h, w, c, wins.data_ptr(),
            tiles.data_ptr(), len(plan["tiles"]), plan["taps_off"], plan["stage_off"],
            plan["smem"],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, what)
    fused_resize_normalize.pyramid_launches += 1
    return [out[o:o + oh * ow * c].view(1, oh, ow, c)
            for (oh, ow), o in zip(sizes, plan["offsets"])]


def _host_boxes(boxes) -> np.ndarray:
    """(N, 4) integer [x1, y1, x2, y2] boxes held on the host → int64 numpy."""
    if isinstance(boxes, torch.Tensor):
        if boxes.device.type != "cpu":
            raise ValueError("the boxes are read on the host (each crop's factors are "
                             "looked up there): pass a numpy array or a CPU tensor")
        boxes = boxes.numpy()
    b = np.asarray(boxes)
    if b.ndim != 2 or b.shape[1] != 4 or not np.issubdtype(b.dtype, np.integer):
        raise TypeError(f"boxes must be integer (N, 4) [x1, y1, x2, y2], got {b.dtype} "
                        f"{b.shape}")
    return b.astype(np.int64)


def _check_image(img: torch.Tensor) -> None:
    if img.ndim != 3:
        raise ValueError(f"expected one image (H, W, C), got shape {tuple(img.shape)}")


def padded_crop(img: torch.Tensor, x1: int, y1: int, x2: int, y2: int) -> torch.Tensor:
    """The window [y1, y2) × [x1, x2) of ``img`` (H, W, C), zeros where it
    leaves the image (a view where it does not)."""
    h, w, c = img.shape
    sx1, sy1, sx2, sy2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
    if (sx1, sy1, sx2, sy2) == (x1, y1, x2, y2):
        return img[y1:y2, x1:x2]
    crop = torch.zeros((y2 - y1, x2 - x1, c), dtype=img.dtype, device=img.device)
    if sx2 > sx1 and sy2 > sy1:
        crop[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = img[sy1:sy2, sx1:sx2]
    return crop


def fused_crop_resize_normalize_reference(img: torch.Tensor, boxes, size: int,
                                          mode: str = "pil",
                                          out_dtype: torch.dtype = torch.float32
                                          ) -> torch.Tensor:
    """Plain PyTorch version of ``fused_crop_resize_normalize``: each box
    cut from ``img`` by ``padded_crop`` and resized by
    ``fused_resize_normalize_reference``."""
    _check_image(img)
    b = _host_boxes(boxes)
    c = img.shape[2]
    out = torch.full((len(b), size, size, c), -MEAN / STD, dtype=out_dtype, device=img.device)
    for i, (x1, y1, x2, y2) in enumerate(b.tolist()):
        if x2 > x1 and y2 > y1:
            crop = padded_crop(img, x1, y1, x2, y2)[None]
            out[i] = fused_resize_normalize_reference(crop, (size, size), mode, out_dtype)[0]
    return out


@functools.lru_cache(maxsize=_SHAPES)
def _crop_extents(side: int, size: int, mode: str) -> np.ndarray:
    """For k = 1 ... size: the most input rows (or columns) that a run of k
    of the ``size`` outputs of a crop of ``side`` reads."""
    start, taps = band_table(side, size, mode)
    out = np.asarray([_spans(start, taps.shape[1], k).max() for k in range(1, size + 1)])
    out.flags.writeable = False
    return out


def crop_plan(heights, widths, size: int, c: int, in_bytes: int, mode: str) -> dict:
    """The one launch of a stage's crops of these box heights and widths
    (those with area): each crop in tiles of ``rows`` × ``cols`` outputs,
    one a CTA (bands of ``CROP_ROWS`` rows across the crop where their sums
    fit, else shorter bands, then narrower column tiles), ``taps_off``,
    ``stage_off`` and ``smem`` as in ``pyramid_plan``. Raises when one
    output's sums or one staged row do not fit."""
    ext = [np.max([_crop_extents(s, size, mode) for s in set(map(int, sides))], 0)
           if len(sides) else np.ones(size, np.int64) for sides in (heights, widths)]
    rows, cols = min(CROP_ROWS, size), size
    while True:
        nl, pitch = int(ext[0][rows - 1]), int(ext[1][cols - 1]) * c * in_bytes
        sums = nl * cols * c * 4
        if sums <= TILE_SUMS_BYTES and pitch <= STAGE_BYTES:
            taps_off = _round16(sums)
            stage_off = taps_off + _round16(cols * int(ext[1][0]) * 4)    # ext[1][0]: taps
            return {"rows": rows, "cols": cols, "taps_off": taps_off, "stage_off": stage_off,
                    "smem": stage_off + _round16(min(STAGE_BYTES, nl * pitch))}
        if rows > 1:
            rows = -(-rows // 2)
        elif cols > 1:
            cols = -(-cols // 2)
        else:
            raise ValueError(f"fused_crop_resize_normalize: a crop of {max(heights)}x"
                             f"{max(widths)} -> {size}x{size}x{c} is beyond the kernel's "
                             f"shared memory")


@functools.lru_cache(maxsize=_SHAPES)
def _side_factor(side: int, size: int, mode: str, device: torch.device) -> tuple:
    """A crop side's factor (side → size) on ``device``: its band tables'
    start and taps pointers, its taps, and the tables (kept alive here)."""
    start, taps = _device_table(side, size, mode, device)
    return start.data_ptr(), taps.data_ptr(), taps.shape[0], (start, taps)


def _crop_windows(b: np.ndarray, size: int, c: int, mode: str,
                  device: torch.device) -> tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Each box's ``crfr_window`` as a numpy record (its origin and the band
    tables of its two factors, looked up once a side), the heights and widths
    of the boxes with area, and the factors the records point to."""
    cw, ch = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    ok = (cw > 0) & (ch > 0)
    sides = np.unique(np.concatenate([cw[ok], ch[ok]]))
    factors = [_side_factor(int(s), size, mode, device) for s in sides]
    start = np.array([f[0] for f in factors], np.uint64)
    taps = np.array([f[1] for f in factors], np.uint64)
    n_taps = np.array([f[2] for f in factors], np.int32)
    win = np.zeros(len(b), _WINDOW_DTYPE)
    for field, side in (("v", ch), ("h", cw)):
        i = np.searchsorted(sides, side[ok])
        rec = win[field]
        rec["start"][ok], rec["taps"][ok], rec["n_taps"][ok] = start[i], taps[i], n_taps[i]
        rec["n_in"][ok], rec["n_out"][ok] = side[ok], size
    win["y0"], win["x0"] = b[:, 1], b[:, 0]
    win["out"] = np.arange(len(b), dtype=np.int64) * size * size * c
    return win, ch[ok], cw[ok], factors


def fused_crop_resize_normalize(img: torch.Tensor, boxes, size: int, mode: str = "pil",
                                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One image (H, W, C) of raw pixels, uint8 or f32, and N boxes
    [x1, y1, x2, y2] (an integer (N, 4) array on the host: numpy or a CPU
    tensor) → (N, size, size, C) ``out_dtype``: each box's window of the
    image, zero where it leaves the image, bicubic-resized to size² and
    normalized; a box with no area gives (0 − 127.5)/128 everywhere. On a
    CUDA image every crop comes from one launch, counted in
    ``fused_resize_normalize.crop_launches``: the host looks up each side's
    band tables and copies one table of per-crop structs (box and factors)
    to the device. Each crop equals ``fused_resize_normalize`` of the
    zero-padded crop bit for bit. Not a custom op: no exported program
    traces a detector."""
    _check_image(img)
    b = _host_boxes(boxes)
    if img.device.type == "cpu":
        return fused_crop_resize_normalize_reference(img, b, size, mode, out_dtype)
    what = "fused_crop_resize_normalize"
    _check_launch(img, out_dtype, what)
    h, w, c = img.shape
    out = torch.empty((len(b), size, size, c), dtype=out_dtype, device=img.device)
    if len(b) == 0:
        return out
    win, heights, widths, _tables = _crop_windows(b, size, c, mode, img.device)
    plan = crop_plan(heights, widths, size, c, img.element_size(), mode)
    # pinned, so the copy waits on nothing the stream still runs
    dev = torch.from_numpy(win.view(np.uint8)).pin_memory().to(img.device, non_blocking=True)
    lib = _build.load_library()
    with torch.cuda.device(img.device):
        err = lib.crfr_crop_resize_normalize(
            img.data_ptr(), _IN_CODES[img.dtype], out.data_ptr(), _OUT_CODES[out_dtype], h, w,
            c, dev.data_ptr(), len(b), size, plan["rows"], plan["cols"], plan["taps_off"],
            plan["stage_off"], plan["smem"],
            torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(lib, err, what)
    fused_resize_normalize.crop_launches += 1
    return out


fused_resize_normalize.pyramid_launches = 0   # launches of the pyramid form
fused_resize_normalize.crop_launches = 0      # launches of the crop form


def ragged_info(in_dtype: torch.dtype = torch.uint8, out_dtype: torch.dtype = torch.float32,
                crops: bool = False) -> dict:
    """The pyramid kernel (or, with ``crops``, the crop kernel) as compiled
    for these types on the current CUDA device: registers and local-memory
    (spill) bytes per thread, threads per CTA, the shared memory a CTA may
    have."""
    lib = _build.load_library()
    info = (ctypes.c_int * 4)()
    err = lib.crfr_ragged_info(_IN_CODES[in_dtype], _OUT_CODES[out_dtype], int(crops),
                               ctypes.addressof(info))
    _build.check(lib, err, "ragged_info")
    return dict(zip(("registers", "spill_bytes", "threads", "smem_limit"), info))

"""Where the preprocessing kernel's time goes, pass by pass, on one CUDA card.

    python -m crfr_torch.bench.preprocess_phases [--batch 256] [--rows 112,56,28,16]
    python -m crfr_torch.bench.preprocess_phases --lows [--batch 512] [--rows own,56,28]

Builds ``ops/csrc/fused_preprocess.cu`` with ``-DCRFR_PHASE_CLOCK`` into its
own library under ``build/``: thread 0 of every CTA then records the global
timer after each pass (stage, a, b, c, d) and its SM. Runs the main case
(B images of 112x112x3 uint8 -> bf16, degrade to 16 px, pil) at each band
height and prints one JSON line per height: the kernel's span from the
first CTA's start to the last one's end, per-pass medians and 90th
percentiles over the CTAs, CTA durations, and CTAs per SM. The timer costs
a few global stores per CTA; the production build has none.

With ``--lows``, the form with a low per image instead, as the train step
calls it: B=512 images of 112x112x3 uint8 -> bf16, pil, lows drawn from
8-112 as ``chip_smoke.py``'s ``phase_kernels_lows`` draws them, in the
default plan (each low its own band height) or, with ``--rows``, every low
at each of those heights. One JSON line a plan: the plan, the kernel's
span, its CUDA-event time from the production library, the CTAs that
worked and those that returned at once, CTAs resident on an SM at once
(the most and the median over the SMs, from the clock) beside the
occupancy API's, waves, and by bucket of lows (8-16, 17-40, 41-80, 81-112)
the CTAs, their band heights, per-pass medians and CTA medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from crfr_torch.device import resolve_device
from crfr_torch.ops import _build
from crfr_torch.ops import fused_preprocess as fp

PASSES = ("stage", "a_vertical_down", "b_horizontal_down", "c_horizontal_up",
          "d_vertical_up_store")


def _library() -> ctypes.CDLL:
    src = _build.SOURCES[0]
    so = _build.BUILD_DIR / "libcrfr_preprocess_phase_clock.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DCRFR_PHASE_CLOCK", "-shared",
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crfr_resample_normalize.argtypes = [p, i, p, i, i, i, p, i, i, i, i, p]
    lib.crfr_pyramid_normalize.argtypes = [p, i, p, i, i, i, i, p, p, i, i, i, i, p]
    lib.crfr_degrade_lows_normalize.argtypes = [p, i, p, i, i, i, p, p, i, i, p, p, p, p, p]
    lib.crfr_resample_phase_clock.argtypes = [p]
    lib.crfr_error_string.argtypes = [i]
    lib.crfr_error_string.restype = ctypes.c_char_p
    return lib


def phases(batch: int = 256, rows_list=(112, 56, 28, 16), device="cuda") -> list[dict]:
    dev = resolve_device(device)
    lib = _library()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 256, (batch, 112, 112, 3), generator=g, device=dev, dtype=torch.uint8)
    key = fp.operator_key(112, 112, 16, "pil")
    arr, _ = fp._bands(key, dev)
    out = torch.empty_like(x, dtype=torch.bfloat16)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    results = []
    for rows in rows_list:
        ctas = batch * -(-112 // rows)
        clock = torch.zeros((ctas, 8), dtype=torch.int64, device=dev)
        _build.check(lib, lib.crfr_resample_phase_clock(clock.data_ptr()), "phase clock")
        for _ in range(5):                                   # the last run is read
            err = lib.crfr_resample_normalize(
                x.data_ptr(), 0, out.data_ptr(), 1, batch, 3, ctypes.addressof(arr), len(arr),
                rows, *fp.band_spans(key, rows), torch.cuda.current_stream(dev).cuda_stream)
            _build.check(lib, err, "fused_degrade_normalize")
        torch.cuda.synchronize(dev)
        d = clock.cpu().numpy()
        t = d[:, :6] - d[:, :6].min()
        per_pass = np.diff(t, axis=1) / 1e3                    # us
        cta = (t[:, 5] - t[:, 0]) / 1e3
        per_sm = np.bincount(d[:, 7], minlength=torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
        results.append({
            "rows": rows, "ctas": ctas, "card": card,
            "kernel_span_us": float(t[:, 5].max() / 1e3),
            "pass_us_median": dict(zip(PASSES, np.median(per_pass, 0).round(3).tolist())),
            "pass_us_p90": dict(zip(PASSES, np.percentile(per_pass, 90, 0).round(3).tolist())),
            "cta_us_median": float(np.median(cta)), "cta_us_max": float(cta.max()),
            "cta_end_us_percentiles_0_50_100": (np.percentile(t[:, 5], [0, 50, 100]) / 1e3)
            .round(3).tolist(),
            "ctas_per_sm_min_max": [int(per_sm.min()), int(per_sm.max())]})
    _build.check(lib, lib.crfr_resample_phase_clock(None), "phase clock")
    return results


LOW_BUCKETS = ((8, 16), (17, 40), (41, 80), (81, 112))


def _resident(start: np.ndarray, end: np.ndarray) -> int:
    """The most intervals [start, end) open at one time."""
    ev = sorted([(t, 1) for t in start] + [(t, -1) for t in end], key=lambda e: (e[0], e[1]))
    most = cur = 0
    for _, d in ev:
        cur += d
        most = max(most, cur)
    return most


def _event_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000 * iters)          # the host's enqueue does not pace the reading
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lows_phases(batch: int = 512, rows_list=(None,), device="cuda") -> list[dict]:
    """The form with a low per image, pass by pass, by bucket of lows, in
    each plan of ``rows_list`` (None: each low its own band height)."""
    dev = resolve_device(device)
    lib = _library()
    g = torch.Generator(device=dev).manual_seed(7)       # chip_smoke.py's phase_kernels_lows
    x = torch.randint(0, 256, (batch, 112, 112, 3), generator=g, device=dev, dtype=torch.uint8)
    lows = torch.randint(8, 113, (batch,), generator=g, device=dev, dtype=torch.int32)
    key = fp.lows_key(112, (8, 112), "pil")
    arr, dev_ops, _ = fp._lows_bands(key, dev)
    out = torch.empty_like(x, dtype=torch.bfloat16)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    for rows in rows_list:
        info = fp.resample_info(tuple(x.shape), lows, "pil", torch.uint8, torch.bfloat16,
                                rows=rows, lows=(8, 112))
        plan, dev_rec = fp._lows_records(key, 3, 1, rows, dev)
        ctas = info["ctas"]
        clock = torch.zeros((ctas, 8), dtype=torch.int64, device=dev)
        _build.check(lib, lib.crfr_resample_phase_clock(clock.data_ptr()), "phase clock")
        for _ in range(5):                                   # the last run is read
            err = lib.crfr_degrade_lows_normalize(
                x.data_ptr(), 0, out.data_ptr(), 1, batch, 3, ctypes.addressof(arr),
                dev_ops.data_ptr(), len(arr) // 4, 8, lows.data_ptr(), plan["records"].ctypes.data,
                dev_rec.data_ptr(), plan["spans"].ctypes.data, stream)
            _build.check(lib, err, "fused_degrade_normalize")
        torch.cuda.synchronize(dev)
        _build.check(lib, lib.crfr_resample_phase_clock(None), "phase clock")
        d = clock.cpu().numpy()
        d = d[d[:, 5] != 0]                                  # the CTAs that worked
        low = d[:, 6]
        t = d[:, :6] - d[:, :6].min()
        per_pass = np.diff(t, axis=1) / 1e3                  # us
        cta = (t[:, 5] - t[:, 0]) / 1e3
        resident = [_resident(t[d[:, 7] == sm, 0], t[d[:, 7] == sm, 5]) for sm in range(n_sm)]
        height = np.asarray(plan["rows"])[low - 8]
        buckets = {}
        for lo, hi in LOW_BUCKETS:
            sel = (low >= lo) & (low <= hi)
            if sel.any():
                buckets[f"{lo}-{hi}"] = {
                    "ctas": int(sel.sum()), "rows": sorted(set(height[sel].tolist())),
                    "pass_us_median": dict(zip(PASSES,
                                               np.median(per_pass[sel], 0).round(3).tolist())),
                    "cta_us_median": float(np.median(cta[sel]))}
        ms = _event_ms(lambda: fp._launch(x, key, 112, 112, torch.bfloat16,  # noqa: B023
                                          "fused_degrade_normalize", rows=rows, low=lows))
        results.append({
            "form": "lows", "batch": batch, "card": card, "rows": rows,
            "plan": {k: info[k] for k in ("rows", "bands", "ctas", "smem_bytes", "registers",
                                          "spill_bytes", "ctas_per_sm")},
            "kernel_span_us": float(t[:, 5].max() / 1e3), "event_ms": ms,
            "ctas_worked": int(len(d)), "ctas_returned": int(ctas - len(d)),
            "ctas_resident_per_sm_max_median": [int(max(resident)),
                                                float(np.median(resident))],
            "waves": len(d) / (n_sm * max(1, info["ctas_per_sm"])),
            "pass_us_median": dict(zip(PASSES, np.median(per_pass, 0).round(3).tolist())),
            "cta_us_median": float(np.median(cta)), "by_lows": buckets})
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None, help="images (256; --lows: 512)")
    ap.add_argument("--rows", default=None,
                    help="band heights, comma-separated (112,56,28,16; --lows: each low's own, "
                         "'own' in the list)")
    ap.add_argument("--lows", action="store_true",
                    help="the form with a low per image (B=512 unless --batch)")
    args = ap.parse_args()
    if args.lows:
        rows = tuple(None if v == "own" else int(v) for v in (args.rows or "own").split(","))
        for r in lows_phases(args.batch or 512, rows):
            print(json.dumps(r), flush=True)
        return
    for r in phases(args.batch or 256, tuple(int(v) for v in (args.rows or "112,56,28,16")
                                             .split(","))):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

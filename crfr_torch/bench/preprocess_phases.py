"""Where the preprocessing kernel's time goes, pass by pass, on one CUDA card.

    python -m crfr_torch.bench.preprocess_phases [--batch 256] [--rows 112,56,28,16]

Builds ``ops/csrc/fused_preprocess.cu`` with ``-DCRFR_PHASE_CLOCK`` into its
own library under ``build/``: thread 0 of every CTA then records the global
timer after each pass (stage, a, b, c, d) and its SM. Runs the main case
(B images of 112x112x3 uint8 -> bf16, degrade to 16 px, pil) at each band
height and prints one JSON line per height: the kernel's span from the
first CTA's start to the last one's end, per-pass medians and 90th
percentiles over the CTAs, CTA durations, and CTAs per SM. The timer costs
a few global stores per CTA; the production build has none.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rows", default="112,56,28,16", help="band heights, comma-separated")
    args = ap.parse_args()
    for r in phases(args.batch, tuple(int(v) for v in args.rows.split(","))):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

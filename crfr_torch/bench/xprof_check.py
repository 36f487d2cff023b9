"""Where the embed batch's device time goes: ``trace_embed`` of
crfr/bench/xprof_check.py, with torch.profiler in place of jax.profiler.

    python -m crfr_torch.bench.xprof_check [--batch 256] [--steps 10]

Runs ``steps`` back-to-back calls of the bf16 embed pipeline
(``bench.throughput.build_embed_pipeline``) on one CUDA card, once
untraced and once under the profiler, warmup outside both, and prints one
JSON line: wall ms per batch (untraced and traced), device busy ms per
batch (the union of kernel intervals in the trace), the idle share of the
traced window, device time per batch by kernel group, and the heaviest
kernels by name. Kernels are read from the profiler's Chrome trace (events
of category ``kernel``); a trace with none raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from crfr_torch.bench.throughput import build_embed_pipeline
from crfr_torch.device import resolve_device

# kernel group ← substrings of the kernel's name, tried in this order
_GROUPS = (
    ("preprocess", ("resample_normalize",)),
    ("conv", ("conv", "fprop", "implicit", "dgrad", "wgrad")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_")),
    ("gemm", ("gemm", "gemv")),
    ("elementwise", ("elementwise", "vectorized", "reduce")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def trace_embed(batch: int = 256, steps: int = 10, backbone: str = "ir_50",
                degrade_to: int = 16, image_size: int = 112, top: int = 12,
                device: str | torch.device = "cuda", seed: int = 0) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("trace_embed measures the CUDA device")
    embed = build_embed_pipeline(backbone, degrade_to, image_size, device=dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (batch, image_size, image_size, 3), generator=g,
                      device=dev, dtype=torch.uint8)

    def window() -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            embed(x)
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0) / steps

    for _ in range(3):
        embed(x)
    untraced_ms = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = window()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernels on the device")

    by_name: dict[str, list[float]] = {}
    groups: dict[str, float] = {}
    for e in kernels:
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
        groups[_group(e["name"])] = groups.get(_group(e["name"]), 0.0) + e["dur"]
    busy_ms = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels]) / 1e3 / steps
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    return {
        "backbone": backbone, "batch": batch, "steps": steps, "degrade_to": degrade_to,
        "card": smi,
        "wall_ms_per_batch": untraced_ms,
        "traced_wall_ms_per_batch": traced_ms,
        "device_busy_ms_per_batch": busy_ms,
        "idle_share_traced": 1.0 - busy_ms / traced_ms,
        "kernel_launches_per_batch": len(kernels) / steps,
        "group_ms_per_batch": {k: v / 1e3 / steps for k, v in
                               sorted(groups.items(), key=lambda kv: -kv[1])},
        "heaviest": [{"name": n[:120], "ms_per_batch": t / 1e3 / steps,
                      "calls_per_batch": c / steps} for n, (t, c) in heaviest],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--backbone", default="ir_50")
    args = ap.parse_args()
    print(json.dumps(trace_embed(args.batch, args.steps, args.backbone)), flush=True)


if __name__ == "__main__":
    main()

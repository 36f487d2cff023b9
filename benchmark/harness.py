"""One run of one cell: set-up, the measured window, the traced segment, the
check against the reference, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
names the cell's configuration and traffic mix; ``benchmark/configs/
<config>.json`` and ``benchmark/traffic/<traffic>.json`` hold their
parameters; the traffic names its driver, ``benchmark/drivers/<driver>.py``;
each metric is read by ``benchmark/metrics/<metric>.py``; the limits of the
cell's comparison are in ``benchmark/limits/<workload>.json``.

A driver (``Driver(cell, seed, device, fault)``) builds the program and
its inputs from the seed and runs whatever steps its check needs during
set-up; ``call()`` is one timed call; ``check()``, on rank 0 once the
window has closed, frees the program and compares what it produced with the
reference: → (readings by name, calls attempted, calls failed).

On more than one card each rank runs this in its own process (started by
``torch.distributed.run``); rank 0 gathers the others' traces and peaks and
prints the line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import re
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "crfr")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
SEGMENT_S = 1.0             # the traced segment's length
ESTIMATE_S = 0.4            # the calls timed in set-up to size the window


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str, e2e_of_cell: set) -> bool:
    """A per-layer metric is read in the cells its ``workloads`` list, or
    without that key in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_of_cell


def load_cell(root: Path, workload: str) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload, names)]
    bench = root / "benchmark"
    return Cell(name=workload, chips=int(w["chips"]),
                config=_json(root / configs[w["config"]]["file"]),
                traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench / "limits" / f"{workload}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold dots)."""
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = ROOT / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Runtime:
    """This process's device, rank and world, and the collectives the
    harness needs between ranks."""

    def __init__(self, device: str):
        from crfr_torch.parallel.multihost import maybe_initialize_distributed

        self.world, self.rank = 1, 0
        maybe_initialize_distributed(device)
        self.device = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
                       else torch.device("cpu"))
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            self.world, self.rank = (torch.distributed.get_world_size(),
                                     torch.distributed.get_rank())

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def broadcast(self, value):
        if self.world == 1:
            return value
        box = [value]
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def gather(self, value) -> list:
        if self.world == 1:
            return [value]
        out = [None] * self.world
        torch.distributed.all_gather_object(out, value)
        return out

    def close(self) -> None:
        if self.world > 1:
            torch.distributed.destroy_process_group()


def _timed_calls(driver, rt: Runtime, n: int) -> float:
    rt.sync()
    t = time.perf_counter()
    for _ in range(n):
        driver.call()
    rt.sync()
    return time.perf_counter() - t


def seconds_per_call(driver, rt: Runtime) -> float:
    """Time a few calls after warm-ups, so the window can be sized; rank 0's."""
    one = _timed_calls(driver, rt, 1)
    n = max(2, math.ceil(ESTIMATE_S / max(one, 1e-4)))
    return rt.broadcast(_timed_calls(driver, rt, n) / n)


def segment_calls(per_call: float) -> int:
    return max(3, math.ceil(SEGMENT_S / per_call))


def traced_segment(driver, rt: Runtime, k: int) -> dict:
    """Profile ``k`` calls after one more that the profiler's start-up takes
    and its schedule leaves out of the trace. On the card the profiler
    records the device alone: its host-side recording of every operator
    would slow the host's issue and leave the device idle for it."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from benchmark.trace import load_events, summarize

    cuda = rt.device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"trace_{rt.rank}.json")
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            driver.call()
            rt.sync()
            prof.step()
            first = driver.calls
            with record_function("bench::segment"):
                for _ in range(k):
                    driver.call()
                rt.sync()
            prof.step()
        summary = summarize(load_events(path), None if cuda else "bench::segment")
    summary["calls"] = k
    summary["info"] = driver.segment_info(first, k)
    return summary


def _metric_values(entries: list, traces, ctx: dict) -> dict:
    out = {}
    for m in entries:
        v = load_module("metrics", m["name"]).read(traces, ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def card_line(rt: Runtime) -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    if rt.device.type != "cuda":
        return None
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "-i", str(rt.device.index)],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None


def run(args, t0: float) -> int:
    rt = Runtime(args.device)
    cell = load_cell(Path(args.root), args.workload)
    driver_mod = load_module("drivers", cell.traffic["driver"])
    if args.calibrate:
        return calibrate(driver_mod, cell, args, rt)
    driver = driver_mod.Driver(cell, args.seed, rt, args.fault)
    per_call = seconds_per_call(driver, rt)
    n = max(3, math.ceil(args.seconds / per_call))
    k = segment_calls(per_call)
    if hasattr(driver, "reserve"):
        driver.reserve(n + (k + 1 if args.trace else 0))
    rt.sync()
    setup_s = time.time() - t0
    first = driver.calls
    ta = time.perf_counter()
    for _ in range(n):
        driver.call()
    rt.sync()
    window_s = time.perf_counter() - ta
    summary = traced_segment(driver, rt, k) if args.trace else None
    peak = torch.cuda.max_memory_allocated(rt.device) if rt.device.type == "cuda" else 0
    gathered = rt.gather((summary, peak))
    rt.close()
    if rt.rank != 0:
        return 0
    card = card_line(rt)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    readings, attempted, failed = driver.check(first, n)
    del driver
    gc.collect()
    checks = {name: {"value": v, "limit": cell.limits[name]} for name, v in readings.items()}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    ctx = {"cards": cell.chips, "setup_s": setup_s, "window_s": window_s,
           "window_calls": n, "images_per_call": driver_mod.images_per_call(cell),
           "flops_per_call": driver_mod.flops_per_call(cell),
           "config": cell.config, "traffic": cell.traffic}
    device = {"platform": "gpu" if rt.device.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(rt.device) if rt.device.type == "cuda"
              else "cpu",
              "count": cell.chips, "memory_peak_bytes": max(p for _, p in gathered)}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if args.trace:
        from benchmark.trace import top_kernels

        traces = [s for s, _ in gathered]
        result["metrics"] = _metric_values(cell.per_layer, traces, ctx)
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        result["device"] = device
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in top_kernels(traces)],
            "idle_gaps": sorted((g for t in traces for g in t["gaps"]),
                                key=lambda g: -g[1])[:10]}
    else:
        result["metrics"] = _metric_values(cell.end_to_end, None, ctx)
        result["device"] = device
    result["checks"] = checks
    if card:
        print(json.dumps({"card": card, "window_calls": n, "window_s": window_s,
                          "set_up_s_per_call": per_call}), flush=True)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def calibrate(driver_mod, cell: Cell, args, rt: Runtime) -> int:
    """The readings that set the limits: the program's on ``--calibrate``
    seeds from ``--seed`` on (a short window of ``--seconds`` each), and on
    the first ``--control-seeds`` of them the control's and each fault's,
    planted in the reference. One JSON line a seed."""
    for i in range(args.calibrate):
        seed = args.seed + i
        t = time.time()
        driver = driver_mod.Driver(cell, seed, rt, None)
        per_call = seconds_per_call(driver, rt)
        first = driver.calls
        n = max(3, math.ceil(args.seconds / per_call))
        if hasattr(driver, "reserve"):
            driver.reserve(n)
        for _ in range(n):
            driver.call()
        rt.sync()
        if rt.rank == 0:
            _, attempted, failed = driver.check(first, n)
            row = {"seed": seed, "program": driver.detail, "attempted": attempted,
                   "failed": failed}
            if i < args.control_seeds:
                row.update(driver.planted())
            row["seconds"] = time.time() - t
            print(json.dumps(row), flush=True)
        del driver
        gc.collect()
        if rt.device.type == "cuda":
            torch.cuda.empty_cache()
        rt.broadcast(None)                      # the others wait for rank 0's reference
    rt.close()
    return 0

"""The program's spans (``utils.profiling``) on the card: what they cost with
no profiler and under a device-only one, whether their log sits on the
trace's clock, whether a train step's children add up to it, and where the
device idles, by span.

    python -m crfr_torch.bench.spans_check --path train|embed [--calls N] [--reps R]
        [--classes C] [--out FILE]

``train``: the casia_arcface preset's step (``bench.throughput.
train_config``, IR-50, 10,572 classes, or ``--classes``: over 32,768 the
CE streams in blocks) at batch 512 on a pool of 4 device-resident batches
with a low per image in 8..112. ``embed``:
``serve.build_serving_fn`` over the same IR-50 (bf16), 256 probes degraded
112→16→112, on a pool of 4 batches. Windows of N calls, fenced; one JSON
line, with the card:

- ``span_ns``: an ``annotate`` (a ``with`` block) and a ``begin``/``end``
  pair while no profiler runs, ns each on the host (10⁶ calls), beside an
  empty ``with`` of the null context, and, after the rest, under a
  device-only profiler (10⁴ calls each), an ``annotate`` on a CUDA device
  (the range, the record, two events) and a ``detail`` one (the range and
  the record); ``off_share_pct`` and ``on_share_pct``: the spans a call
  opens times those costs, over the call's ms with no profiler;
- ``plain_ms``: ms a call with no profiler, before and after the rest;
- ``first_trace``: the process's first profiler, of the device alone, over
  one window with the spans in their default mode (the benchmark's traced
  segment): ms a call, each span's mean host and device ms, and from the
  trace merged with the log by ``span_events``: the device's idle by span
  (each gap put to the innermost span whose host interval holds the launch
  the device waited for; ``xprof_check._span_groups``), and for ``train``
  the ``clock``: the ``multi_tensor_apply`` kernels (the optimizer's foreach
  norms and update) whose runtime launch lies inside a ``train.optimizer``
  span, and ``head``: the ``train.head`` spans' counts, and whether each
  holds (``head_counts_hold``);
- ``windows``: ms a call of R × (on, off, off, on) windows under one
  device-only profiler, the spans in their default mode or ``"off"``
  (``profiling.span_mode``); ``on_cost_pct`` from their medians;
- ``all``: one more profiled window with every span device-timed
  (``"all"``): ``spans`` and ``consistency`` (the root's device ms a call
  against its children's sum).
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

from crfr_torch.bench.xprof_check import _span_groups
from crfr_torch.utils import profiling


def span_ns(n: int = 10 ** 6, on: bool = False) -> dict:
    """ns a span on the host: off (``n`` calls), or ``on`` under a profiler
    of the device (10⁴ calls), device-timed and ``detail``."""
    dev = torch.device("cuda")
    null = profiling._NULL

    def per(body, **kw) -> float:
        t = time.perf_counter_ns()
        body(**kw)
        return (time.perf_counter_ns() - t) / n

    def spans(detail=False):
        for _ in range(n):
            with profiling.annotate("x", dev, detail=detail):
                pass

    def pairs():
        for _ in range(n):
            profiling.end(profiling.begin("x", dev))

    def nulls():
        for _ in range(n):
            with null:
                pass

    if not on:
        return {"annotate": per(spans), "begin_end": per(pairs), "null_with": per(nulls)}
    n = 10 ** 4
    with profile(activities=[ProfilerActivity.CUDA]):
        out = {"annotate_on": per(spans), "annotate_on_detail": per(spans, detail=True)}
    torch.cuda.synchronize()
    profiling.clear()
    return out


def _window(call, n: int) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / n


def _traced(call, n: int, path: str | None = None) -> float:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms = _window(call, n)
    if path:
        prof.export_chrome_trace(path)
    return ms


def _means(calls: int) -> dict:
    """Each span name's host and device ms a call over the log."""
    out: dict[str, dict] = {}
    for r in profiling.spans():
        m = out.setdefault(r["name"], {"host_ms": 0.0, "device_ms": None})
        m["host_ms"] += r["host_ms"] / calls
        if r["device_ms"] is not None:
            m["device_ms"] = (m["device_ms"] or 0.0) + r["device_ms"] / calls
    return out


def _by_span(path: str, calls: int) -> dict:
    """The device's idle in a trace by span (ms a call, ``outside`` where
    no span holds the launch), the whole idle share of the device's span,
    and the ``multi_tensor_apply`` kernels launched inside
    ``train.optimizer``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] + profiling.span_events(int(trace["baseTimeNanoseconds"]))
    ops = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and e.get("ph") == "X"), key=lambda e: e["ts"])
    names = {e["name"]: e["name"] for e in events if e.get("cat") == "crfr_span"}
    group = _span_groups(events, ops, names, cat="crfr_span")
    idle: dict[str, float] = {}
    reach = ops[0]["ts"] + ops[0]["dur"]
    for e, g in zip(ops[1:], group[1:]):
        if e["ts"] > reach:
            idle[g or "outside"] = idle.get(g or "outside", 0.0) + (e["ts"] - reach) / 1e3
        reach = max(reach, e["ts"] + e["dur"])
    opt = [g for e, g in zip(ops, group) if "multi_tensor_apply" in e["name"]]
    inside = sum(g == "train.optimizer" for g in opt)
    return {"idle_pct": 100 * sum(idle.values()) / ((reach - ops[0]["ts"]) / 1e3),
            "idle_ms_a_call": {k: v / calls for k, v in sorted(idle.items())},
            "clock": {"kernels": len(opt), "inside_optimizer": inside,
                      "share": inside / len(opt) if opt else None}}


def head_counts_hold(counts: dict | None) -> bool:
    """A ``train.head`` span's counts are whole and agree: the streamed CE's
    ``blocks`` of ``block`` cover its ``classes`` and one block fewer would
    not; a dense or sharded CE is one block of at least its classes."""
    if not counts or set(counts) != {"path", "classes", "blocks", "block"}:
        return False
    n, b, c = counts["blocks"], counts["block"], counts["classes"]
    if counts["path"] == "streaming":
        return n * b >= c > (n - 1) * b
    return counts["path"] in ("dense", "sharded") and n == 1 and b >= c


def _head(calls: int) -> dict:
    """The counts of the log's ``train.head`` spans: the distinct ones, and
    whether all ``calls`` spans carry counts that hold."""
    counts = [r["counts"] for r in profiling.spans() if r["name"] == "train.head"]
    seen = [c for i, c in enumerate(counts) if c not in counts[:i]]
    return {"counts": seen, "spans": len(counts),
            "hold": len(counts) == calls and all(head_counts_hold(c) for c in counts)}


def _median(xs: list) -> float:
    xs = sorted(xs)
    return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2


def _study(kind: str, call, n: int, reps: int, tmp: str) -> dict:
    root = {"train": "train.step", "embed": "embed.call"}[kind]
    for _ in range(3):
        call()
    plain = [_window(call, n)]
    # the benchmark's form: the process's first profiler, spans as they are, a trace
    path = os.path.join(tmp, f"{kind}.json")
    profiling.clear()
    first_ms = _traced(call, n, path)
    first = {"ms": first_ms, "spans": _means(n), **_by_span(path, n)}
    if kind == "train":
        first["head"] = _head(n)
    # one profiler over windows with the spans on and off in turns
    profiling.clear()
    windows = {"on": [], "off": []}
    with profile(activities=[ProfilerActivity.CUDA]):
        for on in (True, False, False, True) * reps:
            with profiling.span_mode("read" if on else "off"):
                windows["on" if on else "off"].append(_window(call, n))
    # every span device-timed: the children against their root
    profiling.clear()
    with profiling.span_mode("all"):
        all_ms = _traced(call, n)
    means = _means(n)
    kids = sum(v["device_ms"] for k, v in means.items() if k != root)
    plain.append(_window(call, n))
    on, off = _median(windows["on"]), _median(windows["off"])
    profiling.clear()
    return {"path": kind, "calls": n, "plain_ms": plain, "first_trace": first,
            "windows": windows, "on_cost_pct": 100 * (on - off) / off,
            "all": {"ms": all_ms, "spans": means,
                    "consistency": {"root_device_ms": means[root]["device_ms"],
                                    "children_device_ms": kids,
                                    "gap_pct": 100 * (means[root]["device_ms"] - kids)
                                    / means[root]["device_ms"]}}}


def main(argv=None) -> int:
    from crfr_torch.bench.throughput import train_config
    from crfr_torch.serve import build_serving_fn
    from crfr_torch.train.loop import Trainer

    ap = argparse.ArgumentParser(prog="python -m crfr_torch.bench.spans_check")
    ap.add_argument("--path", choices=("train", "embed"), required=True)
    ap.add_argument("--calls", type=int, default=None,
                    help="calls a window (train 10, embed 40)")
    ap.add_argument("--reps", type=int, default=3, help="on, off, off, on, this many times")
    ap.add_argument("--classes", type=int, default=10572, help="the train step's classes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spans_check measures the CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    off = span_ns()
    tr = Trainer(train_config("ir_50", args.classes, 112, 512), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    pool = [(torch.randint(0, 256, (512, 112, 112, 3), generator=g, device=dev,
                           dtype=torch.uint8),
             torch.randint(0, args.classes, (512,), generator=g, device=dev),
             torch.randint(8, 113, (512,), generator=g, device=dev, dtype=torch.int32))
            for _ in range(4)]
    k = [0]

    def step():
        x, y, lows = pool[k[0] % 4]
        k[0] += 1
        tr.train_step(x, y, lows=lows)

    fn = build_serving_fn(lambda x: tr.backbone_apply(tr.model.backbone, x), degrade_to=16,
                          resize_mode="pil", image_size=112, device=dev)
    probes = [p[0][:256].clone() for p in pool]

    def embed():
        fn(probes[k[0] % 4])
        k[0] += 1

    with tempfile.TemporaryDirectory() as tmp:
        r = _study(args.path, step if args.path == "train" else embed,
                   args.calls or (10 if args.path == "train" else 40), args.reps, tmp)
    off.update(span_ns(on=True))
    # the spans a call opens: train 5 ``annotate`` and a ``begin`` off; on,
    # 3 device-timed and 4 ``detail`` (the backward's second among them);
    # embed 3 off, 1 and 2 on
    n_off, n_on = ((5, 1), (3, 4)) if args.path == "train" else ((3, 0), (1, 2))
    off_call = n_off[0] * off["annotate"] + n_off[1] * off["begin_end"]
    on_call = n_on[0] * off["annotate_on"] + n_on[1] * off["annotate_on_detail"]
    plain = r["plain_ms"][0] * 1e6
    r.update(card=card, torch=torch.__version__, span_ns=off, off_ns_a_call=off_call,
             off_share_pct=100 * off_call / plain, on_ns_a_call=on_call,
             on_share_pct=100 * on_call / plain)
    line = json.dumps(r)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

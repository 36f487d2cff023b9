"""Reading the profiler's Chrome trace into the few numbers the metrics need.

``summarize`` takes the events of one process's trace and, where the trace
holds the host's events, the name of the harness's span around the traced
calls. A trace of the device alone (the card's runs take one: it adds the
least to the host's work, so the host issues the traced calls at nearly the
pace of the untraced window) holds only the traced calls, and its segment
runs from the first device operation's start to the last one's end. Within the segment it returns:

- ``window_s``: the segment's length;
- ``busy_s``: the length of the union of the device's operation intervals
  (kernels, copies, fills), clipped to the segment; ``compute_busy_s`` the
  same without the collectives' kernels (NCCL's), which spend most of their
  time waiting for the other cards;
- ``kernels``: {name: [seconds, count]} of every kernel;
- ``gaps``: the longest idle gaps on the device, each as [label, seconds],
  the label being the innermost host event that was open on the span's
  thread when the device ran out of work (what the host was doing), or in
  a trace of the device alone the operation that the device waited for.

``kernel_s`` sums the seconds of the kernels whose names contain any of a
metric's patterns.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(host: list[dict], starts: list[float], t: float) -> str:
    """The innermost host event open at ``t``: scanning back from the last
    one that started by then, the first that is still open started last."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        e = host[i]
        if e["ts"] + e.get("dur", 0) > t:
            return e["name"]
        i -= 1
    return "outside any host event"


def summarize(events: list[dict], span: str | None = None, top: int = 10) -> dict:
    dev_all = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    if span is not None:
        spans = [e for e in events if e.get("name") == span and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError(f"the trace has no span {span!r}")
        sp = spans[0]
        t0, t1 = sp["ts"], sp["ts"] + sp["dur"]
    elif dev_all:
        sp = None
        t0 = min(e["ts"] for e in dev_all)
        t1 = max(e["ts"] + e.get("dur", 0) for e in dev_all)
    else:
        raise RuntimeError("the trace holds no device operation")
    dev = [e for e in dev_all if e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    clip = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev]
    busy = _union(clip)
    compute = _union([iv for iv, e in zip(clip, dev) if "nccl" not in e["name"].lower()])
    kernels: dict[str, list] = {}
    for e in dev:
        if e["cat"] == "kernel":
            acc = kernels.setdefault(e["name"], [0.0, 0])
            acc[0] += e["dur"] / 1e6
            acc[1] += 1
    edges = [t0, *[x for iv in busy for x in iv], t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    if sp is not None:
        host = sorted((e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                       and e.get("tid") == sp.get("tid") and e.get("pid") == sp.get("pid")),
                      key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        labels = [_label(host, starts, s) for s, _ in gaps[:top]]
    else:
        first = {s: e["name"] for (s, _), e in zip(clip, dev)}
        labels = [f"before {first.get(e, 'the end')}" for _, e in gaps[:top]]
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "compute_busy_s": sum(e - s for s, e in compute) / 1e6,
        "kernels": kernels,
        "gaps": [[lab, (e - s) / 1e6] for lab, (s, e) in zip(labels, gaps[:top])],
    }


def kernel_s(summary: dict, patterns) -> tuple[float, int]:
    """(seconds, launches) of the kernels whose names hold any of ``patterns``
    (case-insensitive)."""
    pats = [p.lower() for p in patterns]
    secs, count = 0.0, 0
    for name, (s, n) in summary["kernels"].items():
        if any(p in name.lower() for p in pats):
            secs += s
            count += n
    return secs, count


def top_kernels(summaries: list[dict], top: int = 10) -> list[list]:
    """The kernels that took most device time, averaged over the processes."""
    tot: dict[str, float] = {}
    for s in summaries:
        for name, (secs, _) in s["kernels"].items():
            tot[name] = tot.get(name, 0.0) + secs / len(summaries)
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

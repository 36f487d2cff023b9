"""Tracing and timing helpers (crfr/utils/profiling.py) on torch.profiler.

- ``trace(logdir)``: a ``torch.profiler.profile`` over the block, with the
  CPU and, where there is a card, the CUDA activities; on exit it writes a
  Chrome trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
  ``chrome://tracing``) into ``logdir``, with every kernel the block ran;
- ``annotate(name, device, call=, rows=, detail=, counts=)``: the program's
  span, a named range at a layer boundary (below); ``begin``/``end`` the
  same for a span that may end on another thread than the one that opened
  it;
- ``span_mode(mode)``: which spans record what while a profiler runs;
- ``spans()``, ``span_events(base_ns)``, ``clear()``: the span log, read;
- ``union_length(intervals)``: the length of a union of intervals;
- ``timed(fn)``: wall-clock seconds a call over a window of calls, fenced
  with ``torch.cuda.synchronize`` when the result lies on a card, so the
  asynchronous launches are inside the measurement.

**The span.** Off, while no torch profiler runs (or while
``torch.compile`` traces): ``annotate`` returns one shared null context
after a single read of ``torch.autograd.profiler._is_profiler_enabled``; it
reads no clock, opens no range, records no event and allocates nothing.
On, it opens ``record_function(name)`` (so a trace with the CPU activity
shows the range as a ``user_annotation`` event) and appends a record to a
bounded log (``LOG_BOUND`` records; the oldest go first): its name, its
parent (the enclosing span on the opening thread, or the one given to
``begin``), a call id (the root's ``call``, or a count; children inherit
it), the rows the call handled (``rows``, inherited likewise), the opening
thread, its start and end on ``time.time_ns()``, and the ``counts`` it was
given (a dict of what the span's work is made of, such as the head's path,
classes and class blocks; never read by the span itself). A span given a CUDA
``device`` also records a pair of ``torch.cuda.Event(enable_timing=True)``
on that device's current stream at its edges, taken from a pool, with no
synchronize; on the CPU it records none. A ``detail`` span records its
events only in the ``"all"`` mode: each event record costs the host ~12 µs
under a device-only profiler, so by default (``"read"``) only the spans a
per-layer metric reads the device time of record them. ``"off"`` sends
every span down the off path even while a profiler runs.

**The clock.** ``time.time_ns()`` is the unix clock onto which the
profiler maps its timestamps: an exported trace's event at ``ts`` (µs)
happened at ``ts·1000 + baseTimeNanoseconds`` ns, so ``span_events`` puts
the log on a trace's clock as ``"X"`` events of category ``crfr_span``.

**Reading.** ``spans()`` resolves each event pair once (``elapsed_time``
against an origin event recorded with the log's first device-timed span,
after one fence of the device) and returns each finished record as a dict:
``host_ms`` and ``self_ms`` (the span less the union of its children), and
``device_start_ms``/``device_end_ms`` from the origin, ``device_ms`` and
``device_self_ms`` (None without events), and ``counts`` (None without).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Callable

import torch
import torch.autograd.profiler as _gate
from torch.profiler import ProfilerActivity, profile, record_function

LOG_BOUND = 1 << 16
MODES = ("off", "read", "all")
_NULL = contextlib.nullcontext()
_mode = "read"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler, whose ``trace_path`` names
    the Chrome trace once the block has left."""
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


class _Record:
    __slots__ = ("id", "name", "parent", "call", "rows", "thread", "start_ns", "end_ns",
                 "device", "events", "device_ms", "range", "counts")


class SpanLog:
    """The records of the spans opened while a profiler ran, at most
    ``bound`` of them."""

    def __init__(self, bound: int = LOG_BOUND):
        self.bound = bound
        self._records: collections.deque = collections.deque()
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pool: dict[int, list] = {}         # device index → free events
        self._origin: dict[int, torch.cuda.Event] = {}

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _event(self, index: int):
        pool = self._pool.setdefault(index, [])
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def _release(self, rec: _Record) -> None:
        if rec.events:
            self._pool[rec.device].extend(rec.events)
        rec.events = None

    def open(self, name: str, device, call, rows, parent: _Record | None) -> _Record:
        rec = _Record()
        rec.id, rec.name, rec.parent = next(self._ids), name, parent
        rec.thread = threading.get_ident()
        rec.call = call if call is not None else (parent.call if parent else None)
        rec.rows = rows if rows is not None else (parent.rows if parent else None)
        rec.end_ns, rec.device, rec.events, rec.device_ms = None, None, None, None
        rec.counts = None
        with self._lock:
            if rec.call is None:
                rec.call = next(self._calls)
            dev = None if device is None else torch.device(device)
            if dev is not None and dev.type == "cuda":
                rec.device = torch.cuda.current_device() if dev.index is None else dev.index
                stream = torch.cuda.current_stream(rec.device)
                if rec.device not in self._origin:
                    self._origin[rec.device] = torch.cuda.Event(enable_timing=True)
                    self._origin[rec.device].record(stream)
                rec.events = [self._event(rec.device), self._event(rec.device)]
                rec.events[0].record(stream)
            if len(self._records) >= self.bound:
                self._release(self._records.popleft())
            self._records.append(rec)
        rec.range = record_function(name)
        rec.range.__enter__()
        rec.start_ns = time.time_ns()
        return rec

    def close(self, rec: _Record) -> None:
        rec.end_ns = time.time_ns()
        rec.range.__exit__(None, None, None)
        with self._lock:
            if rec.events:
                rec.events[1].record(torch.cuda.current_stream(rec.device))

    def clear(self) -> None:
        with self._lock:
            for rec in self._records:
                self._release(rec)
            self._records.clear()
            self._origin.clear()

    def _resolve(self, done: list) -> None:
        """Each event pair → (start, end) ms from its device's origin, once."""
        pending = [r for r in done if r.events]
        for index in {r.device for r in pending}:
            torch.cuda.synchronize(index)
        for r in pending:
            origin = self._origin[r.device]
            r.device_ms = (origin.elapsed_time(r.events[0]), origin.elapsed_time(r.events[1]))
            self._release(r)

    def spans(self) -> list[dict]:
        with self._lock:
            done = [r for r in self._records if r.end_ns is not None]
            self._resolve(done)
        kids: dict[int, list] = {}
        for r in done:
            if r.parent is not None:
                kids.setdefault(r.parent.id, []).append(r)
        out = []
        for r in done:
            ch = kids.get(r.id, [])
            host_ns = r.end_ns - r.start_ns
            d = {"id": r.id, "name": r.name, "parent": r.parent.id if r.parent else None,
                 "call": r.call, "rows": r.rows, "thread": r.thread,
                 "start_ns": r.start_ns, "end_ns": r.end_ns, "host_ms": host_ns / 1e6,
                 "self_ms": (host_ns - union_length([(c.start_ns, c.end_ns) for c in ch])) / 1e6,
                 "device_start_ms": None, "device_end_ms": None, "device_ms": None,
                 "device_self_ms": None, "counts": r.counts}
            if r.device_ms is not None:
                s, e = r.device_ms
                d.update(device_start_ms=s, device_end_ms=e, device_ms=e - s,
                         device_self_ms=e - s - union_length(
                             [c.device_ms for c in ch if c.device_ms]))
            out.append(d)
        return out


def union_length(intervals) -> float:
    """The length of the union of [start, end) intervals (a child span lies
    inside its parent, on the host's clock and on its stream alike)."""
    total, reach = 0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


LOG = SpanLog()


class _Span:
    __slots__ = ("args", "counts", "rec")

    def __init__(self, *args, counts=None):
        self.args, self.counts = args, counts

    def __enter__(self):
        st = LOG._stack()
        self.rec = LOG.open(*self.args, st[-1] if st else None)
        self.rec.counts = self.counts
        st.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        LOG._stack().pop()
        LOG.close(self.rec)
        return False


def annotate(name: str, device=None, call=None, rows=None, detail: bool = False,
             counts: dict | None = None):
    """The span ``name`` over a ``with`` block: the shared null context while
    no profiler runs (or in the ``"off"`` mode); else a range in the trace
    and a record in the log, device-timed on a CUDA ``device`` (a ``detail``
    span only in the ``"all"`` mode). ``call`` and ``rows`` name the call a
    root span belongs to and the rows it handled; ``counts`` goes on the
    record as it is (pass one made ahead: the off path builds nothing)."""
    if not _gate._is_profiler_enabled or torch.compiler.is_compiling() or _mode == "off":
        return _NULL
    return _Span(name, None if detail and _mode != "all" else device, call, rows,
                 counts=counts)


def begin(name: str, device=None, parent=None, detail: bool = False):
    """Open the span ``name`` outside any thread's nesting (``end`` may close
    it on another thread); its parent is ``parent`` (a record ``begin``
    returned, or its ``.parent``) or else the calling thread's innermost
    span; ``device`` and ``detail`` as for ``annotate``. → the record, or
    None while no profiler runs."""
    if not _gate._is_profiler_enabled or torch.compiler.is_compiling() or _mode == "off":
        return None
    if parent is None:
        st = LOG._stack()
        parent = st[-1] if st else None
    return LOG.open(name, None if detail and _mode != "all" else device, None, None, parent)


def end(rec) -> None:
    """Close a span ``begin`` opened (None: nothing)."""
    if rec is not None and rec.end_ns is None:
        LOG.close(rec)


@contextlib.contextmanager
def span_mode(mode: str):
    """Within the block, spans opened while a profiler runs do as ``mode``
    says: ``"off"`` nothing, ``"read"`` (the default) events on the spans
    that are not ``detail``, ``"all"`` events on every span."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"span mode {mode!r}, not one of {MODES}")
    saved, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = saved


def spans() -> list[dict]:
    """The log's finished spans, oldest first (the module docstring)."""
    return LOG.spans()


def span_events(base_ns: int) -> list[dict]:
    """The log as Chrome ``"X"`` events (category ``crfr_span``) on the
    clock of a trace whose ``baseTimeNanoseconds`` is ``base_ns``."""
    pid = os.getpid()
    return [{"name": r["name"], "cat": "crfr_span", "ph": "X", "pid": pid, "tid": r["thread"],
             "ts": (r["start_ns"] - base_ns) / 1e3, "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
             "args": {k: r[k] for k in ("id", "parent", "call", "rows", "device_ms", "counts")}}
            for r in spans()]


def clear() -> None:
    """Empty the log."""
    LOG.clear()


def _cuda_devices(out) -> set[torch.device]:
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(o) for o in out)) if out else set()
    return set()


def _fence(out) -> None:
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2):
    """→ (seconds_per_iter, last_result); fenced on the card of a CUDA
    result (tensors, or tensors in a tuple, list or dict); a CPU result
    is done when ``fn`` returns."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fence(out)
    return (time.perf_counter() - t0) / iters, out

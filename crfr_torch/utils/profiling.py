"""Tracing and timing helpers (crfr/utils/profiling.py) on torch.profiler.

- ``trace(logdir)``: a ``torch.profiler.profile`` over the block, with the
  CPU and, where there is a card, the CUDA activities; on exit it writes a
  Chrome trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
  ``chrome://tracing``) into ``logdir``, with every kernel the block ran;
- ``annotate(name)``: a named range inside a trace
  (``torch.profiler.record_function``);
- ``timed(fn)``: wall-clock seconds a call over a window of calls, fenced
  with ``torch.cuda.synchronize`` when the result lies on a card, so the
  asynchronous launches are inside the measurement.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


def annotate(name: str):
    return record_function(name)


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

"""Host → device feeding for train loops (crfr/train/feed.py).

``device_feed`` copies batch i+1 to the device while the step of batch i
runs: a worker thread puts each batch in pinned host memory and starts a
``non_blocking`` copy on a side stream, and the batch goes to the consumer
with an event that the consumer's stream waits on (and with the tensors
recorded on that stream, so the allocator does not reuse them early).
``depth`` batches are in flight. On the CPU a batch passes through as
tensors. Tensors already on the device pass through unchanged.

With a ``mesh`` of more than one device (``parallel.mesh``), a batch is
this rank's rows: ``local=False`` (the default) takes a global batch, of
which only this rank's rows are copied to the device; ``local=True`` takes
this rank's slab of the global batch as it is. The step then gets its rows
either way (``Trainer.train_step(..., local=True)``).

``ResumableDeviceFeed`` does the same over a ``ResumableBatches`` source
and keeps ``state`` at the pipeline state after the batch the CONSUMER
received last, not after the batches drawn ahead, so checkpointing
``feed.state`` resumes without skipping the batches in flight.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from crfr_torch.parallel.mesh import local_rows


class _Putter:
    def __init__(self, device: torch.device, mesh=None, local: bool = False):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.mesh = None if local else mesh

    def _one(self, a) -> torch.Tensor | None:
        if a is None:
            return None
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if self.stream is None or t.device == self.device:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def put(self, batch) -> tuple:
        images, labels = (local_rows(self.mesh, a) for a in batch)
        if labels is not None and not isinstance(labels, torch.Tensor):
            labels = np.asarray(labels, np.int32)
        if self.stream is None:
            return self._one(images), self._one(labels), None
        with torch.cuda.stream(self.stream):
            out = (self._one(images), self._one(labels))
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return (*out, ready)

    def take(self, put: tuple) -> tuple:
        images, labels, ready = put
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in (images, labels):
                if t is not None:
                    t.record_stream(stream)
        return images, labels


def device_feed(batches: Iterable, device, depth: int = 2, mesh=None,
                local: bool = False) -> Iterator:
    """(images, labels) host batches → the same as device tensors, with up
    to ``depth`` copies running ahead of the consumer. ``labels`` may be
    None. On a ``mesh``: this rank's rows of a global batch, or with
    ``local`` its own slab as it is."""
    putter = _Putter(device, mesh, local)
    it = iter(batches)
    with ThreadPoolExecutor(1) as ex:
        q: deque = deque()
        for _ in range(max(depth, 1)):
            try:
                q.append(ex.submit(putter.put, next(it)))
            except StopIteration:
                break
        while q:
            out = q.popleft().result()
            try:
                q.append(ex.submit(putter.put, next(it)))
            except StopIteration:
                pass
            yield putter.take(out)


class ResumableDeviceFeed:
    """``device_feed`` over a ``ResumableBatches`` whose ``state`` is the
    pipeline state after the batch the consumer received last."""

    def __init__(self, batches, device, depth: int = 2, mesh=None, local: bool = False):
        self._batches = batches
        self._it = iter(batches)
        self._ex = ThreadPoolExecutor(1)
        self._q: deque = deque()
        self._putter = _Putter(device, mesh, local)
        self.state = batches.get_state()
        for _ in range(max(depth, 1)):
            self._prefetch()

    def _prefetch(self) -> None:
        try:
            b = next(self._it)
        except StopIteration:
            return
        st = self._batches.get_state()        # the state AFTER drawing b
        self._q.append((self._ex.submit(self._putter.put, b), st))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._q:
            self._ex.shutdown(wait=False)
            raise StopIteration
        fut, st = self._q.popleft()
        self._prefetch()
        out = self._putter.take(fut.result())
        self.state = st                       # the resume point: after THIS batch
        return out

    def close(self) -> None:
        """Stop the copy thread, then the source's own readers."""
        self._ex.shutdown(wait=True)
        close = getattr(self._batches, "close", None)
        if close is not None:
            close()

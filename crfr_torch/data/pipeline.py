"""Host input pipelines (crfr/data/pipeline.py, without grain): the train
stream and ``embed_batches``, the eval side's image loader.

The host reads records, flips and batches; degradation and normalisation
run on the device inside the train step. The stream is the records of
epoch 0 in its order, then epoch 1's, and so on, cut into batches of
``batch_size`` consecutive records (a batch may span two epochs; with
``drop_remainder`` a finite stream drops its last partial batch):

- epoch e's order is a permutation drawn from ``(seed, e)`` (the records
  in order without ``shuffle``);
- the flip of the record at position p of epoch e is drawn from
  ``(seed + 1, e)``, a draw per position, so it depends on the record's
  global index alone;
- the state is ``{"epoch", "position"}`` of the next record, so resuming is
  O(1): a restored pipeline continues the same stream.

The order cannot equal grain's, which ``crfr`` uses: the same seed gives
another permutation. ``num_workers`` > 0 reads a batch's records on that
many threads.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


@dataclass
class PipelineCfg:
    batch_size: int = 512
    shuffle: bool = True
    seed: int = 0
    num_epochs: int | None = None       # None → loop forever
    random_flip: bool = True
    num_workers: int = 0                # reader threads
    drop_remainder: bool = True


class ResumableBatches:
    """Iterator of (images u8 (B, S, S, C), labels i32 (B,)) with an exact
    checkpointable position (``get_state``/``set_state``)."""

    def __init__(self, source, cfg: PipelineCfg):
        if len(source) == 0:
            raise ValueError("an empty source")
        self._source = source
        self._cfg = cfg
        self._n = len(source)
        self._epoch_no = 0
        self._position = 0
        self._epochs: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._pool = ThreadPoolExecutor(cfg.num_workers) if cfg.num_workers > 0 else None

    def _epoch(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """(order, flips) of ``epoch``; the two latest epochs are kept, as a
        batch reads at most two."""
        if epoch not in self._epochs:
            order = (np.random.default_rng([self._cfg.seed, epoch]).permutation(self._n)
                     if self._cfg.shuffle else np.arange(self._n))
            flips = np.random.default_rng([self._cfg.seed + 1, epoch]).random(self._n) < 0.5
            self._epochs = {e: v for e, v in self._epochs.items() if e == epoch - 1}
            self._epochs[epoch] = (order, flips)
        return self._epochs[epoch]

    def _remaining(self) -> int | None:
        if self._cfg.num_epochs is None:
            return None
        return (self._cfg.num_epochs - self._epoch_no) * self._n - self._position

    def _read(self, item: tuple[int, bool]) -> tuple[int, np.ndarray]:
        index, flip = item
        label, img = self._source[index]
        if flip:
            img = img[:, ::-1]
        return label, np.ascontiguousarray(img)

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        b = self._cfg.batch_size
        left = self._remaining()
        if left is not None and (left <= 0 or (left < b and self._cfg.drop_remainder)):
            raise StopIteration
        take = b if left is None else min(b, left)
        items = []
        for _ in range(take):
            order, flips = self._epoch(self._epoch_no)
            flip = bool(self._cfg.random_flip and flips[self._position])
            items.append((int(order[self._position]), flip))
            self._position += 1
            if self._position == self._n:
                self._epoch_no, self._position = self._epoch_no + 1, 0
        recs = list(self._pool.map(self._read, items) if self._pool else map(self._read, items))
        images = np.stack([img for _, img in recs]).astype(np.uint8, copy=False)
        return images, np.asarray([label for label, _ in recs], np.int32)

    def get_state(self) -> dict:
        return {"epoch": self._epoch_no, "position": self._position}

    def set_state(self, state: dict) -> None:
        epoch, position = int(state["epoch"]), int(state["position"])
        if epoch < 0 or not 0 <= position < self._n:
            raise ValueError(f"state {state} outside a source of {self._n} records")
        self._epoch_no, self._position = epoch, position

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def skip(self, n_batches: int) -> None:
        """Advance by ``n_batches`` batches without reading them."""
        total = self._epoch_no * self._n + self._position + n_batches * self._cfg.batch_size
        self._epoch_no, self._position = divmod(total, self._n)


def train_batches(source, cfg: PipelineCfg, start_step: int = 0,
                  state: dict | None = None) -> ResumableBatches:
    """The train iterator, resumed from ``state`` (``get_state`` at
    checkpoint time) or else advanced past ``start_step`` batches."""
    it = ResumableBatches(source, cfg)
    if state is not None:
        it.set_state(state)
    else:
        it.skip(start_step)
    return it


def embed_batches(paths: Sequence[str], batch_size: int, size: int = 112,
                  pad_to_full: bool = True, num_threads: int = 16,
                  prefetch: int = 2) -> Iterator[tuple[np.ndarray, int]]:
    """Images from ``paths`` in batches of ``batch_size`` (the last one
    zero-padded to full size unless ``pad_to_full`` is off), each yielded
    as (uint8 (B, size, size, 3), n_valid). Decoding runs on
    ``num_threads`` threads and ``prefetch`` whole batches are assembled
    ahead of the consumer, so host decode overlaps the device's work."""
    from crfr_torch.data.datasets import load_image

    n = len(paths)
    if n == 0:
        return

    def make_batch(pool, start):
        chunk = paths[start:start + batch_size]
        imgs = np.stack(list(pool.map(lambda p: load_image(p, size), chunk)))
        n_valid = len(chunk)
        if pad_to_full and n_valid < batch_size:
            pad = np.zeros((batch_size - n_valid, size, size, 3), np.uint8)
            imgs = np.concatenate([imgs, pad])
        return imgs, n_valid

    starts = iter(range(0, n, batch_size))
    with ThreadPoolExecutor(num_threads) as pool, \
            ThreadPoolExecutor(max(prefetch, 1)) as batcher:
        pending: deque = deque()
        for _ in range(max(prefetch, 1)):
            s = next(starts, None)
            if s is not None:
                pending.append(batcher.submit(make_batch, pool, s))
        while pending:
            out = pending.popleft().result()
            s = next(starts, None)
            if s is not None:
                pending.append(batcher.submit(make_batch, pool, s))
            yield out

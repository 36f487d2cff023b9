"""Structured JSONL metrics writer (crfr/utils/logging.py).

An append-only JSONL stream, one object per event: step, wall time since
the writer opened, and whatever scalars the caller passes. TensorBoard is
optional on top (``torch.utils.tensorboard``, when the ``tensorboard``
package is installed); the JSONL file is the source of truth.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any


class MetricsWriter:
    def __init__(self, path: str | None = None, stdout: bool = True,
                 tensorboard_dir: str | None = None):
        self._fh: IO[str] | None = None
        self.stdout = stdout
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir:
            try:                          # optional; JSONL is canonical
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                pass
        self._t0 = time.time()

    def write(self, step: int, **scalars: Any) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
        if self.stdout:
            print(line, flush=True)
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "t") and isinstance(v, float):
                    self._tb.add_scalar(k, v, global_step=int(step))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Checkpoints with bitwise resume (crfr/train/checkpoints.py, without Orbax).

One file per step, ``step_<n>.pt`` under the directory, written with
``torch.save`` to a temporary name and renamed, so a file is either whole
or absent. A file holds the trainer's ``state`` (parameters, BN statistics,
the optimizer's momentum, the step, the seed the per-step generators derive
from) and the config JSON, so a checkpoint describes itself. The N latest
are kept. Reads go through ``torch.load(weights_only=True)``.

Writes are synchronous: ``wait`` and ``close`` are there for callers
written against ``crfr``'s asynchronous checkpointer. In a multi-process
run every rank calls ``save`` with the same whole state (a trainer's
``state`` gathers its class-sharded W), rank 0 alone writes, and every
rank leaves ``save`` through a barrier, so a checkpoint is on disk before
any rank reads the directory again.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, config_json: str | None = None,
             force: bool = False) -> bool:
        """Write ``state`` at ``step``; False (and nothing written) when that
        step exists and not ``force``."""
        import torch.distributed as dist

        group = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
        if group:                       # every rank tests the file before rank 0 writes it
            dist.barrier()
        path = self._path(step)
        if os.path.exists(path) and not force:
            return False
        if not group or dist.get_rank() == 0:
            tmp = f"{path}.tmp.{os.getpid()}"
            torch.save({"state": state, "config": config_json}, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.keep] if self.keep > 0 else []:
                os.remove(self._path(old))
        if group:
            dist.barrier()
        return True

    def _load(self, step: int | None) -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, target_state: Any = None, step: int | None = None) -> dict:
        """The state saved at ``step`` (the latest when None), on the CPU;
        assign it to ``Trainer.state`` to load it. With ``target_state``,
        the two must hold the same keys."""
        state = self._load(step)["state"]
        if target_state is not None and set(state) != set(target_state):
            raise KeyError(f"checkpoint keys {sorted(state)} != target {sorted(target_state)}")
        return state

    def state_keys(self, step: int | None = None) -> list[str] | None:
        """Top-level keys of the stored state (None when there is none)."""
        try:
            return list(self._load(step)["state"])
        except FileNotFoundError:
            return None

    def restore_config(self, step: int | None = None) -> dict | None:
        try:
            cfg = self._load(step)["config"]
        except FileNotFoundError:
            return None
        return json.loads(cfg) if cfg is not None else None

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass

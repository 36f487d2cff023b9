"""Start the process group of a multi-process run (crfr/parallel/multihost.py).

``crfr`` runs one process per host and lets ``jax.distributed`` span the
hosts. The port runs one process per device on ``torch.distributed``: NCCL
between cards, gloo on the CPU. One call at program start; afterwards the
mesh code (``parallel.mesh``) reads the group's rank and size.

Recognised environment, in this order:
  CRFR_COORDINATOR    ``host:port`` of rank 0, or an init URL
                      (``tcp://...``, ``file:///...``)
  CRFR_NUM_PROCESSES  the number of processes
  CRFR_PROCESS_ID     this process's rank
or torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
``LOCAL_RANK`` (default: the rank) picks this process's card among the
host's visible cards, modulo their count, so several ranks may share a
card. ``CRFR_DIST_BACKEND`` overrides the backend: NCCL refuses two ranks on
one card, so such a run (``chip_smoke.py``'s two-rank phase) takes gloo,
which stages CUDA tensors through the host for its collectives.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _env_launch() -> tuple[str, int, int] | None:
    """(init URL, world size, rank) from the environment, or None."""
    coord = os.environ.get("CRFR_COORDINATOR")
    nproc = os.environ.get("CRFR_NUM_PROCESSES")
    pid = os.environ.get("CRFR_PROCESS_ID")
    if coord is not None and nproc is not None and pid is not None:
        return (coord if "://" in coord else f"tcp://{coord}"), int(nproc), int(pid)
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    world, rank = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    if None in (addr, port, world, rank):
        return None
    return f"tcp://{addr}:{port}", int(world), int(rank)


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Start the default process group from the environment if a
    multi-process launch is described there; True when a group is active.

    The backend is NCCL when ``device`` is CUDA and gloo when it is the CPU
    (``CRFR_DIST_BACKEND`` wins over both); on CUDA this process's card is
    set first. A second call, or a call after the caller started the group
    itself, is a no-op; with no such environment nothing is touched and the
    result is False."""
    if dist.is_available() and dist.is_initialized():
        return True
    launch = _env_launch()
    if launch is None:
        return False
    url, world, rank = launch
    dev = torch.device(device)
    backend = os.environ.get("CRFR_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_shard(n: int) -> tuple[int, int]:
    """(start, stop) of this process's contiguous shard of n dataset
    indices: n // P each, the first n % P processes one more."""
    p, np_ = process_index(), process_count()
    per, extra = divmod(n, np_)
    start = p * per + min(p, extra)
    return start, start + per + (1 if p < extra else 0)

"""The (data, model) mesh over the ranks of a process group (crfr/parallel/mesh.py).

``crfr`` runs one process per host and one ``jax.sharding.Mesh`` with axes
``('data', 'model')`` over every host's devices; GSPMD inserts the
collectives. The port runs one process per device, so its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of shape (data, model) with
``mesh_dim_names=("data", "model")`` over the ranks of the default process
group, and the collectives are written out where ``crfr``'s compiler would
insert them:

- The rank with mesh coordinates (d, m) takes the place of ``crfr``'s
  device ``devices[d, m]``; its rank is d·model + m.
- ``batch_sharding``: axis 0 over the whole mesh in rank order, ``crfr``'s
  ``P(('data', 'model'))``: rank r holds rows [r·B/P, (r+1)·B/P).
- ``class_sharding``: the head's W (D, C) by columns over ``model``.
- Everything else is replicated.

A sharding here describes which slice of a global value a rank holds;
``host_put`` keeps that slice of a global value (every rank passes the
same one, and copies only its own rows to its card), ``host_put_local``
keeps a rank's own slab as it is.

The collectives that carry a gradient are ``all_reduce_sum`` (torch's
differentiable all-reduce) and ``all_gather_rows``. The latter is written
here: ``torch.distributed.nn.functional.all_gather``'s backward on gloo
scatters with global ranks and fails on a subgroup, so its backward is an
all-reduce of the whole gradient, of which each rank keeps its rows.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from crfr_torch.configs import MeshCfg  # noqa: F401  (re-exported, as crfr does)
from crfr_torch.parallel.multihost import process_count as world_size


def make_mesh(cfg: MeshCfg | None = None, device_type: str | None = None):
    """The (data, model) ``DeviceMesh`` over the default group's ranks.

    With no cfg: (world, 1), the pure data-parallel default. Raises when
    data·model exceeds the world (as ``crfr``), and when it is smaller than
    a world of more than one (a rank outside the mesh would have nothing to
    run). Without a process group the world is one process and the result
    is None: the single-device path. ``device_type`` defaults to "cuda" on
    NCCL and "cpu" on gloo."""
    world = world_size()
    if cfg is None:
        cfg = MeshCfg(data=world, model=1)
    want = cfg.data * cfg.model
    if want > world:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs {want} devices, have {world}")
    if want < world:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} covers {want} of the {world} ranks; "
                         f"set mesh.data * mesh.model = {world}")
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (cfg.data, cfg.model),
                            mesh_dim_names=(cfg.axis_data, cfg.axis_model))


def mesh_size(mesh) -> int:
    """The number of devices of ``mesh`` (1 for None); a ``DeviceMesh`` or
    any object with ``size()`` or a ``devices`` array. Raises TypeError when
    it cannot be read."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    n = size() if callable(size) else getattr(getattr(mesh, "devices", None), "size", None)
    if n is None:
        raise TypeError(f"cannot read the size of mesh {mesh!r}")
    return int(n)


def coords(mesh) -> tuple[int, int]:
    """This rank's (d, m)."""
    d, m = mesh.get_coordinate()
    return int(d), int(m)


# ---------------------------------------------------------------------------
# Shardings: which slice of a global value a rank holds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sharding:
    """Axis ``dim`` cut into ``parts`` equal pieces, of which this rank holds
    piece ``index``; parts == 1 is replicated."""

    parts: int = 1
    index: int = 0
    dim: int = 0

    def bounds(self, n: int) -> tuple[int, int]:
        if n % self.parts:
            raise ValueError(f"axis of {n} does not divide into {self.parts} shards")
        per = n // self.parts
        return self.index * per, (self.index + 1) * per

    def local(self, x):
        """This rank's piece of the global ``x`` (a view where it can be)."""
        if self.parts == 1:
            return x
        lo, hi = self.bounds(int(x.shape[self.dim]))
        idx = (slice(None),) * self.dim + (slice(lo, hi),)
        return x[idx]


def replicated(mesh) -> Sharding:
    return Sharding()


def batch_sharding(mesh, ndim: int = 4) -> Sharding:
    """Axis 0 over the whole mesh, in rank order."""
    if mesh_size(mesh) == 1:
        return Sharding()
    return Sharding(mesh_size(mesh), dist.get_rank(), 0)


def class_sharding(mesh) -> Sharding:
    """W (D, C): the class axis over ``model``."""
    if mesh_size(mesh) == 1:
        return Sharding(dim=1)
    return Sharding(mesh.shape[1], coords(mesh)[1], 1)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def host_put(x, sharding: Sharding, device: str | torch.device = "cuda") -> torch.Tensor:
    """A global value (every rank passes the same one) → this rank's slice of
    it on ``device``; only that slice is copied."""
    return _as_tensor(sharding.local(x)).to(device).contiguous()


def host_put_local(x, sharding: Sharding, device: str | torch.device = "cuda") -> torch.Tensor:
    """This rank's own slab (the data-parallel input convention: the global
    value is the concatenation of every rank's) → on ``device`` as it is."""
    return _as_tensor(x).to(device).contiguous()


def host_put_tree(tree, sharding: Sharding, device: str | torch.device = "cuda"):
    """``host_put`` over the values of a dict (or list or tuple)."""
    if isinstance(tree, dict):
        return {k: host_put_tree(v, sharding, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_put_tree(v, sharding, device) for v in tree)
    return host_put(tree, sharding, device)


def local_rows(mesh, x):
    """This rank's rows of a global batch ``x`` (an array, a tensor or a
    list); the whole of it off a mesh."""
    if mesh_size(mesh) == 1 or x is None:
        return x
    return batch_sharding(mesh).local(x if hasattr(x, "shape") else np.asarray(x))


def maybe_shard_batch(mesh, images):
    """(this rank's rows, True) when the batch (an array, a tensor or a
    list) divides the mesh's size, else (the whole batch, False): ``crfr``
    then replicates the forward on every device."""
    if not hasattr(images, "shape"):
        images = np.asarray(images)
    n = mesh_size(mesh)
    if n > 1 and int(images.shape[0]) % n == 0:
        return batch_sharding(mesh).local(images), True
    return images, False


def shard_batch(batch, mesh, device: str | torch.device = "cuda"):
    """Each array of a host batch (a tuple, list or dict) → this rank's rows
    on ``device``."""
    return host_put_tree(batch, batch_sharding(mesh), device)


def local_snapshot(module: nn.Module) -> nn.Module:
    """A rank-local copy of a replicated module in eval mode, for programs
    that run on one rank with no collective (the redundant in-training eval
    on every rank). A class-sharded head is copied as this rank's shard;
    callers run only programs that do not read it (backbone forwards)."""
    return copy.deepcopy(module).eval().requires_grad_(False)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def group_size(group) -> int:
    """The size of ``group`` (None: the default group); 1 with no group."""
    return world_size() if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, differentiable (the backward sums the gradients
    over the group); ``x`` itself is left as it is."""
    if group_size(group) == 1:
        return x
    return dist_fn.all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def sum_over_ranks(values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Each scalar summed over the default group, in one all-reduce: each
    rank's share of a global mean → the mean, the same on every rank. The
    values themselves with one process."""
    if world_size() == 1:
        return values
    tot = torch.stack([v.detach().float() for v in values.values()])
    dist.all_reduce(tot)
    return dict(zip(values, tot.unbind()))


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over ``group``, without a gradient."""
    out = x.detach().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.rows, ctx.rank = group, x.shape[0], dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0 in group
    rank order, differentiable: each rank's gradient is the sum over the
    group of the gradients of its rows."""
    if group_size(group) == 1:
        return x
    if x.requires_grad:
        return _GatherRows.apply(x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)

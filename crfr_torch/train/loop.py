"""The training step and loop on one CUDA device (crfr/train/loop.py).

One step:

  batch (uint8 or f32 NHWC, host or device)
    → degradation to each image's own random resolution, (x − 127.5)/128
      and the cast, in ONE launch of the preprocessing kernel
      (``ops.fused_preprocess.fused_degrade_normalize`` with a (B,) tensor
      of lows; an int low when degrade_min == degrade_max)
    → IR backbone forward, float32 master weights, bf16 compute under
      autocast when ``model.compute_dtype == "bfloat16"``; BN running
      statistics as flax keeps them (``models.irse``)
    → margin-softmax CE in true float32, outside autocast: dense (one
      (B, D)×(D, C) product) or streaming over class blocks
    [+ λ·‖emb − t‖² against a frozen teacher's embedding t of the HR batch,
      normalised, once ``set_teacher`` is called and loss.distill_weight > 0]
    → global-norm clip (optional) → weight decay on conv and linear
      weights and the head's W → SGD with momentum, as optax's chain.

The learning rate at step k is the schedule at k (optax evaluates it at the
count before the update), so with warmup the first step has lr 0 and still
fills the momentum.

Random draws (the lows, dropout) come from a ``torch.Generator`` on the
device seeded from (seed, step), so a restored trainer's next step draws
what the uninterrupted one would have. They are not JAX's threefry draws;
``train_step(lows=...)`` takes the lows from the caller instead, which is
how the tests carry ``crfr``'s draws across.

Nothing on the step's path reads a value back to the host: ``host_step``
mirrors the step count, and the metrics stay device tensors until a caller
asks for them.

More than one device (``cfg.mesh`` data·model > 1, or a ``mesh``): one
process per device on a ``torch.distributed`` group (``parallel.mesh``).
The batch is sharded over the whole mesh in rank order; parameters are
replicated (broadcast from rank 0 once), except the head's W and its
momentum, which are class-sharded over ``model`` and padded to a multiple
of it (the padding classes masked out of every CE by ``num_valid``, as in
``crfr``). ``ce_impl='sharded'`` (``auto`` with model > 1) is the
class-sharded CE. BN statistics and dropout are those of the global batch
(``models.irse.set_global_batch``), and the lows are drawn for the global
batch from (seed, step), each rank taking its rows, so N ranks give one
rank's step on the same global batch. Each rank backpropagates its share of
the global mean loss; the gradients of replicated parameters are then summed
over the world and W's over the data group, in one all-reduce each, before
the same SGD chain. ``state`` gathers W and its momentum whole (a
collective: every rank reads it), so a checkpoint restores on any mesh.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from crfr_torch.configs import Config
from crfr_torch.device import mesh_world, resolve_device
from crfr_torch.losses.arcface import MarginHead, sharded_margin_ce, streaming_margin_ce
from crfr_torch.losses.distill import residual_kd_loss
from crfr_torch.models.irse import build_backbone, set_global_batch
from crfr_torch.parallel import mesh as pmesh
from crfr_torch.ops.fused_preprocess import fused_degrade_normalize
from crfr_torch.ops.normalize import normalize
from crfr_torch.utils.logging import MetricsWriter
from crfr_torch.utils.profiling import annotate, begin, end


def lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warmup, then step drops (boundaries shifted by the warmup, as
    optax's ``join_schedules`` passes step − warmup on) or cosine decay."""
    t = cfg.train
    if getattr(t, "schedule", "step") == "cosine":
        total = max(t.epochs * steps_per_epoch - t.warmup_steps, 1)

        def main(count: int) -> float:
            frac = min(count, total) / total
            return t.lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    else:
        boundaries = {max(e * steps_per_epoch - t.warmup_steps, 1): t.lr_drop_factor
                      for e in t.lr_drop_epochs}

        def main(count: int) -> float:
            v = t.lr
            for threshold, scale in sorted(boundaries.items()):
                if count >= threshold:
                    v *= scale
            return v

    if t.warmup_steps <= 0:
        return main

    def joined(count: int) -> float:
        if count < t.warmup_steps:
            return t.lr * min(max(count, 0), t.warmup_steps) / t.warmup_steps
        return main(count - t.warmup_steps)

    return joined


def _wd_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name → True where weight decay applies: conv and linear
    weights and the head's W. Decided by module type: BN scale and PReLU
    alpha are also named ``weight`` in torch, and take no decay."""
    decay = set()
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, MarginHead)):
            decay.add(id(m.weight))
    return {name: id(p) in decay for name, p in model.named_parameters()}


class SGDTx:
    """optax's chain clip_by_global_norm → add_decayed_weights (masked) →
    sgd(schedule, momentum): ``torch.optim.SGD`` with a decayed and an
    undecayed parameter group (SGD adds the decay before the momentum, as
    optax does) behind the clip on the raw gradients."""

    def __init__(self, cfg: Config, model: nn.Module, schedule: Callable[[int], float]):
        mask = _wd_mask(model)
        named = list(model.named_parameters())
        groups = [{"params": [p for n, p in named if mask[n]],
                   "weight_decay": cfg.train.weight_decay or 0.0},
                  {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0}]
        self.opt = torch.optim.SGD(groups, lr=0.0, momentum=cfg.train.momentum, foreach=True)
        self.params = [p for _, p in named]
        self.clip = cfg.train.grad_clip_norm
        self.schedule = schedule
        self.sharded: tuple[nn.Parameter, object] | None = None   # (W, model group)

    def step(self, count: int) -> torch.Tensor:
        """Update from the gradients in ``.grad`` at schedule step ``count``;
        returns the global norm of the raw gradients (a device scalar)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        # float64 sums: torch's float32 norm on the CPU is off by ~4e-5 at
        # 2M elements, where XLA's reduction is not
        norms = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64))
        if self.sharded is not None:        # a class shard's square sums over its group
            w, group = self.sharded
            i = next(j for j, g in enumerate(grads) if g is w.grad)
            sq = norms[i:i + 1] ** 2
            torch.distributed.all_reduce(sq, group=group)
            norms = torch.cat([norms[:i], sq.sqrt(), norms[i + 1:]])
        gnorm = torch.linalg.vector_norm(norms).float()
        if self.clip:
            coef = torch.where(gnorm < self.clip, torch.ones_like(gnorm), self.clip / gnorm)
            torch._foreach_mul_(grads, coef)
        lr = float(self.schedule(count))
        for g in self.opt.param_groups:
            g["lr"] = lr
        self.opt.step()
        return gnorm


def make_sgd_tx(cfg: Config, model: nn.Module, schedule: Callable[[int], float]) -> SGDTx:
    return SGDTx(cfg, model, schedule)


class FaceTrainModel(nn.Module):
    """Backbone + margin head, float32 parameters, drawn from ``generator``.
    The classes are padded to a multiple of ``mesh.model`` (``crfr``'s
    rule), the padding masked by the head's ``num_valid``."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        mc, lc = cfg.model, cfg.loss
        self.backbone = build_backbone(mc.backbone, embedding_dim=mc.embedding_dim,
                                       dropout=mc.dropout, input_size=mc.input_size,
                                       generator=generator, remat=getattr(mc, "remat", False))
        c = cfg.data.num_classes
        c_pad = pmesh.pad_to_multiple(c, cfg.mesh.model)
        self.head = MarginHead(mc.embedding_dim, c_pad, margin_type=lc.head,
                               s=lc.scale, m=lc.margin, easy_margin=lc.easy_margin,
                               num_valid=c if c_pad != c else None, generator=generator)


def _fit_classes(w: torch.Tensor, c: int) -> torch.Tensor:
    """A (D, C') head weight or its momentum cut or zero-padded to C columns:
    the padding classes of another mesh's checkpoint are never read."""
    if w.shape[1] >= c:
        return w[:, :c]
    return torch.cat([w, w.new_zeros((w.shape[0], c - w.shape[1]))], dim=1)


def sum_grads(params, world: int, group=None) -> None:
    """Sum the ``.grad`` of ``params`` (replicated on every rank) over
    ``group`` (the world when None): one all-reduce of their flattened
    concatenation. A no-op on one rank."""
    if world <= 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    torch.distributed.all_reduce(flat, group=group)
    for g, v in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(v)


def _step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: (seed, step) in 64 bits."""
    return ((seed % (1 << 32)) << 32) | (step % (1 << 32))


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=True)


class Trainer:
    """Owns the model, the optimizer, the step and the metrics.

    ``device`` defaults to CUDA and raises without it; pass ``"cpu"`` to
    train on the CPU (the tests do). ``state`` is everything a checkpoint
    holds: model parameters and BN statistics, momentum buffers, the step
    and the seed the generators derive from."""

    def __init__(self, cfg: Config, steps_per_epoch: int = 1000,
                 metrics: MetricsWriter | None = None, device=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device("cuda" if device is None else device)
        if mesh is None and (cfg.mesh.data * cfg.mesh.model > 1 or pmesh.world_size() > 1):
            mesh = pmesh.make_mesh(cfg.mesh, "cuda" if self.device.type == "cuda" else "cpu")
        self.world = mesh_world(mesh)
        self.mesh = mesh if self.world > 1 else None
        if self.mesh is not None and tuple(self.mesh.shape) != (cfg.mesh.data, cfg.mesh.model):
            raise ValueError(f"mesh {tuple(self.mesh.shape)} is not the config's "
                             f"{cfg.mesh.data}x{cfg.mesh.model}")
        self.metrics = metrics or MetricsWriter(stdout=False)
        self.steps_per_epoch = steps_per_epoch
        self.model = self._build_model(cfg)
        self.model.to(self.device).train()
        self._shard_model()
        self._step_seed_base = cfg.train.seed
        self._teacher_fn: Callable | None = None
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.tx = make_sgd_tx(cfg, self.model, self.schedule)
        if self._w_shard.parts > 1:
            self.tx.sharded = (self.model.head.weight, self.mesh.get_group("model"))
        self.compute_dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                              else torch.float32)

        impl = cfg.loss.ce_impl
        if impl == "auto":
            if cfg.mesh.model > 1:
                impl = "sharded"
            elif cfg.data.num_classes > cfg.loss.ce_streaming_threshold:
                impl = "streaming"
            else:
                impl = "dense"
        if impl == "sharded":
            if cfg.mesh.model <= 1:
                raise ValueError("ce_impl='sharded' needs mesh.model > 1")
            lc = cfg.loss
            self._sharded_ce = sharded_margin_ce(self.mesh, margin_type=lc.head, s=lc.scale,
                                                 m=lc.margin, easy_margin=lc.easy_margin,
                                                 num_valid=self.model.head.num_valid)
        elif impl not in ("dense", "streaming"):
            raise ValueError(f"unknown ce_impl {cfg.loss.ce_impl!r}")
        self._ce_impl = impl
        self._head_counts = self._count_head()

        dc = cfg.data
        hi = min(dc.degrade_max, dc.image_size)
        self._lows = (dc.degrade_min, hi) if dc.degrade_min <= hi else None
        self.host_step = 0

    # ------------------------------------------------------------------
    def _shard_model(self) -> None:
        """On a mesh: keep this rank's class shard of W, make the replicated
        tensors rank 0's, and train BN and dropout on the global batch."""
        self._rank, self._w_shard, self._data_group = 0, pmesh.Sharding(dim=1), None
        if self.mesh is None:
            return
        dist = torch.distributed
        self._rank = dist.get_rank()
        self._w_shard = pmesh.class_sharding(self.mesh)
        head = self.model.head
        head.weight = nn.Parameter(self._w_shard.local(head.weight.detach()).clone())
        with torch.no_grad():
            for t in (*self.model.parameters(), *self.model.buffers()):
                if t is not head.weight:
                    dist.broadcast(t, 0)
        if self.cfg.mesh.data > 1:
            self._data_group = self.mesh.get_group("data")
        set_global_batch(self.model, self._rank, self.world)

    def _sync_grads(self) -> None:
        """Sum the gradients of the replicated parameters over the world (one
        all-reduce of their flattened concatenation) and W's over the data
        group."""
        if self.mesh is None:
            return
        w = self.model.head.weight
        sum_grads([p for p in self.tx.params if p is not w], self.world)
        if w.grad is not None and self._data_group is not None:
            torch.distributed.all_reduce(w.grad, group=self._data_group)

    def sync_host_step(self) -> int:
        """The step count. It lives on the host, so this reads nothing from
        the device; kept for callers written against ``crfr``."""
        return self.host_step

    def _build_model(self, cfg: Config) -> nn.Module:
        return FaceTrainModel(cfg, torch.Generator().manual_seed(cfg.train.seed))

    def set_teacher(self, teacher_apply: Callable[[torch.Tensor], torch.Tensor]):
        """Turn on the KD term: ``teacher_apply`` (normalized HR pixels →
        (B, D) embeddings, frozen, e.g. ``distill_loop.teacher_from_trainer``)
        sees each step's batch before degradation, and the loss gains
        ``loss.distill_weight``·‖emb − t‖² while that weight is above 0."""
        self._teacher_fn = teacher_apply

    def _w_index(self) -> int:
        """W's index in the optimizer's state_dict."""
        ps = [p for g in self.tx.opt.param_groups for p in g["params"]]
        return next(i for i, p in enumerate(ps) if p is self.model.head.weight)

    def _gather_w(self, w: torch.Tensor) -> torch.Tensor:
        """W (or its momentum) whole from the class shards: an all-gather
        over the model group."""
        if self.mesh is None or self._w_shard.parts == 1:
            return w
        group = self.mesh.get_group("model")
        parts = [torch.empty_like(w) for _ in range(self._w_shard.parts)]
        torch.distributed.all_gather(parts, w.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @property
    def state(self) -> dict:
        """Parameters and BN statistics, the optimizer's state, the step and
        the seed, with W and its momentum whole (on a mesh every rank must
        read it: the class shards are gathered)."""
        model = self.model.state_dict()
        opt = self.tx.opt.state_dict()
        if self.mesh is not None:
            model["head.weight"] = self._gather_w(model["head.weight"])
            i = self._w_index()
            if i in opt["state"]:
                opt["state"][i] = dict(opt["state"][i], momentum_buffer=self._gather_w(
                    opt["state"][i]["momentum_buffer"]))
        return {"model": model, "opt": opt, "step": self.host_step,
                "seed": self.cfg.train.seed}

    @state.setter
    def state(self, st: dict) -> None:
        """Load a state of any mesh: W and its momentum are cut to this
        run's padded class count, and on a mesh to this rank's shard."""
        if st["seed"] != self.cfg.train.seed:
            raise ValueError(f"the state was trained with seed {st['seed']}, this trainer "
                             f"has {self.cfg.train.seed}")
        c = self.model.head.weight.shape[1] * self._w_shard.parts
        model = dict(st["model"])
        model["head.weight"] = self._w_shard.local(_fit_classes(model["head.weight"], c))
        opt = st["opt"]
        i = self._w_index()
        if i in opt["state"] and "momentum_buffer" in opt["state"][i]:
            mom = self._w_shard.local(_fit_classes(opt["state"][i]["momentum_buffer"], c))
            opt = dict(opt, state=dict(opt["state"]))
            opt["state"][i] = dict(opt["state"][i], momentum_buffer=mom)
        self.model.load_state_dict(model)
        self.tx.opt.load_state_dict(opt)
        self.host_step = int(st["step"])

    def _generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _step_seed(self._step_seed_base, step))

    def _preprocess(self, x: torch.Tensor, gen: torch.Generator,
                    lows: torch.Tensor | None) -> torch.Tensor:
        """Degrade (one launch) and normalize to the compute dtype."""
        if self._lows is None:
            return normalize(x, self.compute_dtype)
        lo, hi = self._lows
        b = x.shape[0]
        if lows is not None:
            if not (isinstance(lows, torch.Tensor) and lows.device.type != "cpu"):
                host = np.asarray(lows)         # checked here: the kernel marks them NaN
                if ((host < lo) | (host > hi)).any():
                    raise ValueError(f"lows outside {lo}..{hi}: {host.min()}..{host.max()}")
            low = _as_tensor(pmesh.local_rows(self.mesh, lows), self.device).to(torch.int32)
        elif lo == hi:
            low = lo                                      # a fixed degradation
        elif self.cfg.data.per_sample_degrade:            # drawn for the global batch
            low = torch.randint(lo, hi + 1, (b * self.world,), generator=gen,
                                device=self.device, dtype=torch.int32)
            low = pmesh.local_rows(self.mesh, low)
        else:                                             # one low for the batch
            low = torch.randint(lo, hi + 1, (1,), generator=gen, device=self.device,
                                dtype=torch.int32).expand(b).contiguous()
        if x.dtype not in (torch.uint8, torch.float32):
            x = x.float()
        return fused_degrade_normalize(x.contiguous(), low, self.cfg.data.resize_mode,
                                       self.compute_dtype, lows=(lo, hi))

    def _count_head(self) -> dict:
        """What the CE of a step runs over, for the ``train.head`` span:
        ``path`` (dense, streaming or sharded), ``classes`` (this rank's
        columns of W less the padding), ``blocks`` (the class blocks a
        forward takes, 1 but for streaming) and ``block`` (their width)."""
        head = self.model.head
        width = head.weight.shape[1]
        valid = head.num_valid if head.num_valid is not None else width * self._w_shard.parts
        lo = self._w_shard.index * width
        classes = min(max(valid - lo, 0), width)
        block = self.cfg.loss.ce_block if self._ce_impl == "streaming" else width
        return {"path": self._ce_impl, "classes": classes, "blocks": -(-width // block),
                "block": block}

    def _loss(self, emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The CE of this rank's rows: the mean over them, or on a mesh this
        rank's share of the global mean."""
        if self._ce_impl == "sharded":
            return self._sharded_ce(emb, labels, self.model.head.weight)
        return self._local_ce(emb, labels) / self.world

    def _local_ce(self, emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        head, lc = self.model.head, self.cfg.loss
        if self._ce_impl == "streaming":
            return streaming_margin_ce(emb, head.weight, labels, margin_type=lc.head,
                                       s=lc.scale, m=lc.margin, easy_margin=lc.easy_margin,
                                       block=lc.ce_block, num_valid=head.num_valid)
        return head.loss(emb, labels)

    def _student_input(self, raw: torch.Tensor, gen: torch.Generator,
                       lows: torch.Tensor | None) -> torch.Tensor:
        """The backbone's normalized input from the raw batch: ``_preprocess``."""
        return self._preprocess(raw, gen, lows)

    def _extra_terms(self, raw: torch.Tensor, x: torch.Tensor, emb: torch.Tensor,
                     t: torch.Tensor | None) -> dict[str, torch.Tensor]:
        """Loss terms added to the CE, by name, from the raw batch, the
        backbone's input ``x``, its embeddings and the teacher's embeddings
        ``t`` of the normalised HR batch (None without the KD term): the KD
        term."""
        if t is None:
            return {}
        return {"kd": residual_kd_loss(emb, 0.0, t, weight=self.cfg.loss.distill_weight)}

    def train_step(self, images, labels, lows=None, local: bool = False
                   ) -> dict[str, torch.Tensor]:
        """One step. ``images`` (B, S, S, 3) uint8/f32 raw pixels, ``labels``
        (B,), numpy or tensors; ``lows`` (B,) each image's low in place of
        the step's own draw, each in [degrade_min, degrade_max] (checked
        when they come from the host; lows already on the card are not
        read back). Returns device scalars ``loss`` and
        ``grad_norm`` (of the raw gradients), and with extra terms the
        ``ce`` and each term by name.

        On a mesh the batch is global and each rank keeps its rows, or with
        ``local`` it is this rank's slab of a global batch of world·b rows;
        ``lows`` are always the global batch's. The metrics are the global
        batch's, the same on every rank.

        While a profiler runs, the step is the span ``train.step`` (call id
        ``host_step``, rows this rank's), over ``train.preprocess``,
        ``train.backbone``, ``train.head``, ``train.head_backward``,
        ``train.backward`` and ``train.optimizer`` (``utils.profiling``);
        the head's two and the optimizer's are device-timed, the others are
        ``detail`` spans. ``train.head`` carries the CE's counts
        (``_count_head``)."""
        rows = len(labels) if local else len(labels) // self.world
        with annotate("train.step", self.device, call=self.host_step, rows=rows, detail=True):
            return self._step(images, labels, lows, local)

    def _step(self, images, labels, lows, local: bool) -> dict[str, torch.Tensor]:
        step = self.host_step
        gen = self._generator(step)
        if not local:
            images = pmesh.local_rows(self.mesh, images)
            labels = pmesh.local_rows(self.mesh, labels)
        raw = _as_tensor(images, self.device)
        t = None                        # the teacher first: its transients go before the graph
        if self._teacher_fn is not None and self.cfg.loss.distill_weight > 0:
            t = self._teacher_fn(normalize(raw))
        with annotate("train.preprocess", self.device, detail=True):
            x = self._student_input(raw, gen, lows)
        y = _as_tensor(labels, self.device).long()
        self.model.train()
        with annotate("train.backbone", self.device, detail=True), torch.autocast(
                self.device.type, dtype=torch.bfloat16,
                enabled=self.compute_dtype == torch.bfloat16):
            emb = self.model.backbone(x, generator=gen)
        with annotate("train.head", self.device, counts=self._head_counts):
            ce = self._loss(emb, y)
        terms = self._extra_terms(raw, x, emb, t)
        if self.world > 1:              # each rank's share of the global mean
            terms = {k: v / self.world for k, v in terms.items()}
        loss = ce
        for term in terms.values():
            loss = loss + term
        self.tx.opt.zero_grad(set_to_none=True)
        self._backward(loss, emb)
        self._sync_grads()
        with annotate("train.optimizer", self.device):
            gnorm = self.tx.step(step)
        self.host_step += 1
        m = {"loss": loss.detach(), "grad_norm": gnorm}
        if terms:
            m.update(ce=ce.detach(), **{k: v.detach() for k, v in terms.items()})
        # the shares → the global batch's values
        m.update(pmesh.sum_over_ranks({k: v for k, v in m.items() if k != "grad_norm"}))
        return m

    def _backward(self, loss: torch.Tensor, emb: torch.Tensor) -> None:
        """``loss.backward()``. While a profiler runs, the spans
        ``train.head_backward`` (up to the embeddings' gradient) and
        ``train.backward`` (the rest), parted by a hook on ``emb`` that
        leaves the gradient as it is; autograd may call it on its own
        device thread."""
        head = begin("train.head_backward", self.device)
        if head is None:
            loss.backward()
            return
        rest = []

        def part(_grad) -> None:
            end(head)
            rest.append(begin("train.backward", self.device, parent=head.parent, detail=True))

        hook = emb.register_hook(part)
        try:
            loss.backward()
        finally:
            hook.remove()
            end(head)
            end(rest[0] if rest else None)

    def fit(self, batches: Iterable, max_steps: int | None = None,
            eval_fn: Callable[["Trainer"], dict] | None = None) -> dict[str, float]:
        """Run the train loop over (images, labels) batches, fed to the
        device ahead of the step (``train.feed.device_feed``).
        ``eval_fn(trainer) -> {metric: value}`` runs every
        ``train.eval_every_steps`` and is logged."""
        from crfr_torch.train.feed import device_feed

        t0 = time.time()
        n_img = 0
        last: dict[str, float] = {}
        feed = device_feed(batches, self.device, mesh=self.mesh)   # this rank's rows
        for i, (images, labels) in enumerate(feed):
            if max_steps is not None and i >= max_steps:
                break
            m = self.train_step(images, labels, local=True)
            n_img += len(labels) * self.world
            step = self.host_step
            if step % self.cfg.train.log_every == 0 or (max_steps and i == max_steps - 1):
                scalars = {k: float(v) for k, v in m.items()}
                last.update(scalars)
                self.metrics.write(step, imgs_per_sec=n_img / max(time.time() - t0, 1e-9),
                                   lr=float(self.schedule(step)), **scalars)
            if eval_fn is not None and step % self.cfg.train.eval_every_steps == 0:
                ev = eval_fn(self)
                self.metrics.write(step, **{f"eval_{k}": v for k, v in ev.items()})
                last.update(ev)
        return last

    # ------------------------------------------------------------------
    def embed_state(self) -> nn.Module:
        """The live backbone: pass as ``backbone_apply``'s ``state`` so eval
        sees the current weights."""
        return self.model.backbone

    def backbone_apply(self, state: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """(normalized NHWC pixels) → (B, D) f32 embeddings in eval mode, in
        the compute dtype; the module's train mode is restored after."""
        was = state.training
        state.eval()
        try:
            with torch.no_grad(), torch.autocast(
                    self.device.type, dtype=torch.bfloat16,
                    enabled=self.compute_dtype == torch.bfloat16):
                return state(x.to(self.device)).float()
        finally:
            state.train(was)

    def embed_fn(self) -> Callable:
        """Raw (B, S, S, 3) pixels → (B, D) f32, reading the trainer's live
        weights at every call. On a mesh a batch that divides the world is
        split over the ranks and gathered back (every rank must call)."""
        def run(images) -> torch.Tensor:
            images, split = pmesh.maybe_shard_batch(self.mesh, images)
            x = normalize(_as_tensor(images, self.device))
            emb = self.backbone_apply(self.embed_state(), x)
            return pmesh.all_gather_rows(emb, None) if split else emb

        return run

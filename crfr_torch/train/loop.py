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

Not ported: more than one device (the class-sharded CE and any mesh of
more than one device raise ``NotImplementedError``) and residual KD
(``set_teacher`` raises).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from crfr_torch.configs import Config
from crfr_torch.device import refuse_mesh, resolve_device
from crfr_torch.losses.arcface import MarginHead, streaming_margin_ce
from crfr_torch.models.irse import build_backbone
from crfr_torch.ops.fused_preprocess import fused_degrade_normalize
from crfr_torch.ops.normalize import normalize
from crfr_torch.utils.logging import MetricsWriter


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

    def step(self, count: int) -> torch.Tensor:
        """Update from the gradients in ``.grad`` at schedule step ``count``;
        returns the global norm of the raw gradients (a device scalar)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        # float64 sums: torch's float32 norm on the CPU is off by ~4e-5 at
        # 2M elements, where XLA's reduction is not
        norms = torch._foreach_norm(grads, 2, dtype=torch.float64)
        gnorm = torch.linalg.vector_norm(torch.stack(norms)).float()
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
    """Backbone + margin head, float32 parameters, drawn from ``generator``."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        mc, lc = cfg.model, cfg.loss
        self.backbone = build_backbone(mc.backbone, embedding_dim=mc.embedding_dim,
                                       dropout=mc.dropout, input_size=mc.input_size,
                                       generator=generator, remat=getattr(mc, "remat", False))
        self.head = MarginHead(mc.embedding_dim, cfg.data.num_classes, margin_type=lc.head,
                               s=lc.scale, m=lc.margin, easy_margin=lc.easy_margin,
                               generator=generator)


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
        refuse_mesh(mesh, "Trainer")
        if cfg.mesh.data * cfg.mesh.model != 1:
            raise NotImplementedError(
                f"mesh {cfg.mesh.data}x{cfg.mesh.model}: training over more than one device "
                "(data parallel, the class-sharded head) is not ported yet; set "
                "mesh.data=1 mesh.model=1")
        self.cfg = cfg
        self.device = resolve_device("cuda" if device is None else device)
        self.metrics = metrics or MetricsWriter(stdout=False)
        self.steps_per_epoch = steps_per_epoch
        self.model = FaceTrainModel(cfg, torch.Generator().manual_seed(cfg.train.seed))
        self.model.to(self.device).train()
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.tx = make_sgd_tx(cfg, self.model, self.schedule)
        self.compute_dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                              else torch.float32)

        impl = cfg.loss.ce_impl
        if impl == "auto":
            impl = ("streaming" if cfg.data.num_classes > cfg.loss.ce_streaming_threshold
                    else "dense")
        if impl == "sharded":
            raise NotImplementedError("ce_impl='sharded' needs a mesh of more than one "
                                      "device, which is not ported yet")
        if impl not in ("dense", "streaming"):
            raise ValueError(f"unknown ce_impl {cfg.loss.ce_impl!r}")
        self._ce_impl = impl

        dc = cfg.data
        hi = min(dc.degrade_max, dc.image_size)
        self._lows = (dc.degrade_min, hi) if dc.degrade_min <= hi else None
        self.host_step = 0

    # ------------------------------------------------------------------
    def sync_host_step(self) -> int:
        """The step count. It lives on the host, so this reads nothing from
        the device; kept for callers written against ``crfr``."""
        return self.host_step

    def set_teacher(self, teacher_apply: Callable[[torch.Tensor], torch.Tensor]):
        raise NotImplementedError("residual KD (set_teacher) is not ported yet")

    @property
    def state(self) -> dict:
        return {"model": self.model.state_dict(), "opt": self.tx.opt.state_dict(),
                "step": self.host_step, "seed": self.cfg.train.seed}

    @state.setter
    def state(self, st: dict) -> None:
        if st["seed"] != self.cfg.train.seed:
            raise ValueError(f"the state was trained with seed {st['seed']}, this trainer "
                             f"has {self.cfg.train.seed}")
        self.model.load_state_dict(st["model"])
        self.tx.opt.load_state_dict(st["opt"])
        self.host_step = int(st["step"])

    def _generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _step_seed(self.cfg.train.seed, step))

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
            low = _as_tensor(lows, self.device).to(torch.int32)
        elif lo == hi:
            low = lo                                      # a fixed degradation
        elif self.cfg.data.per_sample_degrade:
            low = torch.randint(lo, hi + 1, (b,), generator=gen, device=self.device,
                                dtype=torch.int32)
        else:                                             # one low for the batch
            low = torch.randint(lo, hi + 1, (1,), generator=gen, device=self.device,
                                dtype=torch.int32).expand(b).contiguous()
        if x.dtype not in (torch.uint8, torch.float32):
            x = x.float()
        return fused_degrade_normalize(x.contiguous(), low, self.cfg.data.resize_mode,
                                       self.compute_dtype, lows=(lo, hi))

    def _loss(self, emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        head, lc = self.model.head, self.cfg.loss
        if self._ce_impl == "streaming":
            return streaming_margin_ce(emb, head.weight, labels, margin_type=lc.head,
                                       s=lc.scale, m=lc.margin, easy_margin=lc.easy_margin,
                                       block=lc.ce_block, num_valid=head.num_valid)
        return head.loss(emb, labels)

    def train_step(self, images, labels, lows=None) -> dict[str, torch.Tensor]:
        """One step. ``images`` (B, S, S, 3) uint8/f32 raw pixels, ``labels``
        (B,), numpy or tensors; ``lows`` (B,) each image's low in place of
        the step's own draw, each in [degrade_min, degrade_max] (checked
        when they come from the host; lows already on the card are not
        read back). Returns device scalars ``loss`` and
        ``grad_norm`` (of the raw gradients)."""
        step = self.host_step
        gen = self._generator(step)
        x = self._preprocess(_as_tensor(images, self.device), gen, lows)
        y = _as_tensor(labels, self.device).long()
        self.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            emb = self.model.backbone(x, generator=gen)
        loss = self._loss(emb, y)
        self.tx.opt.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = self.tx.step(step)
        self.host_step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm}

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
        for i, (images, labels) in enumerate(device_feed(batches, self.device)):
            if max_steps is not None and i >= max_steps:
                break
            m = self.train_step(images, labels)
            n_img += len(labels)
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
        weights at every call."""
        def run(images) -> torch.Tensor:
            x = normalize(_as_tensor(images, self.device))
            return self.backbone_apply(self.embed_state(), x)

        return run

"""Residual knowledge distillation of a low-resolution student
(crfr/train/distill_loop.py).

One step:

  HR batch (uint8 or f32 NHWC, host or device)
    → the frozen teacher's embedding t of the normalised HR batch
    → the student's input, one of:
        bicubic: degradation to a fixed low, a low per batch or a low per
          image and (x − 127.5)/128 in ONE launch of the preprocessing
          kernel, through ``Trainer._preprocess``;
        a frozen G (``sr_fn``): ↓ by ``sr_scale`` and (x − 127.5)/128 in ONE
          launch of the resize form of the kernel, then G's eval forward
          without a graph;
        a trainable G (``sr_module``): the same ↓, then G in train mode,
          inside the graph
    → s = S(input) (bf16 under autocast when the preset says so), r = R(s)
      in float32
    → L = CE(ArcFace(s, y)) + λ·‖(s + r) − t‖²  [+ w_px·‖G(lr) − hr‖² on
      the joint path]
    → the SGD chain of ``train.loop`` on the student (clip → masked decay →
      SGD with momentum); Adam (b1 0.9, b2 0.99) at ``sr_lr`` on G.

The reference applies its ↓ operator to *normalised* pixels; here the
kernel resizes raw pixels and normalises in the same pass. Every row of the
operator sums to 1, so the two are equal up to float32 rounding.

The joint path's pixel anchor is the mean *square* error, as the
reference computes it (``pixel_loss``'s default), though its docstring
calls it L1.

``DistillTrainer`` is a ``train.loop.Trainer`` with another model
(``StudentModel``, drawn from ``seed + 1``), another student input and
the KD (and pixel) terms, through ``Trainer.train_step``'s two hooks
``_student_input`` and ``_extra_terms``; the step's draws (the lows,
dropout) come from a ``torch.Generator`` seeded from (``seed + 7``, step),
so a restored trainer's next step equals the uninterrupted one's. ``train_step(lows=...)`` takes the lows from the
caller, which is how the tests carry the reference's draws across.

``teacher_from_state`` and ``teacher_from_trainer`` freeze a backbone into
a callable: normalized NHWC pixels → (B, D) f32 embeddings, in eval mode,
under ``torch.no_grad()`` and in the teacher's compute dtype. The
reference stop-gradients the teacher's output; running it without a graph
gives the same values and no gradient, with less memory. So in
``train-sr`` the identity term adds to the G loss's value and sends no
gradient to G, as in the reference.

On a mesh (``parallel.mesh``, one process per device) the student trains
data-parallel as ``Trainer`` does, with the class-sharded CE when
``mesh.model`` > 1: the teacher's no-grad forward, the student's input
(kernel 1 or kernel 2 + G) and a trainable G all run on the rank's rows,
G's BN on the global batch and its gradients summed over the world before
Adam. ``student_embed_fn(local_snapshot=True)`` evaluates on a rank-local
copy of the replicated student, taken once per trained step, with no
collective: the redundant in-training eval on every rank.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from crfr_torch.configs import Config
from crfr_torch.losses.distill import residual_kd_loss
from crfr_torch.losses.gan import pixel_loss
from crfr_torch.models.residual import ResidualBranch
from crfr_torch.ops.fused_preprocess import fused_resize_normalize
from crfr_torch.models.irse import set_global_batch
from crfr_torch.ops.normalize import normalize
from crfr_torch.parallel import mesh as pmesh
from crfr_torch.train.loop import FaceTrainModel, Trainer, _as_tensor, sum_grads
from crfr_torch.utils.logging import MetricsWriter


def frozen_copy(module: nn.Module) -> nn.Module:
    """A snapshot of ``module`` in eval mode whose parameters take no
    gradient: later training of the original does not reach it."""
    return copy.deepcopy(module).eval().requires_grad_(False)


def teacher_from_state(backbone: nn.Module,
                       compute_dtype: torch.dtype = torch.float32) -> Callable:
    """A snapshot of ``backbone`` (an ``IRBackbone``, or a model with a
    ``.backbone``) as a frozen embed callable on normalized pixels."""
    bb = frozen_copy(getattr(backbone, "backbone", backbone))
    device = next(bb.parameters()).device

    def f(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), torch.autocast(device.type, dtype=torch.bfloat16,
                                             enabled=compute_dtype == torch.bfloat16):
            return bb(x).float()

    return f


def teacher_from_trainer(trainer) -> Callable:
    """``teacher_from_state`` of a ``train.loop.Trainer``'s current weights."""
    return teacher_from_state(trainer.model.backbone, trainer.compute_dtype)


class StudentModel(FaceTrainModel):
    """Backbone + margin head + the residual branch, float32 parameters,
    drawn from ``generator``."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__(cfg, generator)
        self.residual = ResidualBranch(cfg.model.embedding_dim, generator=generator)


class DistillTrainer(Trainer):
    def __init__(self, cfg: Config, teacher_fn: Callable, steps_per_epoch: int = 1000,
                 metrics: MetricsWriter | None = None, kd_normalize: bool = False,
                 sr_fn: Callable | None = None, sr_scale: int = 8,
                 sr_module: nn.Module | None = None, sr_lr: float = 1e-5,
                 sr_pixel_weight: float = 0.3, device=None, mesh=None):
        """``teacher_fn``: normalized HR pixels → (B, D) embeddings, frozen
        (``teacher_from_trainer``). ``kd_normalize`` takes the KD distance
        between unit rows. ``sr_fn`` (normalized LR → normalized SR pixels,
        frozen: ``sr_loop.sr_apply_from_state``, ``load_sr_apply``) feeds
        the student hallucinated faces; ``sr_module`` (a ``Hallucinator``,
        copied) trains G jointly at ``sr_lr`` with a pixel anchor of weight
        ``sr_pixel_weight``. The two are exclusive. ``device`` defaults to
        CUDA and raises without it."""
        if cfg.loss.distill_weight <= 0:
            raise ValueError("set loss.distill_weight > 0")
        if sr_fn is not None and sr_module is not None:
            raise ValueError("sr_fn (frozen G) and sr_module (trainable G) are exclusive")
        size = cfg.data.image_size
        if (sr_fn is not None or sr_module is not None) and size % sr_scale:
            raise ValueError(f"image size {size} is not a multiple of sr_scale {sr_scale}")
        super().__init__(cfg, steps_per_epoch=steps_per_epoch, metrics=metrics,
                         device=device, mesh=mesh)
        self.set_teacher(teacher_fn)
        self._step_seed_base = cfg.train.seed + 7
        self.kd_normalize = kd_normalize
        self.sr_fn, self.sr_scale = sr_fn, sr_scale
        self.g = None
        if sr_module is not None:
            from crfr_torch.train.sr_loop import _Adam

            self.g = copy.deepcopy(sr_module).to(self.device).train().requires_grad_(True)
            set_global_batch(self.g, self._rank, self.world)
            self.g_opt = _Adam(self.g.parameters(), lambda _count: sr_lr)
            self.sr_pixel_weight = sr_pixel_weight

    def _build_model(self, cfg: Config) -> StudentModel:
        return StudentModel(cfg, torch.Generator().manual_seed(cfg.train.seed + 1))

    @property
    def step(self) -> int:
        """The step count, which the CLI's step loop reads (as ``SRTrainer.step``)."""
        return self.host_step

    def _down(self, x: torch.Tensor) -> torch.Tensor:
        """Raw HR pixels → normalized LR at S/sr_scale, float32: one launch."""
        low = self.cfg.data.image_size // self.sr_scale
        return fused_resize_normalize(x, (low, low), self.cfg.data.resize_mode, torch.float32)

    def _student_input(self, raw: torch.Tensor, gen: torch.Generator,
                       lows: torch.Tensor | None) -> torch.Tensor:
        """Bicubic (``Trainer._preprocess``), or ↓ then the frozen or the
        trainable G."""
        if self.sr_fn is None and self.g is None:
            return self._preprocess(raw, gen, lows)
        if lows is not None:
            raise ValueError("lows apply to the bicubic path only")
        x = raw if raw.dtype in (torch.uint8, torch.float32) else raw.float()
        lr = self._down(x.contiguous())
        if self.g is None:
            return self.sr_fn(lr)
        self.g.train()
        return self.g(lr)[0]

    def _extra_terms(self, raw: torch.Tensor, x: torch.Tensor, emb: torch.Tensor,
                     t: torch.Tensor | None) -> dict[str, torch.Tensor]:
        """λ·‖(s + r) − t‖², and with a trainable G the pixel anchor of its
        output ``x`` against the normalised HR batch."""
        terms = {"kd": residual_kd_loss(emb, self.model.residual(emb), t,
                                        weight=self.cfg.loss.distill_weight,
                                        normalize=self.kd_normalize)}
        if self.g is not None:
            terms["sr_px"] = self.sr_pixel_weight * pixel_loss(x, normalize(raw))
        return terms

    def train_step(self, images, labels, lows=None, local: bool = False
                   ) -> dict[str, torch.Tensor]:
        """``Trainer.train_step`` on the student's input, then Adam on a
        trainable G. ``lows`` apply to the bicubic path only. Returns device
        scalars ``loss``, ``grad_norm``, ``ce`` and ``kd`` (and ``sr_px``
        with a trainable G)."""
        m = super().train_step(images, labels, lows, local)
        if self.g is not None:
            sum_grads(self.g_opt.params, self.world)
            self.g_opt.apply()
        if self.host_step % self.cfg.train.log_every == 0:
            self.metrics.write(self.host_step, **{k: float(v) for k, v in m.items()})
        return m

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The trainer's ``state`` (student, momentum, step, seed), and with
        a trainable G its state and Adam's."""
        sd = dict(self.state)
        if self.g is not None:
            sd["g"] = self.g.state_dict()
            sd["g_opt"] = self.g_opt.opt.state_dict()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self.state = sd
        if self.g is not None:
            self.g.load_state_dict(sd["g"])
            self.g_opt.opt.load_state_dict(sd["g_opt"])

    def sr_apply(self, trainable: bool = False) -> Callable:
        """A snapshot of the jointly trained G as the SR plug (normalized LR
        → normalized SR), for ``make_extract_fn(sr_apply=...)``."""
        if self.g is None:
            raise ValueError("no trainable G (pass sr_module=)")
        from crfr_torch.train.sr_loop import sr_apply_from_state

        return sr_apply_from_state(self.g, trainable=trainable)

    # ------------------------------------------------------------------
    def student_apply(self, state: StudentModel, x: torch.Tensor) -> torch.Tensor:
        """(normalized NHWC pixels) → s + r, (B, D) f32, in eval mode; pass
        as ``make_extract_fn``'s ``backbone_apply`` with ``state_fn``
        returning ``self.model``."""
        s = self.backbone_apply(state.backbone, x)
        was = state.residual.training
        state.residual.eval()
        try:
            with torch.no_grad():
                return s + state.residual(s)
        finally:
            state.residual.train(was)

    def student_embed_fn(self, with_residual: bool = False,
                         local_snapshot: bool = False) -> Callable:
        """Raw (B, S, S, 3) pixels → the student's embedding (s, or s + r),
        reading the trainer's live weights at every call. On a mesh a batch
        that divides the world is split over the ranks and gathered back
        (every rank must call), unless ``local_snapshot``: then each rank
        embeds the whole batch on its own copy of the student, taken once
        per trained step, with no collective."""
        snap: dict = {}

        def model() -> StudentModel:
            if not local_snapshot:
                return self.model
            if snap.get("step") != self.host_step:
                snap.update(step=self.host_step, model=pmesh.local_snapshot(self.model))
            return snap["model"]

        def run(images) -> torch.Tensor:
            split = False
            if not local_snapshot:
                images, split = pmesh.maybe_shard_batch(self.mesh, images)
            x = normalize(_as_tensor(images, self.device))
            st = model()
            emb = (self.student_apply(st, x) if with_residual
                   else self.backbone_apply(st.backbone, x))
            return pmesh.all_gather_rows(emb, None) if split else emb

        return run

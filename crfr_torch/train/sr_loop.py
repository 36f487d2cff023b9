"""Hallucinator (SR GAN) training on one device (crfr/train/sr_loop.py).

One step:

  HR batch (uint8 or f32 NHWC, host or device)
    → lr = bicubic↓ to S/scale and (x − 127.5)/128 in ONE launch of the
      preprocessing kernel (``ops.fused_preprocess.fused_resize_normalize``);
      hr = (x − 127.5)/128 beside it for the losses and D. Every row of the
      resize operator sums to 1, so resizing raw pixels and then
      normalising equals the reference's ↓ of normalised pixels to float32
      rounding
    → G step: sr, coarse, priors = G(lr) with G in train mode and D in eval
      mode; L_G = w_px·(‖sr−hr‖² + ½‖coarse−hr‖²) + w_adv·adv(D(sr))
      [+ w_id·‖T̂(sr)−T̂(hr)‖²] [+ w_pr·‖priors−targets‖²]
      [+ w_pc·perceptual]; Adam on G's parameters alone
    → the EMA of G's parameters and BN statistics
    → ``n_d_steps`` D steps on the same batch: D(hr) and D(sr.detach()) as
      two train-mode calls, then R1 = ½·γ·mean‖∇ₓ Σ D(x)‖² on the real
      batch with D in eval mode (reading the statistics the two calls just
      moved), through a double backward.

Adam is optax's: b1 0.9, b2 0.99, eps 1e-8 outside the square root; the
learning rate of an update is the schedule (constant, or cosine over
``total_steps − warmup_steps`` after a linear warmup from 0) at the count
of updates before it, so D's schedule advances ``n_d_steps`` per step.
The EMA's decay at step k is ``min(decay, (1+k)/(10+k))``. The prior
targets for ``train_step(landmarks=...)`` are built on the device inside
the step. Every ``log_every`` steps PSNR/SSIM of the EMA weights on the
batch go to the metrics writer with the two losses.

Checkpoints are the port's own ``.pt`` files (``train.checkpoints``) with
the keys ``g``, ``d``, ``g_opt``, ``d_opt``, ``step``, ``g_ema`` and
``meta`` (format version 2, ``bicubic_skip``, ``scale``, ``n_priors``).
The reference's pre-v2 Orbax checkpoints cannot be read here, so there is
no legacy restore: a state without ``meta`` raises.

Not ported: a mesh of more than one device (it raises).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from crfr_torch.configs import Config
from crfr_torch.device import refuse_mesh, resolve_device
from crfr_torch.eval.image_quality import psnr, ssim
from crfr_torch.losses import gan as gl
from crfr_torch.models.sr import Hallucinator, build_discriminator, build_hallucinator
from crfr_torch.ops.fused_preprocess import fused_resize_normalize
from crfr_torch.ops.heatmaps import landmark_heatmaps, prior_targets
from crfr_torch.ops.normalize import denormalize, normalize
from crfr_torch.train.distill_loop import frozen_copy
from crfr_torch.utils.logging import MetricsWriter


def adam_schedule(peak: float, schedule: str = "constant", total_steps: int = 100_000,
                  warmup_steps: int = 0) -> Callable[[int], float]:
    """optax's constant or cosine decay, joined after a linear warmup."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown schedule {schedule!r} (want 'constant' or 'cosine')")
    decay = max(total_steps - warmup_steps, 1)

    def main(count: int) -> float:
        if schedule == "cosine":
            return peak * 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))
        return peak

    if warmup_steps <= 0:
        return main
    return lambda count: (peak * count / warmup_steps if count < warmup_steps
                          else main(count - warmup_steps))


class _Adam:
    """``torch.optim.Adam`` (betas 0.9, 0.99) at the schedule's value for
    its own count of updates."""

    def __init__(self, params, schedule: Callable[[int], float]):
        self.params = list(params)
        self.opt = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.99), eps=1e-8)
        self.schedule = schedule

    def count(self) -> int:
        st = self.opt.state.get(self.params[0])
        return int(st["step"]) if st else 0

    def step(self, loss: torch.Tensor) -> None:
        """Update from the gradient of ``loss`` with respect to these
        parameters alone (a parameter the loss does not reach gets zeros)."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.apply()

    def apply(self) -> None:
        """Update from the gradients in ``.grad`` (zeros where there are
        none), then clear them."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = float(self.schedule(self.count()))
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        for p in self.params:
            p.grad = None


def _as_pixels(a, device: torch.device) -> torch.Tensor:
    """Raw pixels as a contiguous uint8 or float32 tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    a = a.to(device, non_blocking=True)
    if a.dtype not in (torch.uint8, torch.float32):
        a = a.float()
    return a.contiguous()


def _run_eval(module: nn.Module, *args):
    """``module(*args)`` in eval mode, its mode restored after."""
    was = module.training
    module.eval()
    try:
        return module(*args)
    finally:
        module.train(was)


class SRTrainer:
    FORMAT_VERSION = 2

    def __init__(self, cfg: Config, scale: int = 8, n_priors: int = 16, mesh=None,
                 lr_g: float = 1e-4, lr_d: float = 1e-4,
                 teacher_fn: Callable | None = None,
                 prior_target_fn: Callable | None = None,
                 perceptual_fn: Callable | None = None,
                 metrics: MetricsWriter | None = None, adv_mode: str = "lsgan",
                 ema_decay: float = 0.999, bicubic_skip: bool = True,
                 schedule: str = "constant", total_steps: int = 100_000,
                 warmup_steps: int = 0, n_d_steps: int = 1, r1_gamma: float = 0.0,
                 device=None):
        """``teacher_fn`` (normalized pixels → embeddings, frozen) turns on
        the identity term, ``perceptual_fn`` (normalized pixels → a list of
        feature maps, differentiable in its input) the perceptual term,
        ``prior_target_fn(hr) → (B, S, S, n_priors)`` the prior term.
        ``n_d_steps`` D updates per G update on the same batch; ``r1_gamma``
        the R1 penalty's weight (0: off); ``ema_decay`` 0 turns the EMA off.
        ``device`` defaults to CUDA and raises without it."""
        refuse_mesh(mesh, "SRTrainer")
        if cfg.mesh.data * cfg.mesh.model != 1:
            raise NotImplementedError(
                f"mesh {cfg.mesh.data}x{cfg.mesh.model}: SR training over more than one "
                "device is not ported yet; set mesh.data=1 mesh.model=1")
        size = cfg.data.image_size
        if size % scale:
            raise ValueError(f"image size {size} is not a multiple of scale {scale}")
        self.cfg = cfg
        self.device = resolve_device("cuda" if device is None else device)
        self.metrics = metrics or MetricsWriter(stdout=False)
        self.scale, self.n_priors, self.bicubic_skip = scale, n_priors, bicubic_skip
        self.lr_size = size // scale
        self.g = build_hallucinator(scale, n_priors, bicubic_skip=bicubic_skip,
                                    generator=torch.Generator().manual_seed(0))
        self.d = build_discriminator(torch.Generator().manual_seed(1))
        self.g.to(self.device).train()
        self.d.to(self.device).train()
        self.g_ema = frozen_copy(self.g) if ema_decay > 0 else None
        self.ema_decay = ema_decay
        self.g_opt = _Adam(self.g.parameters(),
                           adam_schedule(lr_g, schedule, total_steps, warmup_steps))
        self.d_opt = _Adam(self.d.parameters(),
                           adam_schedule(lr_d, schedule, total_steps, warmup_steps))
        self.n_d_steps = max(int(n_d_steps), 1)
        self.r1_gamma = float(r1_gamma)
        self.teacher_fn = teacher_fn
        self.prior_target_fn = prior_target_fn
        self.perceptual_fn = perceptual_fn
        lc = cfg.loss
        self.weights = dict(px=lc.sr_pixel_weight, adv=lc.sr_adv_weight,
                            id=lc.sr_identity_weight, pr=lc.sr_prior_weight,
                            pc=lc.sr_perceptual_weight)
        self.adv_mode = adv_mode
        self.step = 0

    # ------------------------------------------------------------------
    def _down(self, x: torch.Tensor) -> torch.Tensor:
        """Raw HR pixels → normalized LR, float32: one kernel launch on CUDA."""
        return fused_resize_normalize(x, (self.lr_size, self.lr_size),
                                      self.cfg.data.resize_mode, torch.float32)

    def prior_targets_from_landmarks(self, landmarks) -> torch.Tensor:
        """(B, 5, 2) pixel-coordinate landmarks → (B, S, S, n_priors) on the
        trainer's device: 5 heatmaps (n_priors 5) or 5 heatmaps ++ 11
        parsing maps (n_priors 16)."""
        if self.n_priors not in (5, 16):
            raise ValueError(
                f"n_priors={self.n_priors} matches neither heatmaps-only "
                f"(5) nor heatmaps+parsing (16)")
        if not isinstance(landmarks, torch.Tensor):
            landmarks = torch.from_numpy(np.asarray(landmarks, np.float32))
        lm = landmarks.to(self.device, torch.float32)
        size = self.cfg.data.image_size
        return landmark_heatmaps(lm, size) if self.n_priors == 5 else prior_targets(lm, size)

    def _g_loss(self, hr: torch.Tensor, lr: torch.Tensor,
                prior_t: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.weights
        self.g.train()
        self.d.eval()
        sr, coarse, priors = self.g(lr)
        loss = w["px"] * (gl.pixel_loss(sr, hr) + 0.5 * gl.pixel_loss(coarse, hr))
        loss = loss + w["adv"] * gl.adversarial_g_loss(self.d(sr), self.adv_mode)
        if self.teacher_fn is not None and w["id"] > 0:
            loss = loss + w["id"] * gl.identity_loss(self.teacher_fn(sr), self.teacher_fn(hr))
        if prior_t is not None and w["pr"] > 0:
            loss = loss + w["pr"] * gl.prior_loss(priors, prior_t)
        if self.perceptual_fn is not None and w["pc"] > 0:
            with torch.no_grad():
                feats_hr = self.perceptual_fn(hr)
            loss = loss + w["pc"] * gl.perceptual_loss(self.perceptual_fn(sr), feats_hr)
        return loss, sr

    def _d_loss(self, hr: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
        self.d.train()
        loss = gl.adversarial_d_loss(self.d(hr), self.d(sr), self.adv_mode)
        if self.r1_gamma > 0:
            x = hr.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(_run_eval(self.d, x).sum(), x, create_graph=True)
            loss = loss + 0.5 * self.r1_gamma * gx.float().square().sum(dim=(1, 2, 3)).mean()
        return loss

    @torch.no_grad()
    def _ema_update(self) -> None:
        d = np.float32(self.step)
        d = float(min(np.float32(self.ema_decay), (np.float32(1.0) + d) / (np.float32(10.0) + d)))
        ema, live = self.g_ema.state_dict(), self.g.state_dict()
        floats = [k for k, v in ema.items() if v.is_floating_point()]
        e, c = [ema[k] for k in floats], [live[k] for k in floats]
        torch._foreach_mul_(e, d)
        torch._foreach_add_(e, c, alpha=1.0 - d)
        for k, v in ema.items():
            if not v.is_floating_point():
                v.copy_(live[k])

    def train_step(self, hr_images, landmarks=None) -> dict[str, torch.Tensor]:
        """One G step and ``n_d_steps`` D steps on raw (B, S, S, 3) uint8/f32
        pixels, numpy or tensors. ``landmarks`` (B, 5, 2) pixel coordinates
        switch the prior term to targets built from them on the device,
        whatever ``prior_target_fn`` is. Returns device scalars ``g_loss``
        and ``d_loss``."""
        x = _as_pixels(hr_images, self.device)
        hr = normalize(x)
        lr = self._down(x)
        if landmarks is not None:
            prior_t = self.prior_targets_from_landmarks(landmarks)
        else:
            prior_t = self.prior_target_fn(hr) if self.prior_target_fn is not None else None
        g_loss, sr = self._g_loss(hr, lr, prior_t)
        self.g_opt.step(g_loss)
        sr = sr.detach()                    # G's output before its update
        if self.g_ema is not None:
            self._ema_update()
        for _ in range(self.n_d_steps):
            d_loss = self._d_loss(hr, sr)
            self.d_opt.step(d_loss)
        self.step += 1
        g_loss, d_loss = g_loss.detach(), d_loss.detach()
        if self.step % self.cfg.train.log_every == 0:
            self.metrics.write(self.step, g_loss=float(g_loss), d_loss=float(d_loss),
                               **self.psnr_ssim(x))
        return {"g_loss": g_loss, "d_loss": d_loss}

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a checkpoint holds; ``meta`` records the format and the
        switches that change the forward."""
        sd = {"g": self.g.state_dict(), "d": self.d.state_dict(),
              "g_opt": self.g_opt.opt.state_dict(), "d_opt": self.d_opt.opt.state_dict(),
              "step": self.step,
              "meta": {"version": self.FORMAT_VERSION, "bicubic_skip": int(self.bicubic_skip),
                       "scale": self.scale, "n_priors": self.n_priors}}
        if self.g_ema is not None:
            sd["g_ema"] = self.g_ema.state_dict()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        meta = sd.get("meta")
        if meta is None:
            raise ValueError("not an SR checkpoint of format v2 (no meta record)")
        skip = bool(meta["bicubic_skip"])
        if skip != self.bicubic_skip:
            raise ValueError(
                f"SR checkpoint was trained with bicubic_skip={skip} but "
                f"this trainer was built with {self.bicubic_skip} — the "
                f"forward would silently change. Rebuild with "
                f"SRTrainer(..., bicubic_skip={skip}) / "
                f"--sr-bicubic-skip={'1' if skip else '0'}.")
        ck_scale = int(meta["scale"])
        if ck_scale != self.scale:
            raise ValueError(f"SR checkpoint scale {ck_scale} != trainer scale {self.scale}")
        self.g.load_state_dict(sd["g"])
        self.d.load_state_dict(sd["d"])
        self.g_opt.opt.load_state_dict(sd["g_opt"])
        self.d_opt.opt.load_state_dict(sd["d_opt"])
        if self.g_ema is not None:
            self.g_ema.load_state_dict(sd.get("g_ema", sd["g"]))
        self.step = int(sd["step"])

    def restore_from(self, ck, step: int | None = None) -> None:
        """Load the checkpoint of ``ck`` (a ``train.checkpoints.Checkpointer``)
        at ``step``, the latest when None; without ``g_ema`` the EMA
        starts from G."""
        self.load_state_dict(ck.restore(step=step))

    # ------------------------------------------------------------------
    def _serve_module(self, ema: bool = True) -> Hallucinator:
        return self.g_ema if (ema and self.g_ema is not None) else self.g

    def generator(self, ema: bool = True) -> Hallucinator:
        """A snapshot of the generator (EMA weights by default), in eval mode."""
        return frozen_copy(self._serve_module(ema))

    def sr_apply(self, trainable: bool = False, ema: bool = True) -> Callable:
        """A snapshot of the generator as the SR plug: normalized LR → normalized
        SR (``sr_apply_from_state``)."""
        return sr_apply_from_state(self._serve_module(ema), trainable=trainable)

    @torch.no_grad()
    def psnr_ssim(self, hr_images, ema: bool = True) -> dict[str, float]:
        """Degrade (one kernel launch) → hallucinate → PSNR and SSIM against
        the HR batch, means over the batch, with the live weights."""
        x = _as_pixels(hr_images, self.device)
        sr = _run_eval(self._serve_module(ema), self._down(x))[0]
        a = denormalize(sr).clamp(0, 255)
        b = denormalize(normalize(x)).clamp(0, 255)
        return {"psnr": float(psnr(a, b).mean()), "ssim": float(ssim(a, b).mean())}

    def sr_fn(self, ema: bool = True) -> Callable:
        """Raw LR pixels (B, s, s, 3) → SR pixels in [0, 255], reading the
        trainer's live generator at every call."""
        @torch.no_grad()
        def f(lr_images) -> torch.Tensor:
            lr = normalize(_as_pixels(lr_images, self.device))
            sr = _run_eval(self._serve_module(ema), lr)[0]
            return denormalize(sr).clamp(0.0, 255.0)

        return f


# ---------------------------------------------------------------------------
# Frozen plugs: SR output into recognition
# ---------------------------------------------------------------------------


def perceptual_from_trainer(trainer) -> Callable:
    """A snapshot of a recognition ``Trainer``'s backbone as the perceptual
    callable: normalized pixels → its stage feature maps (NHWC), in the
    trainer's compute dtype. The output stays differentiable in the input,
    so G's gradient flows through it; the backbone's own parameters take
    none."""
    bb = frozen_copy(trainer.model.backbone)
    dt = trainer.compute_dtype

    def f(x: torch.Tensor) -> list[torch.Tensor]:
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=dt == torch.bfloat16):
            return list(bb.features(x))

    return f


def sr_apply_from_state(generator: Hallucinator, trainable: bool = False) -> Callable:
    """A snapshot of ``generator`` in eval mode: normalized LR pixels (B, s,
    s, 3) → normalized SR pixels (B, s·scale, s·scale, 3). With
    ``trainable`` the output keeps its graph to the input (a consumer's
    gradient flows through G to the LR pixels); G's own parameters take no
    gradient either way."""
    g = frozen_copy(generator)

    def f(lr_norm: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(trainable and torch.is_grad_enabled()):
            return g(lr_norm)[0]

    f.module = g              # the snapshot itself, for serve.export_embed
    return f


def load_sr_apply(ckpt_dir: str, cfg: Config, scale: int = 8, n_priors: int = 16,
                  trainable: bool = False, ema: bool = True, bicubic_skip: bool = True,
                  device=None) -> Callable:
    """Restore a trained Hallucinator from an SR checkpoint directory into
    the SR plug. ``scale``, ``n_priors`` and ``bicubic_skip`` must match the
    checkpoint's (its meta record is checked)."""
    from crfr_torch.train.checkpoints import Checkpointer

    tr = SRTrainer(cfg, scale=scale, n_priors=n_priors, bicubic_skip=bicubic_skip,
                   device=device)
    tr.restore_from(Checkpointer(ckpt_dir, keep=1))
    return tr.sr_apply(trainable=trainable, ema=ema)

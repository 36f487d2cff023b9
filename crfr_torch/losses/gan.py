"""SR / hallucination losses (crfr/losses/gan.py): pixel, adversarial
(LSGAN, or BCE on logits), identity on L2-normalised teacher embeddings,
recognition-feature perceptual, and prior consistency. Every loss is a
float32 scalar; the target side of each comparison is detached."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_loss(sr: torch.Tensor, hr: torch.Tensor, kind: str = "l2") -> torch.Tensor:
    d = sr.float() - hr.float()
    if kind == "l1":
        return d.abs().mean()
    return d.square().mean()


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def adversarial_g_loss(fake_logits: torch.Tensor, mode: str = "lsgan") -> torch.Tensor:
    f = fake_logits.float()
    if mode == "lsgan":
        return (f - 1.0).square().mean()
    return _bce(f, 1.0)


def adversarial_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                       mode: str = "lsgan") -> torch.Tensor:
    r, f = real_logits.float(), fake_logits.float()
    if mode == "lsgan":
        return 0.5 * ((r - 1.0).square().mean() + f.square().mean())
    return 0.5 * (_bce(r, 1.0) + _bce(f, 0.0))


def identity_loss(emb_sr: torch.Tensor, emb_hr: torch.Tensor) -> torch.Tensor:
    """‖T(sr) − T(hr)‖² on L2-normalised embeddings, the HR side detached."""
    a = F.normalize(emb_sr.float(), dim=-1, eps=1e-12)
    b = F.normalize(emb_hr.detach().float(), dim=-1, eps=1e-12)
    return (a - b).square().sum(dim=-1).mean()


def perceptual_loss(feats_sr: list, feats_hr: list) -> torch.Tensor:
    """Mean over levels of the L1 gap between SR and HR feature maps, each
    level divided by its HR map's mean magnitude."""
    total = 0.0
    for a, b in zip(feats_sr, feats_hr):
        b = b.detach().float()
        total = total + (a.float() - b).abs().mean() / (b.abs().mean() + 1e-6)
    return total / max(len(feats_sr), 1)


def prior_loss(pred_priors: torch.Tensor, target_priors: torch.Tensor) -> torch.Tensor:
    """MSE between predicted priors and (detached) targets."""
    return (pred_priors.float() - target_priors.detach().float()).square().mean()

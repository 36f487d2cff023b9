"""Residual knowledge distillation's loss (crfr/losses/distill.py).

The frozen HR teacher gives a target embedding t; the LR student gives s and
its residual branch r; training pushes s + r toward t beside the ArcFace CE
on s:

    L = CE(ArcFace(s, y)) + λ · ‖(s + r) − t‖²

in float32. The teacher term is detached (the reference stop-gradients it).
"""

from __future__ import annotations

import torch


def feature_l2(a: torch.Tensor, b: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Mean over the batch of the squared L2 distance between (B, D) rows,
    in float32; ``normalize`` first scales each row to unit norm (norms
    clipped at 1e-12)."""
    a, b = a.float(), b.float()
    if normalize:
        a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(1e-12)
        b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(1e-12)
    return (a - b).square().sum(dim=-1).mean()


def residual_kd_loss(student_emb: torch.Tensor, residual_emb, teacher_emb: torch.Tensor,
                     weight: float = 1.0, normalize: bool = False) -> torch.Tensor:
    """λ · ‖(s + r) − t‖² with the teacher's embedding detached."""
    return weight * feature_l2(student_emb + residual_emb, teacher_emb.detach(),
                               normalize=normalize)

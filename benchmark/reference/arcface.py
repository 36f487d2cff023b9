"""ArcFace's margin-softmax cross-entropy (arXiv:1801.07698, eq. 3) in plain
float32 PyTorch, over blocks of classes.

With the embedding and W's columns normalised, the target class's logit is
s * cos(theta_y + m) and every other class's s * cos(theta_j). Where
theta_y + m would pass pi the target logit falls back to
s * (cos(theta_y) - m * sin(m)) (insightface's rule), so the logit keeps
falling as the angle grows. The log-sum-exp is taken block by block and the
blocks' results combined, so no (B, C) array is ever whole.
"""

from __future__ import annotations

import math

import torch


def _normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True) + 1e-12)


def target_logit(cos: torch.Tensor, s: float, m: float) -> torch.Tensor:
    cos = cos.clamp(-1.0, 1.0)
    sin = torch.sqrt((1.0 - cos * cos).clamp(0.0, 1.0))
    phi = cos * math.cos(m) - sin * math.sin(m)
    return s * torch.where(cos > math.cos(math.pi - m), phi, cos - m * math.sin(m))


def arcface_ce(emb: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *, s: float,
               m: float, block: int = 8192, rows: slice | None = None,
               batch: int | None = None) -> torch.Tensor:
    """The mean CE over the batch. emb (B, D), W (D, C), labels (B,).

    ``rows`` takes only those rows' losses, summed over ``batch`` (default:
    their count) in place of the mean: a share of a larger batch's mean."""
    e = _normalize(emb, 1)
    wn = _normalize(w, 0)
    if rows is not None:
        e, labels = e[rows], labels[rows]
    b = e.shape[0]
    labels = labels.long()
    r = torch.arange(b, device=e.device)
    tgt = target_logit((e * wn[:, labels].t()).sum(1), s, m)
    parts = []
    for lo in range(0, wn.shape[1], block):
        logits = s * (e @ wn[:, lo:lo + block]).clamp(-1.0, 1.0)
        inside = (labels >= lo) & (labels < lo + logits.shape[1])
        if bool(inside.any()):
            logits = logits.index_put((r[inside], labels[inside] - lo), tgt[inside])
        parts.append(torch.logsumexp(logits, dim=1))
    lse = torch.logsumexp(torch.stack(parts, 1), dim=1)
    return (lse - tgt).sum() / (batch if batch is not None else b)

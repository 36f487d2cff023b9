"""Margin-softmax heads (ArcFace et al.) in PyTorch (crfr/losses/arcface.py).

W ∈ ℝ^{D×C}: logits s·cos(θ_y + m) on the target class, s·cosθ elsewhere,
softmax cross-entropy. Margin families: arcface (additive angle), cosface
(additive cosine), sphereface (multiplicative angle), normsoftmax.

All margin trigonometry runs in true float32: the cosines are a float32
product with TF32 off and outside any autocast region (``cosine_logits``),
as the reference computes them at ``Precision.HIGHEST``, with the θ+m>π
guard (fallback cosθ − m·sin m, or the easy-margin variant).

``streaming_margin_ce`` computes the same loss over class blocks with a
running (max, sum-exp, target logit) per example, so the (B, C) logits are
never held whole in the forward pass. ``sharded_margin_ce`` is the
class-sharded (PartialFC) CE over a mesh's ``model`` axis, one process per
device: the (B, C) logits are never held whole on any rank.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn


@contextlib.contextmanager
def true_f32(device: torch.device):
    """float32 products on ``device`` in full float32: no autocast, no TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def cosine_logits(emb: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cosθ = ê · Ŵ in float32. emb (B, D); weight (D, C) → (B, C)."""
    with true_f32(emb.device):
        e = _l2_normalize(emb.float())
        w = _l2_normalize(weight.float(), dim=0)
        return e @ w


def _apply_margin(cos: torch.Tensor, is_target: torch.Tensor, *, margin_type: str,
                  m: float, easy_margin: bool) -> torch.Tensor:
    """Rewrite target-class cosines per margin family. cos is f32 in [-1, 1]."""
    cos = cos.clamp(-1.0, 1.0)
    if margin_type == "normsoftmax" or m == 0.0:
        return cos
    if margin_type == "arcface":
        sin = torch.sqrt((1.0 - cos * cos).clamp(0.0, 1.0))
        phi = cos * math.cos(m) - sin * math.sin(m)                    # cos(θ+m)
        if easy_margin:
            phi = torch.where(cos > 0, phi, cos)
        else:
            # θ+m > π would make the logit non-monotone; linear fallback
            phi = torch.where(cos > math.cos(math.pi - m), phi, cos - m * math.sin(m))
        return torch.where(is_target, phi, cos)
    if margin_type == "cosface":
        return torch.where(is_target, cos - m, cos)
    if margin_type == "sphereface":
        theta = torch.arccos(cos.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
        k = torch.floor(theta * m / math.pi)
        phi = torch.cos(m * theta) * torch.pow(-1.0, k) - 2.0 * k
        return torch.where(is_target, phi, cos)
    raise ValueError(f"unknown margin_type {margin_type!r}")


def _one_hot(labels: torch.Tensor, c: int) -> torch.Tensor:
    return labels.long()[:, None] == torch.arange(c, device=labels.device)


def margin_logits(emb: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor, *,
                  margin_type: str = "arcface", s: float = 64.0, m: float = 0.5,
                  easy_margin: bool = False, num_valid: int | None = None) -> torch.Tensor:
    """Dense margin logits (B, C), f32, scaled by s; classes ≥ ``num_valid``
    (padding) masked to −inf."""
    cos = cosine_logits(emb, weight)
    c = weight.shape[1]
    with true_f32(cos.device):
        phi = _apply_margin(cos, _one_hot(labels, c), margin_type=margin_type, m=m,
                            easy_margin=easy_margin)
        logits = phi * s
        if num_valid is not None and num_valid < c:
            valid = torch.arange(c, device=logits.device) < num_valid
            logits = torch.where(valid[None, :], logits, -math.inf)
    return logits


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, logsumexp form."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - tgt)


class MarginHead(nn.Module):
    """Holds W (D, C), drawn uniform in ±sqrt(6/(D+C)) (xavier-uniform) from
    ``generator``."""

    def __init__(self, embedding_dim: int, num_classes: int, *, margin_type: str = "arcface",
                 s: float = 64.0, m: float = 0.5, easy_margin: bool = False,
                 num_valid: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        scale = math.sqrt(6.0 / (embedding_dim + num_classes))
        w = torch.rand((embedding_dim, num_classes), generator=generator) * (2 * scale) - scale
        self.weight = nn.Parameter(w)
        self.margin_type = margin_type
        self.s = s
        self.m = m
        self.easy_margin = easy_margin
        self.num_valid = num_valid

    def forward(self, emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return margin_logits(emb, self.weight, labels, margin_type=self.margin_type, s=self.s,
                             m=self.m, easy_margin=self.easy_margin, num_valid=self.num_valid)

    def loss(self, emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with true_f32(emb.device):
            return softmax_ce(self(emb, labels), labels)


def streaming_margin_ce(emb: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor, *,
                        margin_type: str = "arcface", s: float = 64.0, m: float = 0.5,
                        easy_margin: bool = False, block: int = 8192,
                        num_valid: int | None = None) -> torch.Tensor:
    """Margin-softmax CE over class blocks of ``block``: a running max,
    sum-exp and target logit per example (the max without a gradient: it
    only offsets the exponent). Equal to the dense CE; the forward holds
    (B, block) logits at a time."""
    with true_f32(emb.device):
        e = _l2_normalize(emb.float())
        w = _l2_normalize(weight.float(), dim=0)
        c = w.shape[1]
        c_valid = num_valid if num_valid is not None else c
        labels = labels.long()
        b = e.shape[0]
        run_max = torch.full((b,), -math.inf, device=e.device)
        run_sum = torch.zeros((b,), device=e.device)
        tgt = torch.zeros((b,), device=e.device)
        for lo in range(0, c, block):
            hi = min(lo + block, c)
            cos = e @ w[:, lo:hi]                                     # (B, hi − lo)
            cols = torch.arange(lo, hi, device=e.device)
            one_hot = labels[:, None] == cols
            phi = _apply_margin(cos, one_hot, margin_type=margin_type, m=m,
                                easy_margin=easy_margin)
            valid = (cols < c_valid)[None, :]
            logits = torch.where(valid, phi * s, -math.inf)
            new_max = torch.maximum(run_max, logits.max(dim=1).values.detach())
            scale_old = torch.where(torch.isfinite(run_max), torch.exp(run_max - new_max),
                                    torch.zeros((), device=e.device))
            blk_sum = torch.where(valid, torch.exp(logits - new_max[:, None]),
                                  torch.zeros((), device=e.device)).sum(dim=1)
            run_sum = run_sum * scale_old + blk_sum
            tgt = tgt + torch.where(one_hot, phi * s, torch.zeros((), device=e.device)).sum(dim=1)
            run_max = new_max
        return torch.mean(run_max + torch.log(run_sum) - tgt)


def sharded_margin_ce(mesh, *, margin_type: str = "arcface", s: float = 64.0,
                      m: float = 0.5, easy_margin: bool = False,
                      num_valid: int | None = None):
    """The class-sharded CE over ``mesh``'s model axis (``crfr``'s
    ``sharded_margin_ce``): → ``loss_fn(emb, labels, weight)``.

    ``emb`` (b, D) and ``labels`` (b,) are this rank's rows of the batch
    (sharded over the whole mesh), ``weight`` (D, C/model) its class shard
    (shard m holds the global classes [m·C/model, (m+1)·C/model)). ``emb``
    is gathered over the model group, since ``crfr``'s in_spec is
    ``P('data', None)``; each rank computes the cosine logits against its
    columns, the margin only where a label falls in its shard, masks classes
    ≥ ``num_valid``, and the log-sum-exp reduces with a max all-reduce of
    the detached local max and sum all-reduces of the exp-sums and of the
    target logit. Every rank then holds the whole group's per-row loss;
    ``loss_fn`` returns this rank's share of the global mean, the sum of its
    own rows' losses over the global batch B = b·P. The shares sum to
    ``crfr``'s loss, and a backward on every rank (the collectives carry the
    gradient), with replicated gradients then summed over the world and W's
    over the data group, gives ``crfr``'s gradient."""
    from crfr_torch.parallel.mesh import all_gather_rows, all_reduce_max, all_reduce_sum, coords

    group = mesh.get_group("model")
    shard = coords(mesh)[1]
    world = mesh.size()

    def loss_fn(emb: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        b = emb.shape[0]
        e = all_gather_rows(emb, group)                       # the data block's rows
        y = all_gather_rows(labels.long(), group)
        c_local = weight.shape[1]
        offset = shard * c_local
        with true_f32(emb.device):
            cos = cosine_logits(e, weight)                    # (b·model, C/model) f32
            cols = torch.arange(c_local, device=e.device)
            one_hot = (y - offset)[:, None] == cols
            logits = _apply_margin(cos, one_hot, margin_type=margin_type, m=m,
                                   easy_margin=easy_margin) * s
            if num_valid is not None:
                logits = torch.where((offset + cols < num_valid)[None, :], logits, -math.inf)
            gmax = all_reduce_max(logits.max(dim=1).values, group)
            gsum = all_reduce_sum(torch.exp(logits - gmax[:, None]).sum(dim=1), group)
            zero = torch.zeros((), device=e.device)
            tgt = all_reduce_sum(torch.where(one_hot, logits, zero).sum(dim=1), group)
            per_row = gmax + torch.log(gsum) - tgt
            return per_row[shard * b:(shard + 1) * b].sum() / (b * world)

    return loss_fn

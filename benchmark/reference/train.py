"""The reference's forward passes and train steps, in float32 with TF32 off.

``embed`` is evaluation: degrade, normalize, the backbone with its running
statistics, in blocks of rows. ``train_steps`` follows the trainer's first
steps: each step degrades every image to its own low, runs the backbone in
training mode with the step's dropout mask, takes the ArcFace CE over the
classes in blocks, and applies the SGD update at the step's learning rate.

The dropout mask of step k is the trainer's documented draw: a uniform
float32 array of the (global) batch's (B, 512, S/16, S/16) shape from a
``torch.Generator`` on the device seeded with ((seed mod 2^32) << 32) | k,
kept where it is below 1 - p. It is a function of (seed, step) alone.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.arcface import arcface_ce
from benchmark.reference.bicubic import degrade_normalize
from benchmark.reference.irse import backbone_forward, decayed
from benchmark.reference.sgd import learning_rate, sgd_step


@contextlib.contextmanager
def full_fp32():
    """float32 products in float32: no TF32 in cuDNN or cuBLAS."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def dropout_keep(seed: int, step: int, shape: tuple[int, ...], p: float,
                 device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(((seed % (1 << 32)) << 32) | step)
    return torch.rand(shape, generator=gen, device=device) < 1.0 - p


@torch.no_grad()
def embed(weights: dict, stats: dict, images: torch.Tensor, low: int, cfg: dict,
          block: int = 256) -> torch.Tensor:
    """(N, S, S, 3) raw pixels → (N, D) float32 embeddings."""
    out = []
    with full_fp32():
        for lo in range(0, images.shape[0], block):
            x = degrade_normalize(images[lo:lo + block], low, cfg["resize_mode"])
            out.append(backbone_forward(weights, x, cfg["backbone"], stats=stats))
    return torch.cat(out)


def train_steps(weights: dict, batches, cfg: dict, seed: int, *, quant: str | None = None,
                rows: slice | None = None, share: bool = False, remat: bool = False) -> dict:
    """Run one step on each (images, labels, lows) of ``batches`` from
    ``weights`` (left as they are) → {"losses": [float], "grads": the first
    step's gradients by name, "params": the parameters after the last step}.

    ``rows`` trains on those rows of each batch alone, the loss their mean,
    or with ``share`` their sum over the whole batch's size (one rank's
    share with no exchange between ranks): the faults of a step that drops
    part of its batch."""
    p = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    bufs: dict = {}
    losses, first = [], None
    drop = cfg["dropout"]
    with full_fp32():
        for k, (images, labels, lows) in enumerate(batches):
            b = images.shape[0]
            x = degrade_normalize(images, lows, cfg["resize_mode"])
            feat = cfg["input_size"] // 16
            keep = dropout_keep(seed, k, (b, 512, feat, feat), drop, images.device)
            if rows is not None:
                x, labels, keep = x[rows], labels[rows], keep[rows]
            emb = backbone_forward(p, x, cfg["backbone"], keep=keep, drop=drop, quant=quant,
                                   remat=remat)
            loss = arcface_ce(emb, p["head.weight"], labels, s=cfg["scale"], m=cfg["margin"],
                              block=cfg["ce_block"],
                              batch=b if share else None)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: g.detach().clone() for n, g in grads.items()}
            lr = learning_rate(k, cfg["lr"], cfg["warmup_steps"])
            sgd_step(p, grads, bufs, lr, cfg["momentum"], cfg["weight_decay"], decayed)
            del grads, emb, loss, x
    return {"losses": losses, "grads": first, "params": {n: w.detach() for n, w in p.items()}}

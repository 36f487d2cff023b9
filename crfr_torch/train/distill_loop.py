"""Frozen recognition teachers (crfr/train/distill_loop.py:59-75).

``teacher_from_state`` and ``teacher_from_trainer`` freeze a backbone into
a callable: normalized NHWC pixels → (B, D) f32 embeddings, in eval mode,
under ``torch.no_grad()`` and in the teacher's compute dtype. The
reference stop-gradients the teacher's output; running it without a graph
gives the same values and no gradient, with less memory. So in
``train-sr`` the identity term adds to the G loss's value and sends no
gradient to G, as in the reference.

The student trainer of this module (``DistillTrainer``, residual KD) is
not ported yet.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn


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

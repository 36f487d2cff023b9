"""Serving function: raw pixels → embeddings through the fused kernel
(``build_serving_fn`` of crfr/serve.py). The reference also exports the
function as an ahead-of-time artifact (``export_embed``/``load_embed``);
that is not ported yet."""

from __future__ import annotations

from typing import Callable

import torch

from crfr_torch.eval.extract import make_extract_fn


def build_serving_fn(backbone_apply: Callable, degrade_to: int | None = None,
                     resize_mode: str = "pil", flip_tta: bool = False,
                     image_size: int = 112, sr_apply: Callable | None = None,
                     device: str | torch.device = "cuda") -> Callable:
    """Raw (B, S, S, 3) pixels (uint8/f32, numpy or tensor) → (B, D) f32
    embeddings on ``device``: ``make_extract_fn`` with flip-TTA fused by sum.
    With ``sr_apply`` (a frozen hallucinator, ``train.sr_loop.load_sr_apply``)
    the probe goes ↓``degrade_to`` → G ↑ → backbone."""
    f = make_extract_fn(backbone_apply, degrade_to, resize_mode, flip=flip_tta,
                        flip_fusion="sum", image_size=image_size, sr_apply=sr_apply,
                        device=device)
    return lambda images: f(images).float()

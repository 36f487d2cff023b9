"""Embedding extraction: raw pixels → embeddings (crfr/eval/extract.py).

Optional fixed-size probe degradation (bicubic down to ``degrade_to`` and
back up), normalization, the backbone, and optional horizontal-flip TTA
with sum/concat fusion. Degrade + normalize is one launch of the fused
preprocessing kernel on CUDA (float32 out, as the reference's eval path
computes it in float32).
"""

from __future__ import annotations

from typing import Callable

import torch

from crfr_torch.device import resolve_device
from crfr_torch.ops.fused_preprocess import fused_degrade_normalize
from crfr_torch.ops.normalize import normalize


def make_extract_fn(backbone_apply: Callable, degrade_to: int | None = None,
                    resize_mode: str = "pil", flip: bool = True,
                    flip_fusion: str = "sum", image_size: int = 112,
                    state_fn: Callable | None = None,
                    sr_apply: Callable | None = None, mesh=None,
                    device: str | torch.device = "cuda") -> Callable:
    """Build ``fn(images) → (B, D) f32 embeddings`` on ``device``.

    ``images``: (B, S, S, 3) NHWC uint8 or float32, numpy or tensor, with
    S = ``image_size``. ``backbone_apply``: normalized NHWC pixels →
    embeddings, or ``backbone_apply(state, x)`` with ``state_fn() → state``
    to embed with the caller's current weights. Runs under
    ``torch.inference_mode``. ``sr_apply`` and ``mesh`` are not ported yet,
    nor is ``extract_embeddings`` (it needs the image-path input pipeline).
    """
    if sr_apply is not None:
        raise NotImplementedError("sr_apply (hallucinated probes) is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh (sharded extraction) is not ported yet")
    if flip_fusion not in ("sum", "concat"):
        raise ValueError(f"unknown flip fusion {flip_fusion!r}")
    dev = resolve_device(device)
    if state_fn is None:
        apply = lambda _s, x: backbone_apply(x)            # noqa: E731
        get_state = tuple
    else:
        apply = backbone_apply
        get_state = state_fn

    @torch.inference_mode()
    def f(images) -> torch.Tensor:
        x = torch.as_tensor(images).to(dev)
        if x.ndim != 4 or tuple(x.shape[1:]) != (image_size, image_size, 3):
            raise ValueError(f"expected (B, {image_size}, {image_size}, 3), "
                             f"got {tuple(x.shape)}")
        if degrade_to is not None:
            x = fused_degrade_normalize(x.contiguous(), degrade_to, resize_mode,
                                        out_dtype=torch.float32)
        else:
            x = normalize(x)
        state = get_state()
        emb = apply(state, x)
        if flip:
            emb_f = apply(state, x.flip(dims=[2]))           # NHWC width axis
            emb = emb + emb_f if flip_fusion == "sum" else torch.cat([emb, emb_f], dim=-1)
        return emb

    return f


"""Embedding extraction: raw pixels → embeddings (crfr/eval/extract.py).

Optional fixed-size probe degradation (bicubic down to ``degrade_to`` and
back up), normalization, the backbone, and optional horizontal-flip TTA
with sum/concat fusion. Degrade + normalize is one launch of the fused
preprocessing kernel on CUDA (float32 out, as the reference's eval path
computes it in float32). With a hallucinator (``sr_apply``) the probe is
instead bicubic↓ to ``degrade_to`` and normalized in one launch of the
resize form of the kernel, then hallucinated back up by G.

``extract_embeddings`` runs such a function over image files, in batches
from the threaded loader (``data.pipeline.embed_batches``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from crfr_torch.device import mesh_world, resolve_device
from crfr_torch.ops.fused_preprocess import fused_degrade_normalize, fused_resize_normalize
from crfr_torch.ops.normalize import normalize
from crfr_torch.parallel.mesh import all_gather_rows, maybe_shard_batch
from crfr_torch.utils.profiling import annotate


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
    ``torch.inference_mode``.

    ``sr_apply`` (normalized LR → normalized HR pixels, e.g.
    ``train.sr_loop.load_sr_apply``) routes the probe through the
    hallucinator: bicubic↓ to ``degrade_to`` → G ↑ → backbone, in place of
    the bicubic down→up degradation; it needs ``degrade_to``.

    ``mesh`` of more than one device (``parallel.mesh``): a batch that
    divides the process group's size is split, each rank embedding its
    rows (one preprocessing launch on its slice) and an all-gather
    rebuilding the batch on every rank; another batch is embedded whole on
    every rank, as ``crfr`` replicates it.

    While a profiler runs, each call is the span ``embed.call`` (rows: the
    batch; device-timed) over the ``detail`` spans ``embed.preprocess`` and
    ``embed.backbone`` (``utils.profiling``).
    """
    if sr_apply is not None and degrade_to is None:
        raise ValueError("sr_apply needs degrade_to (the LR size)")
    world = mesh_world(mesh)
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
        if not hasattr(images, "shape"):
            images = np.asarray(images)
        shape = tuple(images.shape)
        if len(shape) != 4 or shape[1:] != (image_size, image_size, 3):
            raise ValueError(f"expected (B, {image_size}, {image_size}, 3), got {shape}")
        with annotate("embed.call", dev, rows=shape[0]):
            split = False
            if world > 1:
                images, split = maybe_shard_batch(mesh, images)
            emb = embed(torch.as_tensor(images).to(dev))
            return all_gather_rows(emb, None) if split else emb

    def embed(x: torch.Tensor) -> torch.Tensor:
        with annotate("embed.preprocess", dev, detail=True):
            if sr_apply is not None:
                x = fused_resize_normalize(x.contiguous(), (degrade_to, degrade_to),
                                           resize_mode, out_dtype=torch.float32)
            elif degrade_to is not None:
                x = fused_degrade_normalize(x.contiguous(), degrade_to, resize_mode,
                                            out_dtype=torch.float32)
            else:
                x = normalize(x)
        if sr_apply is not None:
            x = sr_apply(x)
        with annotate("embed.backbone", dev, detail=True):
            state = get_state()
            emb = apply(state, x)
            if flip:
                emb_f = apply(state, x.flip(dims=[2]))           # NHWC width axis
                emb = emb + emb_f if flip_fusion == "sum" else torch.cat([emb, emb_f], dim=-1)
        return emb

    return f


def _host(emb) -> np.ndarray:
    return torch.as_tensor(emb).float().cpu().numpy()


def extract_embeddings(paths: Sequence[str], extract_fn: Callable, batch_size: int = 256,
                       image_size: int = 112) -> np.ndarray:
    """``extract_fn`` over the images at ``paths`` → (N, D) float32.

    The batch is ``min(batch_size, N rounded up to 8)``: a small set is not
    padded to the full serving batch. Double-buffered: batch i+1 is
    dispatched (and decoded on the loader's threads) before batch i's
    result is copied to the host, so the device's work, the host's decode
    and the copies overlap."""
    from crfr_torch.data.pipeline import embed_batches

    batch_size = min(batch_size, max(-(-len(paths) // 8) * 8, 8))
    outs = []
    pending = None                      # (device embeddings, n_valid)
    for imgs, n_valid in embed_batches(paths, batch_size, image_size):
        emb = extract_fn(imgs)          # queued on the device
        if pending is not None:
            outs.append(_host(pending[0])[:pending[1]])
        pending = (emb, n_valid)
    if pending is not None:
        outs.append(_host(pending[0])[:pending[1]])
    return np.concatenate(outs) if outs else np.zeros((0, 0), np.float32)

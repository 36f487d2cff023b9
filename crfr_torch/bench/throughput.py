"""Embedding-extraction throughput on the CUDA device (the embed half of
crfr/bench/throughput.py).

The hot path: raw uint8 (B, 112, 112, 3) → 112→16→112 bicubic probe
degradation + (x − 127.5)/128 + bf16 cast in one launch of the fused
preprocessing kernel (its NHWC output is the channels_last input the
backbone takes) → IR-50 in bf16 → (B, 512) f32.

The reference's bench pipeline rounds the degrade operator and the pixels
to bf16 before its einsum; here the kernel computes the degrade in float32
and casts only its output, as the reference's Pallas kernel does.

Timing: ``steps`` calls queued back to back, one ``torch.cuda.synchronize``
fence at the end; warmup excluded; the best of ``repeats``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from crfr_torch.device import resolve_device
from crfr_torch.models.irse import build_backbone
from crfr_torch.ops.fused_preprocess import fused_degrade_normalize


@dataclass
class BenchResult:
    imgs_per_sec: float
    batch: int
    steps: int
    compile_seconds: float               # first call: cuDNN autotune, build
    per_batch_ms: float
    device: str


def build_embed_pipeline(backbone_name: str = "ir_50", degrade_to: int = 16,
                         image_size: int = 112, mode: str = "pil",
                         dtype: torch.dtype = torch.bfloat16, int8: bool = False,
                         device: str | torch.device = "cuda", seed: int = 0):
    """→ fn(raw uint8/f32 NHWC batch) → (B, 512) f32 embeddings, with the
    backbone's weights drawn from ``seed``. ``int8`` (the PTQ backbone) is
    not ported yet."""
    if int8:
        raise NotImplementedError("int8 (PTQ backbone) is not ported yet")
    dev = resolve_device(device)
    model = build_backbone(backbone_name, input_size=image_size, dtype=dtype,
                           generator=torch.Generator().manual_seed(seed))
    model = model.to(dev).eval()

    @torch.inference_mode()
    def embed(x: torch.Tensor) -> torch.Tensor:
        x = fused_degrade_normalize(x.to(dev).contiguous(), degrade_to, mode,
                                    out_dtype=dtype)
        return model(x)

    return embed


def run_throughput(batch: int = 256, steps: int = 30, repeats: int = 3,
                   backbone: str = "ir_50", degrade_to: int = 16,
                   image_size: int = 112, int8: bool = False,
                   device: str | torch.device = "cuda", seed: int = 0) -> BenchResult:
    dev = resolve_device(device)
    embed = build_embed_pipeline(backbone, degrade_to, image_size, int8=int8,
                                 device=dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (batch, image_size, image_size, 3),
                      generator=g, device=dev, dtype=torch.uint8)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    embed(x)
    fence()
    compile_s = time.perf_counter() - t0
    best = 0.0
    for _ in range(repeats):
        embed(x)                                     # re-warm + settle
        fence()
        t0 = time.perf_counter()
        for _ in range(steps):
            embed(x)
        fence()
        best = max(best, batch * steps / (time.perf_counter() - t0))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return BenchResult(imgs_per_sec=best, batch=batch, steps=steps,
                       compile_seconds=compile_s, per_batch_ms=1e3 * batch / best,
                       device=name)

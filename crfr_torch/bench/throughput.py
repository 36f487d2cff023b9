"""Throughput on the CUDA device (crfr/bench/throughput.py): embedding
extraction (``run_throughput``) and training (``run_train_throughput``, the
step on a batch already on the device; ``run_fit_throughput``, the user's
loop ``Trainer.fit`` on host batches).

The hot path: raw uint8 (B, 112, 112, 3) → 112→16→112 bicubic probe
degradation + (x − 127.5)/128 + bf16 cast in one launch of the fused
preprocessing kernel (its NHWC output is the channels_last input the
backbone takes) → IR-50 in bf16 → (B, 512) f32.

The reference's bench pipeline rounds the degrade operator and the pixels
to bf16 before its einsum; here the kernel computes the degrade in float32
and casts only its output, as the reference's Pallas kernel does.

``int8=True`` swaps the backbone for its int8 twin (``models.quant``): the
same launch of the preprocessing kernel, then IR-50 with s8 convolutions
(a patch gather and ``torch._int_mm``) and bf16 around them.

Timing: ``steps`` calls queued back to back, one ``torch.cuda.synchronize``
fence at the end; warmup excluded. Embedding reports the best of
``repeats`` windows; training reports the images of all its windows over
their total time, so a stall in any window shows, with each window's rate
beside it for the spread.

A train step: raw uint8 batch → one launch of the preprocessing kernel
(each image degraded to its own random low in [degrade_min, degrade_max],
normalized, cast to bf16) → IR backbone forward and backward under bf16
autocast → ArcFace CE in float32 → clip/decay/SGD (``train.loop.Trainer``).
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


@dataclass
class TrainBenchResult:
    imgs_per_sec: float                  # all windows' images over their total time
    imgs_per_sec_windows: list[float]    # each window of ``steps`` steps
    batch: int
    steps: int
    first_step_seconds: float            # cuDNN autotune, kernel build, first step
    ms_per_step: float
    peak_bytes: int                      # torch.cuda.max_memory_allocated over the steps
    device: str


def train_config(backbone: str = "ir_50", num_classes: int = 10572, image_size: int = 112,
                 batch: int = 256):
    """The casia_arcface preset with these sizes and no warmup (the
    reference bench's config: warmup 0, logging off)."""
    from crfr_torch.configs import get_config

    return get_config("casia_arcface", [
        f"model.backbone={backbone}", f"data.num_classes={num_classes}",
        f"data.image_size={image_size}", f"model.input_size={image_size}",
        f"train.batch_size={batch}", "train.warmup_steps=0", f"train.log_every={10 ** 9}"])


def _fence(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_train_throughput(batch: int = 256, steps: int = 10, repeats: int = 3,
                         backbone: str = "ir_50", num_classes: int = 10572,
                         image_size: int = 112, device: str | torch.device = "cuda",
                         seed: int = 0, cfg=None) -> TrainBenchResult:
    """Train steps on one device-resident batch of seeded random uint8
    images and labels: the step alone (degrade, forward, backward, SGD),
    without the host feed. ``cfg`` replaces the config built from the
    sizes."""
    from crfr_torch.train.loop import Trainer

    dev = resolve_device(device)
    cfg = cfg or train_config(backbone, num_classes, image_size, batch)
    batch, size = cfg.train.batch_size, cfg.data.image_size
    tr = Trainer(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (batch, size, size, 3), generator=g, device=dev, dtype=torch.uint8)
    y = torch.randint(0, cfg.data.num_classes, (batch,), generator=g, device=dev)
    t0 = time.perf_counter()
    tr.train_step(x, y)
    _fence(dev)
    first = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seconds = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            m = tr.train_step(x, y)
        _fence(dev)
        seconds.append(time.perf_counter() - t0)
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        raise AssertionError(f"train step: loss {m['loss']}, grad norm {m['grad_norm']}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ips = batch * steps * repeats / sum(seconds)
    return TrainBenchResult(imgs_per_sec=ips,
                            imgs_per_sec_windows=[batch * steps / s for s in seconds],
                            batch=batch, steps=steps, first_step_seconds=first,
                            ms_per_step=1e3 * batch / ips, peak_bytes=peak, device=_name(dev))


def run_fit_throughput(batch: int = 256, steps: int = 20, backbone: str = "ir_50",
                       num_classes: int = 10572, image_size: int = 112,
                       device: str | torch.device = "cuda", seed: int = 0,
                       cfg=None) -> TrainBenchResult:
    """``Trainer.fit`` on host uint8 batches (fed by ``train.feed``): what
    a user's loop reaches, to set beside ``run_train_throughput``."""
    import numpy as np

    from crfr_torch.train.loop import Trainer

    dev = resolve_device(device)
    cfg = cfg or train_config(backbone, num_classes, image_size, batch)
    batch, size = cfg.train.batch_size, cfg.data.image_size
    tr = Trainer(cfg, device=dev)
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (batch, size, size, 3)).astype(np.uint8)
    labels = rng.integers(0, cfg.data.num_classes, batch).astype(np.int32)

    def batches(n):
        for _ in range(n):
            yield imgs, labels

    t0 = time.perf_counter()
    tr.fit(batches(2), max_steps=2)
    _fence(dev)
    first = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr.fit(batches(steps), max_steps=steps)
    _fence(dev)
    ips = batch * steps / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return TrainBenchResult(imgs_per_sec=ips, imgs_per_sec_windows=[ips], batch=batch,
                            steps=steps, first_step_seconds=first, ms_per_step=1e3 * batch / ips,
                            peak_bytes=peak, device=_name(dev))


def build_embed_pipeline(backbone_name: str = "ir_50", degrade_to: int = 16,
                         image_size: int = 112, mode: str = "pil",
                         dtype: torch.dtype = torch.bfloat16, int8: bool = False,
                         device: str | torch.device = "cuda", seed: int = 0):
    """→ fn(raw uint8/f32 NHWC batch) → (B, 512) f32 embeddings, with the
    backbone's weights drawn from ``seed``.

    ``int8`` swaps the conv stack for the PTQ path (``models.quant``):
    quantized from the float32 weights, calibrated on two batches of 32
    seeded noise images (``default_rng(0)``) through the plain bicubic
    down-up operator and normalization, as the reference calibrates (the
    scales move accuracy, not speed), computing in ``dtype`` around its
    s8 convolutions."""
    dev = resolve_device(device)
    model = build_backbone(backbone_name, input_size=image_size,
                           dtype=torch.float32 if int8 else dtype,
                           generator=torch.Generator().manual_seed(seed))
    model = model.to(dev).eval()
    if int8:
        import numpy as np

        from crfr_torch.models.quant import calibration_batch, quantize_backbone

        rng = np.random.default_rng(0)
        calib = [calibration_batch(rng.integers(0, 256, (32, image_size, image_size, 3)),
                                   degrade_to, mode, dev) for _ in range(2)]
        model = quantize_backbone(model, calib, compute_dtype=dtype)

    @torch.inference_mode()
    def embed(x: torch.Tensor) -> torch.Tensor:
        x = fused_degrade_normalize(x.to(dev).contiguous(), degrade_to, mode,
                                    out_dtype=dtype)
        return model(x)

    embed.model = model
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

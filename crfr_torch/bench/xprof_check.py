"""Where the device time goes: ``trace_embed`` and ``trace_train`` of
crfr/bench/xprof_check.py, with torch.profiler in place of jax.profiler, and
``trace_gallery`` for the int8 gallery scan.

    python -m crfr_torch.bench.xprof_check [--batch 256] [--steps 10]
    python -m crfr_torch.bench.xprof_check --path embed_int8 [--batch 256] [--steps 10]
    python -m crfr_torch.bench.xprof_check --path gallery [--batch 256]
    python -m crfr_torch.bench.xprof_check --path train [--batch 512] [--steps 5]
    python -m crfr_torch.bench.xprof_check --path sr [--batch 256] [--steps 5]
    python -m crfr_torch.bench.xprof_check --path distill [--batch 512] [--steps 5]

``embed`` runs ``steps`` back-to-back calls of the bf16 embed pipeline
(``bench.throughput.build_embed_pipeline``); ``embed_int8`` the same with
the int8 backbone (``models.quant``), its conv kernels grouped by the
profiler ranges that ``QuantConv`` opens while a profiler runs (the
quantize, the patch gather, the ``torch._int_mm`` GEMM, the float
epilogue), the rest by name (the preprocessing kernel, BN, PReLU, the
head's GEMM, other elementwise work); ``gallery`` runs ``steps``
256-probe top-10 scans of a 2^20 x 512 int8 bank on each path, the fused
three-phase top-k (``ops.bank_scan.bank_topk_fused``, the CUDA default) and
the scan (``eval.bank.streaming_topk_q``); ``train`` runs ``steps`` train
steps of the casia_arcface preset (``bench.throughput.train_config``) on a
device-resident batch, and splits the step's kernels into its own groups
(convolutions forward and backward, BN, elementwise, the head's GEMMs, the
CE, the optimizer, the preprocessing); ``sr`` runs ``steps`` SR GAN steps
(``train.sr_loop.SRTrainer``, the casia_arcface preset at scale 8 with 16
priors, float32) on a device-resident batch, with the train groups plus the
hourglass's pooling and upsampling and the peak of allocated memory;
``distill`` runs ``steps`` residual-KD steps of a student on the bicubic
path (``train.distill_loop.DistillTrainer``, the casia_arcface preset with
``loss.distill_weight`` 1 and an IR-50 teacher at init) with the train
groups and the peak of allocated memory. Each
runs on one CUDA card, once
untraced and once under the profiler, warmup outside both, and prints one
JSON line: wall ms per call (untraced and traced), device busy ms per call
(the union of kernel intervals in the trace), the idle share of the traced
window, device time per call by kernel group, and the heaviest kernels by
name. Kernels are read from the profiler's Chrome trace (events of category
``kernel``); a trace with none raises. ``embed`` and ``embed_int8`` also
print the batch's roofline bound (``bench.roofline.ir_layer_bounds``) and
its attainment (bound over wall time); ``train`` prints crfr's roofline
keys (``fwd_conv_bound_ms``, ``train_conv_bound_3x_fwd_ms``,
``conv_over_3x_bound``, ``dispatch_gap_ms``) and each group's bound from
``bench.roofline.train_step_bounds`` beside its time over it
(``train_roofline``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from crfr_torch.bench.roofline import (group_bounds, ir_layer_bounds, summarize,
                                       train_step_bounds)
from crfr_torch.bench.throughput import build_embed_pipeline
from crfr_torch.device import resolve_device
from crfr_torch.utils.profiling import union_length as _busy_us

# kernel group ← substrings of the kernel's name, tried in this order
_GROUPS = (
    ("preprocess", ("resample_normalize",)),
    ("bank_tilemax", ("bank_tilemax",)),
    ("sort", ("sort",)),
    ("gather", ("gather", "index")),
    ("conv", ("conv", "fprop", "implicit", "dgrad", "wgrad")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_")),
    ("gemm", ("gemm", "gemv")),
    ("elementwise", ("elementwise", "vectorized", "reduce")),
)


# a train step's groups: the conv passes by direction, BN forward and
# backward, PReLU forward and backward, the remaining reductions (PReLU's
# alpha gradients, the norms), the head's GEMMs, the CE's softmax, the
# optimizer's multi-tensor kernels, the preprocessing kernel
_TRAIN_GROUPS = (
    ("preprocess", ("resample_normalize", "degrade_lows")),
    ("optimizer", ("multi_tensor", "foreach", "multitensor")),
    ("conv_backward", ("dgrad", "wgrad", "bprop", "backward_data", "backward_filter")),
    ("conv_forward", ("conv", "fprop")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_")),
    ("prelu", ("prelu",)),
    ("head_gemm", ("gemm", "gemv", "cutlass")),
    ("ce", ("softmax", "logsumexp")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "where", "copy", "fill")),
)


# the int8 embed batch's groups outside QuantConv's ranges, and the groups
# of the ranges (a kernel takes its range's group when its launch lies in one)
_INT8_GROUPS = (
    ("preprocess", ("resample_normalize",)),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_")),
    ("prelu", ("prelu",)),
    ("gemm", ("gemm", "gemv", "cutlass")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "copy", "fill")),
)
_QUANT_SPANS = {"quant::quantize": "quantize", "quant::gather": "patch_gather",
                "quant::int_mm": "int_mm", "quant::epilogue": "epilogue"}


# an SR step's groups: the train step's, with the hourglass's pooling and
# nearest upsampling (and their backward passes) apart
_SR_GROUPS = (_TRAIN_GROUPS[0], ("pool", ("max_pool", "pooling")),
              ("upsample", ("upsample", "nearest")), *_TRAIN_GROUPS[1:])


def _group(name: str, groups=_GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _span_groups(events: list[dict], kernels: list[dict], span_groups: dict,
                 cat: str = "user_annotation") -> list:
    """Each kernel's group from the innermost range of category ``cat``
    (``user_annotation``: a ``record_function``; ``crfr_span``: the program's
    span log merged by ``utils.profiling.span_events``), named in
    ``span_groups``, around the runtime call that launched it, or None
    outside every such range. Ranges nest or are apart."""
    import bisect

    spans = sorted((e["ts"], e["ts"] + e["dur"], span_groups[e["name"]]) for e in events
                   if e.get("cat") == cat and e.get("name") in span_groups)
    starts = [sp[0] for sp in spans]
    up, open_ = [], []                  # each range's enclosing range (-1: none)
    for i, (s, _, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] < s:
            open_.pop()
        up.append(open_[-1] if open_ else -1)
        open_.append(i)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = []
    for k in kernels:
        ts = launched.get(k.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        while i >= 0 and ts > spans[i][1]:
            i = up[i]
        out.append(spans[i][2] if i >= 0 else None)
    return out


def _profile(call, steps: int, dev: torch.device, top: int, groups=_GROUPS,
             span_groups: dict | None = None) -> dict:
    """Untraced and traced windows of ``steps`` calls, warmup outside both.
    With ``span_groups`` a kernel launched inside one of those profiler
    ranges takes the range's group."""
    def window() -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0) / steps

    for _ in range(3):
        call()
    untraced_ms = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = window()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernels on the device")

    by_name: dict[str, list[float]] = {}
    by_group: dict[str, float] = {}
    spanned = (_span_groups(events, kernels, span_groups) if span_groups
               else [None] * len(kernels))
    for e, sg in zip(kernels, spanned):
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
        g = sg or _group(e["name"], groups)
        by_group[g] = by_group.get(g, 0.0) + e["dur"]
    busy_ms = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels]) / 1e3 / steps
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": untraced_ms,
        "traced_wall_ms": traced_ms,
        "device_busy_ms": busy_ms,
        "idle_share_traced": 1.0 - busy_ms / traced_ms,
        "kernel_launches": len(kernels) / steps,
        "group_ms": {k: v / 1e3 / steps for k, v in
                     sorted(by_group.items(), key=lambda kv: -kv[1])},
        "heaviest": [{"name": n[:120], "ms": t / 1e3 / steps, "calls": c / steps}
                     for n, (t, c) in heaviest],
    }


def _cuda(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the traces measure the CUDA device")
    return dev


def trace_embed(batch: int = 256, steps: int = 10, backbone: str = "ir_50",
                degrade_to: int = 16, image_size: int = 112, top: int = 12,
                device: str | torch.device = "cuda", seed: int = 0,
                int8: bool = False) -> dict:
    """One embed batch per call; keys per batch, as crfr's trace names them.
    ``int8``: the int8 backbone, its conv work grouped by QuantConv's
    profiler ranges."""
    dev = _cuda(device)
    embed = build_embed_pipeline(backbone, degrade_to, image_size, int8=int8, device=dev,
                                 seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (batch, image_size, image_size, 3), generator=g,
                      device=dev, dtype=torch.uint8)
    r = (_profile(lambda: embed(x), steps, dev, top, _INT8_GROUPS, _QUANT_SPANS) if int8
         else _profile(lambda: embed(x), steps, dev, top))
    # the IR batch's bound; its int8 form at one byte an element and the int8 peak
    bound_ms = (1e3 * summarize(ir_layer_bounds(_depth(backbone), batch, image_size,
                                                dtype="int8" if int8 else "bfloat16")).bound_s
                if backbone.startswith("ir_") else None)
    return {
        "backbone": backbone, "batch": batch, "steps": steps, "degrade_to": degrade_to,
        "int8": int8, "card": _card(),
        "wall_ms_per_batch": r["wall_ms"],
        "roofline_bound_ms": bound_ms,
        "attainment": bound_ms / r["wall_ms"] if bound_ms else None,
        "traced_wall_ms_per_batch": r["traced_wall_ms"],
        "device_busy_ms_per_batch": r["device_busy_ms"],
        "idle_share_traced": r["idle_share_traced"],
        "kernel_launches_per_batch": r["kernel_launches"],
        "group_ms_per_batch": r["group_ms"],
        "heaviest": [{"name": h["name"], "ms_per_batch": h["ms"],
                      "calls_per_batch": h["calls"]} for h in r["heaviest"]],
    }


def trace_gallery(probes: int = 256, rows: int = 1 << 20, dim: int = 512, k: int = 10,
                  steps: int = 10, top: int = 8, device: str | torch.device = "cuda",
                  seed: int = 0) -> dict:
    """One ``probes``-probe top-k scan of a ``rows`` x ``dim`` int8 bank per
    call, on the fused path and on the scan. The bank is quantized on the
    card with the probe recipe, which is the host bank recipe's twin."""
    from crfr_torch.eval.bank import quantize_probes, streaming_topk_q
    from crfr_torch.eval.identification import _auto_block
    from crfr_torch.ops.bank_scan import bank_topk_fused

    dev = _cuda(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((rows, dim), generator=g, device=dev)
    q, scale = quantize_probes(emb)
    labels = torch.arange(rows, device=dev)
    planted = torch.randperm(rows, generator=g, device=dev)[:probes]
    p = emb[planted] / emb[planted].norm(dim=1, keepdim=True) \
        + 0.02 * torch.randn((probes, dim), generator=g, device=dev)
    del emb
    block = _auto_block(0, probes)
    calls = {"fused": lambda: bank_topk_fused(p, q, scale, labels, k=k),
             "scan": lambda: streaming_topk_q(p, q, scale, labels, k=k, block=block)}
    out = {"probes": probes, "rows": rows, "dim": dim, "k": k, "steps": steps,
           "scan_block": block, "card": _card()}
    for name, call in calls.items():
        _, lab = call()
        if not torch.equal(lab[:, 0], planted):
            raise AssertionError(f"{name}: top-1 is not the planted row")
        out[name] = _profile(call, steps, dev, top)
    return out


def trace_train(batch: int = 512, steps: int = 5, backbone: str = "ir_50",
                num_classes: int = 10572, top: int = 16, device: str | torch.device = "cuda",
                seed: int = 0) -> dict:
    """One train step per call on a device-resident batch of seeded random
    uint8 images (``bench.throughput.run_train_throughput``'s inputs)."""
    from crfr_torch.bench.throughput import train_config
    from crfr_torch.train.loop import Trainer

    dev = _cuda(device)
    cfg = train_config(backbone, num_classes, 112, batch)
    tr = Trainer(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (batch, 112, 112, 3), generator=g, device=dev, dtype=torch.uint8)
    y = torch.randint(0, num_classes, (batch,), generator=g, device=dev)
    r = _profile(lambda: tr.train_step(x, y), steps, dev, top, _TRAIN_GROUPS)
    return {
        "backbone": backbone, "batch": batch, "classes": num_classes, "steps": steps,
        "preset": "casia_arcface", "card": _card(),
        **train_roofline(r, backbone, batch, 112, cfg.model.compute_dtype),
        "wall_ms_per_step": r["wall_ms"],
        "traced_wall_ms_per_step": r["traced_wall_ms"],
        "device_busy_ms_per_step": r["device_busy_ms"],
        "idle_share_traced": r["idle_share_traced"],
        "kernel_launches_per_step": r["kernel_launches"],
        "group_ms_per_step": r["group_ms"],
        "heaviest": [{"name": h["name"], "ms_per_step": h["ms"], "calls_per_step": h["calls"]}
                     for h in r["heaviest"]],
    }


def _depth(backbone: str) -> str:
    return backbone.split("_")[1]


def train_roofline(r: dict, backbone: str, batch: int, image_size: int,
                   dtype: str = "bfloat16") -> dict:
    """A profiled train step (``_profile``'s result) against the roofline:
    crfr's keys (the forward convs' bound, 3× it for forward + dgrad +
    wgrad, the conv groups' time over that, the host's gap between the
    wall time and the device's busy time), and each group's bound from
    ``roofline.train_step_bounds`` (convs forward and backward by FLOPs,
    train-mode BN and PReLU by bytes) with its measured time over it.
    PReLU's alpha-gradient reductions fall in the ``reduce`` group, which
    its bound also covers, so ``prelu_and_reduce`` is set beside it."""
    fwd = summarize(ir_layer_bounds(_depth(backbone), batch, image_size, dtype=dtype))
    bounds = group_bounds(train_step_bounds(_depth(backbone), batch, image_size, dtype))
    g = r["group_ms"]
    conv_ms = g.get("conv_forward", 0.0) + g.get("conv_backward", 0.0)
    measured = {k: g.get(k, 0.0) for k in bounds}
    measured["prelu_and_reduce"] = g.get("prelu", 0.0) + g.get("reduce", 0.0)
    bound_ms = {k: 1e3 * v for k, v in bounds.items()}
    bound_ms["prelu_and_reduce"] = bound_ms["prelu"]
    return {
        "fwd_conv_bound_ms": 1e3 * fwd.bound_s,
        "train_conv_bound_3x_fwd_ms": 3e3 * fwd.bound_s,
        "conv_over_3x_bound": conv_ms / (3e3 * fwd.bound_s),
        "dispatch_gap_ms": r["wall_ms"] - r["device_busy_ms"],
        "group_bound_ms": bound_ms,
        "group_over_bound": {k: measured[k] / v for k, v in bound_ms.items()},
    }


def trace_sr(batch: int = 256, steps: int = 5, scale: int = 8, n_priors: int = 16,
             top: int = 16, device: str | torch.device = "cuda", seed: int = 0) -> dict:
    """One SR step (a G step and a D step) per call on a device-resident
    batch of seeded random uint8 112² images."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.sr_loop import SRTrainer

    dev = _cuda(device)
    tr = SRTrainer(get_config("casia_arcface", [f"train.log_every={10 ** 9}"]),
                   scale=scale, n_priors=n_priors, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (batch, 112, 112, 3), generator=g, device=dev, dtype=torch.uint8)
    torch.cuda.reset_peak_memory_stats(dev)
    r = _profile(lambda: tr.train_step(x), steps, dev, top, _SR_GROUPS)
    return {
        "scale": scale, "n_priors": n_priors, "batch": batch, "steps": steps,
        "preset": "casia_arcface", "card": _card(),
        "wall_ms_per_step": r["wall_ms"],
        "imgs_per_s_untraced": 1e3 * batch / r["wall_ms"],
        "traced_wall_ms_per_step": r["traced_wall_ms"],
        "device_busy_ms_per_step": r["device_busy_ms"],
        "idle_share_traced": r["idle_share_traced"],
        "kernel_launches_per_step": r["kernel_launches"],
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "group_ms_per_step": r["group_ms"],
        "heaviest": [{"name": h["name"], "ms_per_step": h["ms"], "calls_per_step": h["calls"]}
                     for h in r["heaviest"]],
    }


def trace_distill(batch: int = 512, steps: int = 5, backbone: str = "ir_50",
                  num_classes: int = 10572, top: int = 16, device: str | torch.device = "cuda",
                  seed: int = 0) -> dict:
    """One KD step per call (the teacher's no-grad forward of the HR batch,
    one degrade launch, the student's step) on a device-resident batch; the
    teacher's forward alone is traced beside it."""
    from crfr_torch.bench.throughput import train_config
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer

    dev = _cuda(device)
    cfg = train_config(backbone, num_classes, 112, batch).override(
        **{"loss.distill_weight": 1.0})
    teacher = teacher_from_trainer(Trainer(cfg, device=dev))
    tr = DistillTrainer(cfg, teacher, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (batch, 112, 112, 3), generator=g, device=dev, dtype=torch.uint8)
    y = torch.randint(0, num_classes, (batch,), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    r = _profile(lambda: tr.train_step(x, y), steps, dev, top, _TRAIN_GROUPS)
    from crfr_torch.ops.normalize import normalize

    teacher_ms = _profile(lambda: teacher(normalize(x)), steps, dev, top, _TRAIN_GROUPS)
    return {
        "backbone": backbone, "batch": batch, "classes": num_classes, "steps": steps,
        "preset": "casia_arcface", "distill_weight": 1.0, "card": _card(),
        "wall_ms_per_step": r["wall_ms"],
        "teacher_forward_wall_ms": teacher_ms["wall_ms"],
        "teacher_forward_busy_ms": teacher_ms["device_busy_ms"],
        "imgs_per_s_untraced": 1e3 * batch / r["wall_ms"],
        "traced_wall_ms_per_step": r["traced_wall_ms"],
        "device_busy_ms_per_step": r["device_busy_ms"],
        "idle_share_traced": r["idle_share_traced"],
        "kernel_launches_per_step": r["kernel_launches"],
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "group_ms_per_step": r["group_ms"],
        "heaviest": [{"name": h["name"], "ms_per_step": h["ms"], "calls_per_step": h["calls"]}
                     for h in r["heaviest"]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("embed", "embed_int8", "gallery", "train", "sr",
                                       "distill"), default="embed")
    ap.add_argument("--batch", type=int, default=0,
                    help="images or probes per call (256; 512 for train and distill)")
    ap.add_argument("--steps", type=int, default=0, help="calls per window (10; 5 for train)")
    ap.add_argument("--backbone", default="ir_50")
    args = ap.parse_args()
    if args.path in ("embed", "embed_int8"):
        out = trace_embed(args.batch or 256, args.steps or 10, args.backbone,
                          int8=args.path == "embed_int8")
    elif args.path == "gallery":
        out = trace_gallery(args.batch or 256, steps=args.steps or 10)
    elif args.path == "train":
        out = trace_train(args.batch or 512, args.steps or 5, args.backbone)
    elif args.path == "distill":
        out = trace_distill(args.batch or 512, args.steps or 5, args.backbone)
    else:
        out = trace_sr(args.batch or 256, args.steps or 5)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

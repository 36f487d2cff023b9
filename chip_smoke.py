#!/usr/bin/env python3
"""Smoke run of crfr_torch on one CUDA card: kernels, embed, verify,
gallery, serve, train, the train CLI, SR training, hallucinated
extraction, the SR CLI, residual KD, the KD CLI, the int8 embed path, the
int8 serving CLI, the headline experiment, detection, recognition from a
photo, MobileFaceNet.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, its power limit (nvidia-smi), and the kernel build time;
2. kernels: every CUDA kernel of the port, built from the sources in this
   checkout, held against its plain PyTorch version at the main paths'
   shapes, and timed beside its bound, the plain version and one library
   call as yardstick. The preprocessing kernels are held against a float64
   product too (TF32 off), with the bound counting the flops the function
   needs through its banded factors (``needed_flops``) and the bytes of the
   images, the lows and the band tables of the lows present
   (``operator_bytes``). Their cases: the main
   one (B=256, 112², uint8 → bf16, low 16, pil), f32 input and output, cv2,
   low 15 (pil and cv2), B=1, the SR trainer's ↓ (112² → 14², uint8 → f32,
   at the SR phase's batch and at the preset's 512; kernel 2's headline),
   the 160×140 → 112² resize and a 37×200 → 112×96
   uint8 resize whose rows are not 16-byte multiples, and the detector's
   shapes (``photo_cases``: every pyramid level of a 640×480 and a
   1280×720 uint8 photo at min_face 20, a 400 px box cropped to 24 and 48
   px, float32 out; each labelled with the plan it took, shorter bands or
   the two-pass plan). The main case and the
   160×140 resize are also timed at several band heights (``ms_by_rows``) and
   with a cold L2 (``cold_ms``); both entries carry the launch plan
   (``fused_preprocess.resample_info``); every band height must equal the
   default bit for bit. ``bank_tilemax`` must equal its plain version
   exactly (serving shape, ragged bank, 7 probes, D=64, D=48, one bank row,
   and 300 probes at D=1024, which take three probe groups), its entry
   carries the launch plan (registers, spill bytes, shared memory, CTAs,
   probe groups), and its yardstick is ``torch._int_mm``, the int8 product
   alone. The preprocessing kernel with a low per image (the train step's
   form): B=512, 112², lows drawn from 8–112, uint8 → bf16 and f32 → f32,
   pil and cv2, held against its plain version, against float64, and bit
   for bit against launches of the int form on each low's images; timed
   beside its bound, the plain version and one ``torch.einsum`` of the
   gathered per-image operators, and at shorter band heights;
3. embed: the main path, ``build_embed_pipeline("ir_50")`` at B=256 on
   random uint8 images (IR-50 in bf16, weights from seed 0), with the
   launch counters reset just before one call and read just after (exactly
   one preprocessing launch); its output is checked against a float32
   plain-path run, then timed;
4. verify: ``make_extract_fn`` on HR images and their 16 px probes, then the
   10-fold protocol on the card, which must equal the same protocol run on
   CPU tensors for the same distances;
5. gallery: the int8 identification path on a 2^20 x 512 bank built with
   ``quantize_bank`` (in row chunks on threads) and ``to_device()`` from
   seeded unit rows, 256 probes
   that are noisy copies of planted rows: ``topk_matches_bank(k=10)`` with
   the CUDA default (the fused path through ``bank_tilemax``, launch counter
   reset just before and read just after: exactly one launch), held
   against ``fused=False``
   (labels equal outside groups of equal scores, scores within 1e-6), top-1
   the planted row, ``closed_set_identification`` rank-1 = 1.0; then one
   256-probe scan timed on each path (CUDA events, median of 5);
6. serve: ``make_server`` with ``build_serving_fn(degrade_to=16)`` at static
   batch 64 and a ``ServingBank`` of one 65,536-row slab: three concurrent
   ``/embed`` requests, ``/healthz``, ``/match`` with pixels (top-1 equal to
   a direct ``topk_matches_bank`` on the ``/embed`` rows), ``/enroll`` of
   those pixels (``/match`` finds them), ``/remove`` (they are gone), and
   ``/gallery`` equal to ``snapshot()``. The preprocessing launches are
   counted over the three ``/embed`` requests alone, and each ``/match``
   must launch ``bank_tilemax`` exactly once, counted from 0 just before it;
7. train: the casia_arcface preset at full width (IR-50, 10,572 classes,
   batch 512, bf16 compute, dropout 0.4, per-image lows 8–112 pil, SGD with
   momentum 0.9, weight decay 5e-4; warmup 0) on seeded random uint8 images
   on the card: one warm step, then one step with the launch counters reset
   just before and read just after (exactly one preprocessing launch);
   loss and gradient norm finite, parameters changed, the head's W float32;
   then ``run_train_throughput`` (windows of ten steps) with the peak of
   ``torch.cuda.max_memory_allocated`` and ``run_fit_throughput`` (the user
   loop on host batches); then one float32 step of ir_18 at 32 px, 4
   classes, batch 16, per-image lows, s=16, m=0.2, lr 0.01, on
   ``SyntheticFaces`` images, on the card under ``strict_fp32()`` against
   the same step on CPU tensors (loss and gradient norm within 1e-4
   relative, parameters and BN statistics within rtol 1e-3 and atol 1e-4);
8. cli: ``python -m crfr_torch train --preset casia_arcface`` with 64
   classes, batch 64 and a checkpoint every 3 steps for ``--max-steps 6``,
   then ``--resume`` to 9 (it must resume at 6 and end with
   ``{"final_step": 9}``); a trainer restored from step 6 equals the saved
   state bit for bit (parameters, BN statistics, momentum buffers, step);
9. sr_train: ``SRTrainer`` on the casia_arcface preset at scale 8 with 16
   priors, full width (G: width 64, 3 coarse ResBlocks, a depth-3
   hourglass, 8 ResBlocks; D: width 64, 4 downs), float32, at batch
   ``SR_B`` (the preset's 512 does not fit: ~250 MB of saved activations
   an image) on seeded uint8 images: one warm step, then one non-logging
   step with the launch counters reset just before and read just after
   (exactly one ``fused_resize_normalize`` launch, none of either degrade
   form); losses finite, G and D changed, the EMA apart from G; one step
   with R1 (γ = 10) and two D steps; imgs/s over three windows of five
   steps with the peak of ``max_memory_allocated``; then one float32 step
   at 32 px, scale 4, 4 priors, batch 4 of ``SyntheticFaces`` on the card
   under ``strict_fp32()`` against the same step on CPU tensors (losses
   within 1e-4 relative, parameters within rtol 1e-3 / atol 1e-4 but for
   Adam's sign flips, each within 2·lr and counted), and ``psnr_ssim`` on
   the card equal to the CPU's within 1e-4;
10. sr_extract: ``load_sr_apply`` of a checkpoint of G at init, then
   ``make_extract_fn(ir_50 float32, degrade_to=14, sr_apply=...)`` at
   B=256: exactly one ``fused_resize_normalize`` launch and no degrade;
   under ``strict_fp32()`` its embeddings equal the plain ``degrade_to=14``
   path's (one launch of kernel 1) within 1e-4 relative, which holds the
   two kernels against each other; the batch timed; and
   ``build_serving_fn(sr_apply=...)`` equal to ``make_extract_fn``;
11. sr_cli: ``python -m crfr_torch train-sr`` (64 synthetic identities) at
   batch 16 with a checkpoint
   every 2 steps for ``--max-steps 4``, then ``--resume`` to 6 (``"steps":
   6``); a trainer restored from step 4 equals the saved state bit for
   bit (G, D, both Adam states, the EMA, the step);
12. distill: ``DistillTrainer`` on the casia_arcface preset at full width
   (IR-50 student, bf16, 10,572 classes, λ = 1) with a frozen IR-50
   teacher at init, on three inputs: bicubic (per-image lows 8–112) and a
   frozen G at full width (scale 8, 16 priors, float32) at batch 512, and
   G trained jointly at batch ``DISTILL_JOINT_B`` (the cut is in
   ``reduced``): for each, one warm step, then one step with the launch
   counters reset just before and read just after (exactly one launch of
   kernel 1's per-image form on the bicubic path, of kernel 2 on the G
   paths), finite losses, every student parameter moved; imgs/s over
   windows of steps with the peak of ``max_memory_allocated``; then one
   float32 step of each path at 32 px (ir_18, batch 16, lr 0.01) on the
   card under ``strict_fp32()`` against the same step on CPU tensors
   (losses within 1e-4 relative, the student within rtol 1e-3 / atol
   1e-4, G's Adam sign flips within 2·lr and counted);
13. distill_cli: ``python -m crfr_torch train`` for 2 steps as the teacher,
   then ``train-distill`` (64 synthetic identities, batch 16) for 4 steps,
   ``--resume`` to 6 and 6 straight, with cuDNN's deterministic
   algorithms: the resumed state equals the straight one bit for bit; one
   run with ``--sr-ckpt`` (G at init);
14. int8_embed: ``build_embed_pipeline("ir_50", int8=True)`` at B=256, 16
   px pil (weights from seed 0, quantized from float32, calibrated on two
   batches of 32 seeded noise images as crfr's bench does): exactly one
   launch of kernel 1 a batch, 53 ``QuantConv``s; the card's embeddings
   against the same quantized model on CPU tensors (``INT8_CPU_ROWS``
   images: the input conv's s32 sums equal, cosine > 0.999 a row); the
   cosine to the bf16 float pipeline (reported); ms a batch of both
   pipelines in turns (bf16, int8, int8, bf16); the peak of allocated
   memory; and each of IR-50's 17 conv shapes at B=256 (``QuantConv``
   whole and its ``torch._int_mm`` alone against cuDNN's bf16 conv, beside
   the int8 bound);
15. int8_cli: ``python -m crfr_torch train`` for 2 steps makes a
   checkpoint; on 1,024 seeded noise PNGs written here (two full batches,
   so no zero padding enters the calibration), ``extract --degrade 16``
   (float), ``extract --int8``, ``extract --quantize-bank`` and ``match
   --int8`` against the bank, run in this process so the launch counters
   are read around each: cosine > 0.98 between the int8 and float
   embeddings (crfr's bound), top-1 every probe's own row, kernel 1 once a
   batch, ``bank_tilemax`` at least once in ``match`` (the fused scan).
   ``extract --int8`` on the first 640 images, whose calibration takes
   crfr's 384 padding zeros, is reported beside it, not bounded.
   Without PIL it prints ``{"phase": "int8_cli", "run": false, ...}``;
16. headline: ``run_headline`` at HeadlineCfg's widths, identities and
   batch (IR-18 bf16, b64, 96/64/64 identities × 48 samples, probes 16
   and 8 px) with the steps and the eval mass cut (``HEADLINE_CUTS``,
   listed in ``reduced``) and the int8 row on: the table's schema, the
   int8 table's (each value in [0, 1], each system's int8 verification
   accuracy at least its float one − 0.05), the int8 ``student_sr``
   embedder's kernel-2 launches (one a batch), finite losses, the stage
   checkpoint and the JSON artifact; the results, ``ordering_holds``
   (reported, not asserted: the steps are cut), the render and stage
   seconds;
17. detect: ``train_mtcnn_synthetic`` on the card at crfr's slow test's
   settings (min_face 40, thresholds 0.6, 150 steps of 6 scenes, seed 0;
   losses finite, kernel 2 once a crop, counted from 0 just before), then
   six fresh 160² scenes (``default_rng(10**6)``): hits ≥ 4 and mean
   landmark error < 0.12 of the side (crfr's bounds); the detections of
   the card (``strict_fp32``) equal to the same cascade's on CPU tensors
   (count, boxes and landmarks within 1e-2 px, scores within 1e-4; a
   difference is allowed only where a candidate lies within 1e-3 of a
   threshold, and is then named in ``near_threshold``); composite photos
   of 640×480 (12 scenes) and 1280×720 (32 scenes): kernel-2 launches of
   one ``detect`` counted from 0 just before, hits, and ms by stage
   (pyramid + PNet, the host's decode and NMS, the R-net stage, the O-net
   stage);
18. recognize: ``FaceRecognizer`` with the trained cascade, ir_18 float32:
   cosine > 0.8 between the detected-landmark crop and the GT-landmark
   crop (crfr's bound); IR-50 bf16 at full width on the 640×480 photo,
   detect + align + embed timed, its launches counted; the batched warp
   of 256 faces of the 1280×720 photo on the card equal to the CPU's
   outside pixels within float32 error of a half-integer (a float64
   replay marks them) and equal to the replay's rounding, timed;
19. mobilefacenet: ``build_embed_pipeline("mobilefacenet")`` at B=256, 16
   px, bf16: exactly one kernel-1 launch a batch, cosine > 0.99 to the
   float32 plain path, ms a batch in turns with IR-50's.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and the exit code is
not 0. Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12          # H100 SXM int8 tensor cores, dense
B, S, LOW = 256, 112, 16
TRAIN_B, LOWS = 512, (8, 112)          # casia_arcface: batch 512, degrade_min..degrade_max
LOWS_NAME = "fused_degrade_normalize (a low per image)"
BANK_M, BANK_D, BANK_K = 1 << 20, 512, 10
SR_SCALE, SR_B = 8, 256                # the SR phase's batch: the largest power of two
                                       # under ~60 GB (~0.21 GB an image, PERF.md §4)
SR_LOW = S // SR_SCALE


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


SPIN_CYCLES_PER_CALL = 400_000   # ~0.2 ms of a spin kernel per call to enqueue


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call over ``iters`` back-to-back calls. A
    spin kernel ahead of them holds the device while the host enqueues the
    calls, so the host's own time per call does not pace them."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Host time of one call: what the caller's thread spends enqueueing it
    (argument checks, tensor maps, launch), with the device still busy."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return us


def event_ms(fn, repeats: int = 5) -> tuple[float, list[float]]:
    """Median device time of one call, each timed alone with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def cold_ms(fn, repeats: int = 10) -> tuple[float, list[float]]:
    """Median device time of one call with a cold L2: before each call a
    64 MB write evicts the 50 MB L2, then a spin kernel holds the device
    while the host enqueues the call between two events."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.fill_(1)
        torch.cuda._sleep(SPIN_CYCLES_PER_CALL)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def _windows(step, b: int, steps: int = 10, repeats: int = 3) -> list[float]:
    """imgs/s of ``repeats`` windows of ``steps`` calls of ``step()``."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        out.append(steps * b / (time.perf_counter() - t0))
    return out


def bound(in_bytes: int, out_bytes: int, ops: int,
          peak_ops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S
    t_ops = ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def needed_flops(which: str, b: int, c: int, h: int, w: int, arg, mode: str) -> int:
    """Flops the function needs on these shapes: each operator applied
    through its banded bicubic factors, counting only their nonzero taps
    (a sparse (m, k) by dense (k, n) product is 2 * nnz * n flops). The
    degrade operator is up(S x low) . down(low x S), so it goes down then
    up along each axis; a resize takes the cheaper of its two pass orders."""
    from crfr_torch.ops.bicubic import resize_matrix

    def nnz(m) -> int:
        return int(np.count_nonzero(m))

    if which == "fused_degrade_normalize":
        down, up = nnz(resize_matrix(h, arg, mode)), nnz(resize_matrix(arg, h, mode))
        per_plane = 2 * (down * w + arg * down + up * arg + h * up)
    else:
        (oh, ow), wr, wc = arg, nnz(resize_matrix(h, arg[0], mode)), nnz(resize_matrix(w, arg[1], mode))
        per_plane = 2 * min(wr * w + oh * wc, h * wc + wr * ow)
    return b * c * per_plane


def operator_bytes(fp, keys: list[tuple]) -> int:
    """Bytes of the band tables (starts and taps) that apply these
    operators, each distinct 1-D factor once (a square image's H and W
    factors are one table on the device): what the kernel reads of them."""
    factors = {f for k in keys for f in fp._factors(k)}
    return sum(s.nbytes + t.nbytes for s, t in (fp.band_table(*f) for f in factors))


def kernel_case(fp, which: str, x: torch.Tensor, arg, mode: str, out_dtype: torch.dtype,
                timed: bool, rows_sweep: tuple[int, ...] = ()) -> dict:
    """Kernel vs plain version vs float64 on ``x``; times when ``timed``, and
    at each band height of ``rows_sweep`` (for a degrade, those no taller
    than its plan's, the tallest that fits). ``arg`` is a degrade's low, a
    resize's (oh, ow), or a degrade's (B,) int32 tensor of lows in ``LOWS``,
    one per image; that form must also equal, bit for bit, launches of the
    int form on each low's images."""
    kern = getattr(fp, which)
    plain = getattr(fp, which + "_reference")
    b, h, w, c = x.shape
    per_image = isinstance(arg, torch.Tensor)
    oh, ow = (h, w) if which == "fused_degrade_normalize" else arg
    kw = {"lows": LOWS} if per_image else {}
    call = lambda: kern(x, arg, mode, out_dtype, **kw)  # noqa: E731
    got = call()
    want = plain(x, arg, mode, out_dtype, **kw)
    xf = x.float()
    if per_image:
        key = fp.lows_key(h, LOWS, mode)
        wg = fp._table(key, x.device)[arg.long() - LOWS[0]]       # (B, S, S): W[low] per image
        exact = torch.einsum("boi,bijc,bpj->bopc", wg.double(), x.double(), wg.double())
        library = lambda: torch.einsum("boi,bijc,bpj->bopc", wg, xf, wg)  # noqa: E731
        library_call = ("torch.einsum('boi,bijc,bpj->bopc', W[low], x.float(), W[low]) on "
                        "the gathered per-image operators, without the epilogue and cast")
        counts = [(low, int((arg == low).sum())) for low in sorted(set(arg.tolist()))]
    else:
        key = fp.operator_key(h, w, arg, mode)
        wr, wc = fp._operators(key, x.device)
        exact = torch.einsum("oi,bijc,pj->bopc", wr.double(), x.double(), wc.double())
        library = lambda: torch.einsum("oi,bijc,pj->bopc", wr, xf, wc)  # noqa: E731
        library_call = ("torch.einsum('oi,bijc,pj->bopc', Wr, x.float(), Wc): the two "
                        "dense products, without the epilogue and cast")
        counts = [(arg, b)]
    exact = (exact - 127.5) / 128.0
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    err64 = (got.double() - exact).abs().max().item()
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    tol64 = 2e-3 if out_dtype == torch.float32 else 2e-2
    if got.shape != want.shape or got.dtype != out_dtype or not got.is_contiguous():
        raise AssertionError(f"{which}: bad output {got.shape} {got.dtype}")
    if not (err <= tol and err64 <= tol64):
        raise AssertionError(f"{which} {mode} {list(x.shape)} {x.dtype}->{out_dtype}"
                             f"{' lows' if per_image else ''}: max_abs_err {err} (tol {tol}), "
                             f"vs float64 {err64} (tol {tol64})")
    case = {"in": str(x.dtype).split(".")[-1], "out": str(out_dtype).split(".")[-1],
            "shape": [b, h, w, c], "out_hw": [oh, ow], "mode": mode,
            "max_abs_err": err, "max_rel_err": err / want.float().abs().max().item(),
            "tolerance": tol, "max_abs_err_vs_f64": err64,
            "plan": fp.resample_info(tuple(x.shape), arg, mode, x.dtype, out_dtype, **kw)}
    if per_image:
        for low, _ in counts:                # the int form on the same images, bit for bit
            sel = (arg == low).nonzero()[:, 0]
            if not torch.equal(kern(x[sel].contiguous(), low, mode, out_dtype), got[sel]):
                raise AssertionError(f"{which} {mode}: low {low} of a low per image differs "
                                     f"from the int form's launch")
        case.update(lows=list(LOWS), distinct_lows=len(counts), equals_int_form=True)
    elif which == "fused_degrade_normalize":
        case["low"] = arg
    if timed:
        iters = 5 if per_image else 20       # its plain version and einsum take ~1 ms
        flops = sum(needed_flops(which, n, c, h, w, a, mode) for a, n in counts)
        in_bytes = (x.numel() * x.element_size() + (arg.numel() * 4 if per_image else 0)
                    + operator_bytes(fp, [fp.operator_key(h, w, a, mode) for a, _ in counts]))
        out_bytes = got.numel() * got.element_size()
        bms, by = bound(in_bytes, out_bytes, flops)
        case.update(
            ms=cuda_ms(call), host_us=host_us(call),
            plain_ms=cuda_ms(lambda: plain(x, arg, mode, out_dtype, **kw), iters=iters),
            library_ms=cuda_ms(library, iters=iters), library_call=library_call,
            bound_ms=bms, bound_by=by, flops=flops, bytes=in_bytes + out_bytes)
        if rows_sweep:
            sweep = {}
            for r in rows_sweep:
                if which == "fused_degrade_normalize" and r > case["plan"]["rows"]:
                    continue
                run = lambda: fp._launch(x, key, oh, ow, out_dtype, which, rows=r,  # noqa: E731
                                         low=arg if per_image else None)
                sweep[str(r)] = cuda_ms(run)
                # each output's sums run in the same order whatever the band height
                if not torch.equal(run(), got):
                    raise AssertionError(f"{which}: bands of {r} rows differ from "
                                         f"the default bands")
            case["ms_by_rows"] = sweep
            case["cold_ms"], case["cold_ms_runs"] = cold_ms(call)
    return case


def phase_kernels_lows(fp) -> dict:
    g = torch.Generator(device="cuda").manual_seed(7)
    u8 = torch.randint(0, 256, (TRAIN_B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    lows = torch.randint(LOWS[0], LOWS[1] + 1, (TRAIN_B,), generator=g, device="cuda",
                         dtype=torch.int32)
    which, sweep = "fused_degrade_normalize", (S, 56, 28, 16)
    cases = [kernel_case(fp, which, u8, lows, "pil", torch.bfloat16, True, sweep),
             kernel_case(fp, which, u8.float(), lows, "pil", torch.float32, True, sweep),
             kernel_case(fp, which, u8, lows, "cv2", torch.bfloat16, False),
             kernel_case(fp, which, u8.float(), lows, "cv2", torch.float32, False)]
    plan = {k: cases[0]["plan"][k] for k in ("registers", "spill_bytes", "smem_bytes", "ctas",
                                             "rows")}
    return {"name": LOWS_NAME, "route": "cuda",
            "source": "crfr_torch/ops/csrc/fused_preprocess.cu",
            "replaces": "crfr/ops/fused_pallas.py:34",
            "computes": "crfr/train/loop.py:263-278 (the train step's per-image einsum and "
                        "normalize)", "on_main_path": True,
            "cases": cases, **_headline(cases[0]), **plan}


def phase_kernels(fp) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    f32 = u8.float()
    bf16, f32_out = torch.bfloat16, torch.float32
    degrade = []
    for x in (u8, f32):
        for out_dtype in (bf16, f32_out):
            for mode in ("pil", "cv2"):
                main = x is u8 and out_dtype == bf16 and mode == "pil"
                degrade.append(kernel_case(fp, "fused_degrade_normalize", x, LOW, mode,
                                           out_dtype, timed=main or (x is f32 and mode == "pil"),
                                           rows_sweep=(S, 56, 28, 16) if main else ()))
    degrade += [kernel_case(fp, "fused_degrade_normalize", u8, 15, mode, bf16, timed=False)
                for mode in ("pil", "cv2")]
    degrade += [kernel_case(fp, "fused_degrade_normalize", u8[:1].contiguous(), LOW, "pil",
                            out_dtype, timed=False) for out_dtype in (bf16, f32_out)]
    big = torch.randint(0, 256, (B, 160, 140, 3), generator=g, device="cuda", dtype=torch.uint8)
    odd = torch.randint(0, 256, (5, 37, 200, 3), generator=g, device="cuda", dtype=torch.uint8)
    sr_u8 = torch.randint(0, 256, (TRAIN_B, S, S, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
    resize = [kernel_case(fp, "fused_resize_normalize", sr_u8[:SR_B].contiguous(),
                          (SR_LOW, SR_LOW), "pil", f32_out, True),
              kernel_case(fp, "fused_resize_normalize", sr_u8, (SR_LOW, SR_LOW), "pil",
                          f32_out, True),
              kernel_case(fp, "fused_resize_normalize", big, (S, S), "pil", bf16, True,
                          rows_sweep=(56, 32, 16)),
              kernel_case(fp, "fused_resize_normalize", big.float(), (S, S), "pil",
                          f32_out, True),
              kernel_case(fp, "fused_resize_normalize", odd, (S, 96), "pil", bf16, False),
              kernel_case(fp, "fused_resize_normalize", odd, (S, 96), "pil", f32_out, False)]
    resize += photo_cases(fp, g)
    plan_keys = ("registers", "spill_bytes", "smem_bytes", "ctas", "rows")
    return [
        {"name": "fused_degrade_normalize", "route": "cuda",
         "source": "crfr_torch/ops/csrc/fused_preprocess.cu",
         "replaces": "crfr/ops/fused_pallas.py:34", "on_main_path": True,
         "cases": degrade, **_headline(degrade[0]),
         **{k: degrade[0]["plan"][k] for k in plan_keys}},
        {"name": "fused_resize_normalize", "route": "cuda",
         "source": "crfr_torch/ops/csrc/fused_preprocess.cu",
         "replaces": "crfr/ops/fused_pallas.py:93", "on_main_path": True,
         "cases": resize, **_headline(resize[0]),
         **{k: resize[0]["plan"][k] for k in plan_keys}},
    ]


PHOTOS = ((480, 640), (720, 1280))      # (H, W) of the detector's photo cases
PHOTO_MIN_FACE = 20                     # MTCNN's default: the deepest pyramid
BOX = 400                               # a large face box's side, cropped to 24 and 48 px


def photo_cases(fp, g) -> list[dict]:
    """Kernel 2 at the detector's shapes, uint8 → float32 as ``MTCNN.detect``
    calls it: every pyramid level of a 640×480 and a 1280×720 photo at
    min_face 20, and a 400 px box's R- and O-net crops; each timed and
    labelled with its plan (``resample_info``: bands of how many rows, or
    the two-pass plan)."""
    from crfr_torch.models.mtcnn import MTCNN

    levels = MTCNN(min_face=PHOTO_MIN_FACE, device="cpu")
    cases = []
    for h, w in PHOTOS:
        x = torch.randint(0, 256, (1, h, w, 3), generator=g, device="cuda", dtype=torch.uint8)
        for i, (_, hw) in enumerate(levels.pyramid_sizes(h, w)):
            c = kernel_case(fp, "fused_resize_normalize", x, hw, "pil", torch.float32, True)
            cases.append({"case": f"{w}x{h} pyramid level {i}", **c})
    box = torch.randint(0, 256, (1, BOX, BOX, 3), generator=g, device="cuda", dtype=torch.uint8)
    for side, net in ((24, "R-net"), (48, "O-net")):
        c = kernel_case(fp, "fused_resize_normalize", box, (side, side), "pil", torch.float32,
                        True)
        cases.append({"case": f"{BOX} px box, {net} crop", **c})
    for c in cases:
        c["plan_taken"] = (c["plan"]["plan"] if c["plan"]["plan"] == "two_pass"
                           else f"bands of {c['plan']['rows']} rows")
    return cases


def tilemax_case(bs, pq, q, sc, valid, timed: bool) -> dict:
    """``bank_tilemax`` against its plain version, which it must equal
    exactly; times when ``timed``."""
    got = bs.bank_tilemax(pq, q, sc, valid)
    want = bs.bank_tilemax_reference(pq, q, sc, valid)
    torch.cuda.synchronize()
    (n, d), m = pq.shape, q.shape[0]
    if got.shape != (n, -(-m // 128)) or not torch.equal(got, want):
        raise AssertionError(f"bank_tilemax N={n} M={m} D={d}: differs from its plain "
                             f"version, max_abs_err {(got - want).abs().max().item()}")
    case = {"n": n, "m": m, "d": d, "tile": 128, "invalid_rows": int((~valid).sum()),
            "max_abs_err": (got - want).abs().max().item(), "tolerance": 0.0}
    if timed:
        in_bytes = pq.numel() + q.numel() + 4 * m + m      # int8, int8, f32 scales, bool mask
        out_bytes = got.numel() * 4
        ops = 2 * n * m * d
        bms, by = bound(in_bytes, out_bytes, ops, PEAK_INT8_OPS)
        qt = q.t()
        case.update(
            ms=cuda_ms(lambda: bs.bank_tilemax(pq, q, sc, valid)),
            host_us=host_us(lambda: bs.bank_tilemax(pq, q, sc, valid)),
            plain_ms=cuda_ms(lambda: bs.bank_tilemax_reference(pq, q, sc, valid), iters=5),
            library_ms=cuda_ms(lambda: torch._int_mm(pq, qt)),
            library_call="torch._int_mm(pq, q.t()): the int8 product alone, "
                         "without scale, mask or max",
            bound_ms=bms, bound_by=by, ops=ops, bytes=in_bytes + out_bytes)
    return case


def phase_kernels_bank(bs) -> dict:
    g = torch.Generator(device="cuda").manual_seed(6)
    pq = torch.randint(-127, 128, (B, BANK_D), generator=g, device="cuda", dtype=torch.int8)
    q = torch.randint(-127, 128, (BANK_M, BANK_D), generator=g, device="cuda",
                      dtype=torch.int8)
    sc = torch.rand(BANK_M, generator=g, device="cuda") * 1e-2
    valid = torch.rand(BANK_M, generator=g, device="cuda") >= 0.01
    ragged = BANK_M - 77
    q64 = torch.randint(-127, 128, (BANK_M, 64), generator=g, device="cuda", dtype=torch.int8)
    q48 = torch.randint(-127, 128, (ragged, 48), generator=g, device="cuda", dtype=torch.int8)
    wide = 1 << 16
    pq1k = torch.randint(-127, 128, (300, 1024), generator=g, device="cuda", dtype=torch.int8)
    q1k = torch.randint(-127, 128, (wide, 1024), generator=g, device="cuda", dtype=torch.int8)
    cases = [tilemax_case(bs, pq, q, sc, valid, timed=True),
             tilemax_case(bs, pq, q[:ragged], sc[:ragged], valid[:ragged], timed=False),
             tilemax_case(bs, pq[:7].contiguous(), q, sc, valid, timed=False),
             tilemax_case(bs, pq[:, :64].contiguous(), q64, sc, valid, timed=False),
             tilemax_case(bs, pq[:, :48].contiguous(), q48, sc[:ragged], valid[:ragged],
                          timed=False),
             tilemax_case(bs, pq, q[:1], sc[:1], valid[:1], timed=False),
             tilemax_case(bs, pq1k, q1k, sc[:wide], valid[:wide], timed=True)]
    for c in cases:
        c["plan"] = bs.bank_tilemax_info(c["n"], c["m"], c["d"])
    plan = {k: cases[0]["plan"][k] for k in ("registers", "spill_bytes", "smem_bytes", "ctas",
                                              "probe_groups")}
    return {"name": "bank_tilemax", "route": "cuda", "source": "crfr_torch/ops/csrc/bank_scan.cu",
            "replaces": "crfr/ops/bank_scan.py:51", "on_main_path": True,
            "cases": cases, **_headline(cases[0]), **plan}


def _headline(case: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = {k: case[k] for k in keys}
    out["kernel_ms"] = case["ms"]
    return out


def _counts(fp) -> dict:
    return {"fused_degrade_normalize": fp.fused_degrade_normalize.launches,
            LOWS_NAME: fp.fused_degrade_normalize.lows_launches,
            "fused_resize_normalize": fp.fused_resize_normalize.launches}


def _zero_counts(fp) -> None:
    fp.fused_degrade_normalize.launches = 0
    fp.fused_degrade_normalize.lows_launches = 0
    fp.fused_resize_normalize.launches = 0


def phase_embed(fp) -> tuple[dict, dict]:
    from crfr_torch.bench.throughput import build_embed_pipeline
    from crfr_torch.device import strict_fp32
    from crfr_torch.models.irse import build_backbone

    embed = build_embed_pipeline("ir_50", degrade_to=LOW, image_size=S, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)

    _zero_counts(fp)
    emb = embed(x)
    torch.cuda.synchronize()
    launches = _counts(fp)
    if tuple(emb.shape) != (B, 512) or emb.dtype != torch.float32:
        raise AssertionError(f"embed: bad output {tuple(emb.shape)} {emb.dtype}")
    if not torch.isfinite(emb).all():
        raise AssertionError("embed: non-finite embeddings")
    if launches["fused_degrade_normalize"] != 1:
        raise AssertionError(f"embed: one batch launched the preprocessing kernel "
                             f"{launches['fused_degrade_normalize']} times, want once")

    # the bf16 pipeline against the float32 plain path on 16 images
    model32 = build_backbone("ir_50", generator=torch.Generator().manual_seed(0)).cuda().eval()
    with strict_fp32(), torch.inference_mode():
        xs = x[:16]
        ref = model32(fp.fused_degrade_normalize_reference(xs, LOW, "pil", torch.float32))
        k32 = model32(fp.fused_degrade_normalize(xs, LOW, "pil", torch.float32))
    rel32 = ((k32 - ref).abs().max() / ref.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(emb[:16], ref, dim=-1).min().item()
    if not (rel32 < 1e-4 and cos > 0.99):
        raise AssertionError(f"embed: float32 kernel path vs plain rel err {rel32}, "
                             f"bf16 pipeline cosine {cos}")

    per_batch = []
    for _ in range(3):
        embed(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            embed(x)
        torch.cuda.synchronize()
        per_batch.append(1e3 * (time.perf_counter() - t0) / 20)
    best = min(per_batch)
    return ({"phase": "embed", "backbone": "ir_50", "batch": B, "degrade_to": LOW,
             "dtype": "bfloat16", "launches": launches, "shape": list(emb.shape),
             "f32_kernel_vs_plain_max_rel": rel32, "bf16_vs_f32_cos_min": cos,
             "ms_per_batch": best, "ms_per_batch_repeats": per_batch,
             "imgs_per_s": 1e3 * B / best}, {"model32": model32})


def phase_verify(fp, model32) -> dict:
    from crfr_torch.device import strict_fp32
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.eval.verification import evaluate_distances, pair_distances

    n = 300
    g = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randint(0, 256, (n, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    issame = torch.arange(n, device="cuda") % 2 == 0
    noise = torch.randn(base.shape, generator=g, device="cuda") * 8
    genuine = (base.float() + noise).clamp(0, 255).round().to(torch.uint8)
    impostor = base[torch.randperm(n, generator=g, device="cuda")]
    probes = torch.where(issame[:, None, None, None], genuine, impostor)
    hr = make_extract_fn(model32, degrade_to=None, image_size=S, device="cuda")
    lr = make_extract_fn(model32, degrade_to=LOW, image_size=S, device="cuda")
    fp.fused_degrade_normalize.launches = 0
    with strict_fp32():
        e1 = torch.cat([hr(base[i:i + 100]) for i in range(0, n, 100)])
        e2 = torch.cat([lr(probes[i:i + 100]) for i in range(0, n, 100)])
    launches = fp.fused_degrade_normalize.launches
    if launches < 1 or not (torch.isfinite(e1).all() and torch.isfinite(e2).all()):
        raise AssertionError(f"verify: launches {launches}, finite embeddings required")
    dist = pair_distances(e1, e2)
    same = issame.cpu().numpy()
    on_card = evaluate_distances(dist, same, device="cuda")
    on_cpu = evaluate_distances(dist.cpu(), same, device="cpu")
    if not (np.array_equal(on_card.fold_accuracies, on_cpu.fold_accuracies)
            and np.array_equal(on_card.best_thresholds, on_cpu.best_thresholds)
            and on_card.eer == on_cpu.eer
            and all(abs(on_card.tar_at_far[k] - v) <= 1e-6
                    for k, v in on_cpu.tar_at_far.items())):
        raise AssertionError(f"verify: protocol on the card {on_card} != on CPU {on_cpu}")
    return {"phase": "verify", "pairs": n, "launches": {"fused_degrade_normalize": launches},
            "accuracy_mean": on_card.accuracy_mean, "eer": on_card.eer,
            "tar_at_far": {str(k): v for k, v in on_card.tar_at_far.items()},
            "card_equals_cpu": True}


def _same_outside_ties(a_s, a_l, b_s, b_l) -> bool:
    """Labels equal wherever the score is not shared with a neighbour."""
    tie = np.zeros(a_s.shape, bool)
    tie[:, 1:] |= a_s[:, 1:] == a_s[:, :-1]
    tie[:, :-1] |= a_s[:, :-1] == a_s[:, 1:]
    return bool(np.array_equal(a_l[~tie], b_l[~tie]))


def unit_rows(seed: int, m: int) -> np.ndarray:
    """(m, 512) f32 unit rows from a seed, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, BANK_D), generator=g, device="cuda")
    return torch.nn.functional.normalize(x, dim=1).cpu().numpy()


def build_bank(rows: np.ndarray):
    """``quantize_bank(rows)`` in row chunks on threads (numpy releases the
    GIL): rows quantize independently, so the chunks concatenate to the
    same bank bit for bit."""
    from crfr_torch.eval.bank import QuantBank, quantize_bank

    step = -(-len(rows) // 8)
    with ThreadPoolExecutor(8) as ex:
        parts = list(ex.map(lambda i: quantize_bank(rows[i:i + step],
                                                    np.arange(i, min(i + step, len(rows)))),
                            range(0, len(rows), step)))
    return QuantBank(q=np.concatenate([b.q for b in parts]),
                     scale=np.concatenate([b.scale for b in parts]),
                     labels=np.concatenate([b.labels for b in parts]))


def phase_gallery(bs) -> dict:
    from crfr_torch.eval.bank import streaming_topk_q, topk_matches_bank
    from crfr_torch.eval.identification import _auto_block, closed_set_identification

    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    rows = unit_rows(5, BANK_M)
    bank = build_bank(rows).to_device("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    planted = rng.choice(BANK_M, B, replace=False)
    probes = (rows[planted] + rng.normal(0, 0.02, (B, BANK_D))).astype(np.float32)
    del rows

    bs.bank_tilemax.launches = 0
    s_f, l_f = topk_matches_bank(probes, bank, k=BANK_K)         # the CUDA default
    torch.cuda.synchronize()
    launches = bs.bank_tilemax.launches
    s_s, l_s = topk_matches_bank(probes, bank, k=BANK_K, fused=False)
    err = float(np.abs(s_f - s_s).max())
    if launches != 1:
        raise AssertionError(f"gallery: the default call launched bank_tilemax {launches} "
                             f"times, want exactly once")
    if s_f.shape != (B, BANK_K) or not np.isfinite(s_f).all():
        raise AssertionError(f"gallery: bad scores {s_f.shape}")
    if not (err <= 1e-6 and _same_outside_ties(s_s, l_s, s_f, l_f)):
        raise AssertionError(f"gallery: fused path differs from the scan (scores {err})")
    if not np.array_equal(l_f[:, 0], planted):
        raise AssertionError(f"gallery: top-1 is not the planted row for "
                             f"{int((l_f[:, 0] != planted).sum())} probes")
    closed = closed_set_identification(probes, bank, planted, None)
    if closed.rank1 != 1.0:
        raise AssertionError(f"gallery: closed-set rank-1 {closed.rank1}")

    p = torch.from_numpy(probes).cuda()
    block = _auto_block(0, B)
    fused_ms, fused_runs = event_ms(
        lambda: bs.bank_topk_fused(p, bank.q, bank.scale, bank.labels, k=BANK_K))
    scan_ms, scan_runs = event_ms(
        lambda: streaming_topk_q(p, bank.q, bank.scale, bank.labels, k=BANK_K, block=block))
    return {"phase": "gallery", "bank_rows": BANK_M, "d": BANK_D, "probes": B, "k": BANK_K,
            "bank_build_s": build_s, "launches": {"bank_tilemax": launches},
            "fused_vs_scan_max_abs_score_err": err, "top1_is_planted": True,
            "closed_set_rank1": closed.rank1, "top1_score_median": float(np.median(s_f[:, 0])),
            "fused_ms": fused_ms, "fused_ms_runs": fused_runs, "scan_ms": scan_ms,
            "scan_ms_runs": scan_runs, "scan_block": block}


def phase_serve(fp, bs, model32) -> dict:
    from crfr_torch.device import strict_fp32
    from crfr_torch.eval.bank import ServingBank, quantize_bank, topk_matches_bank
    from crfr_torch.serve import build_serving_fn
    from crfr_torch.serve_http import make_server

    fn = build_serving_fn(model32, degrade_to=LOW, image_size=S, device="cuda")
    meta = {"batch": 64, "image_size": S, "input_dtype": "uint8", "backbone": "ir_50"}
    rng = np.random.default_rng(4)
    reqs = [rng.integers(0, 256, (k, S, S, 3)).astype(np.uint8) for k in (1, 5, 100)]
    faces = rng.integers(0, 256, (8, S, S, 3)).astype(np.uint8)
    bank = ServingBank.from_bank(quantize_bank(unit_rows(4, 60000)), device="cuda")
    if bank.capacity != ServingBank.SLAB:
        raise AssertionError(f"serve: capacity {bank.capacity}, want one slab")

    def post(url, arr=None):
        data = b""
        if arr is not None:
            buf = io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            data = buf.getvalue()
        req = urllib.request.Request(url, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
        return json.loads(body) if r.headers["Content-Type"] == "application/json" \
            else np.load(io.BytesIO(body), allow_pickle=False)

    match_launches = []

    def match(url):
        """One ``/match`` with pixels; its own ``bank_tilemax`` launches,
        counted from 0 just before the request to its answer."""
        bs.bank_tilemax.launches = 0
        out = post(url + "/match?k=5", faces)
        match_launches.append(bs.bank_tilemax.launches)
        return out

    with strict_fp32():
        srv = make_server(fn, meta, host="127.0.0.1", port=0, bank=bank, device="cuda")
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            fp.fused_degrade_normalize.launches = 0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(3) as ex:
                futs = [ex.submit(post, url + "/embed", r) for r in reqs]
                outs = [f.result(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
            embed_launches = fp.fused_degrade_normalize.launches
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            direct = [fn(r).cpu().numpy() for r in reqs]

            emb = post(url + "/embed", faces)
            _, direct_labels = topk_matches_bank(emb, bank, k=5)
            matched = match(url)
            top1 = [m["labels"][0] for m in matched["matches"]]
            enrolled = post(url + "/enroll", faces)
            found = match(url)
            removed = post(url + f"/remove?labels={','.join(map(str, enrolled['labels']))}")
            after = match(url)
            with urllib.request.urlopen(url + "/gallery", timeout=120) as r:
                z = np.load(io.BytesIO(r.read()))
            snap = bank.snapshot()
        finally:
            srv.shutdown()
            srv.server_close()
            srv.service.close()
            th.join(timeout=30)
    errs = []
    for r, got, want in zip(reqs, outs, direct):
        if got.shape != (len(r), 512):
            raise AssertionError(f"serve: bad response shape {got.shape}")
        errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
    if max(errs) > 1e-3 or not health["ok"] or th.is_alive():
        raise AssertionError(f"serve: rel errors {errs}, health {health}")
    if not (health["mutable"] and health["gallery"] == 60000):
        raise AssertionError(f"serve: health {health}")
    if top1 != direct_labels[:, 0].tolist():
        raise AssertionError(f"serve: /match top-1 {top1} != direct "
                             f"{direct_labels[:, 0].tolist()}")
    new = enrolled["labels"]
    if [m["labels"][0] for m in found["matches"]] != new:
        raise AssertionError(f"serve: /match after /enroll {found['matches']} != {new}")
    if removed != {"removed": len(new), "gallery": 60000} or \
            any(set(m["labels"]) & set(new) for m in after["matches"]):
        raise AssertionError(f"serve: /remove {removed}, then /match {after['matches']}")
    if not all(np.array_equal(z[f], getattr(snap, f)) for f in ("q", "scale", "labels")):
        raise AssertionError("serve: /gallery differs from snapshot()")
    if embed_launches < 1:
        raise AssertionError("serve: /embed did not launch the preprocessing kernel")
    if match_launches != [1, 1, 1]:
        raise AssertionError(f"serve: the three /match requests launched bank_tilemax "
                             f"{match_launches} times, want once each")
    return {"phase": "serve", "rows": [len(r) for r in reqs], "static_batch": 64,
            "dispatches": health["dispatches"], "max_rel_err_vs_direct": errs,
            "launches": {"fused_degrade_normalize": embed_launches,
                         "bank_tilemax": sum(match_launches)},
            "bank_tilemax_launches_per_match": match_launches,
            "wall_s_three_requests": wall, "gallery_capacity": bank.capacity,
            "match_top1_equals_direct": True, "enrolled_labels": new,
            "enrolled_top1_score_min": min(m["scores"][0] for m in found["matches"]),
            "removed": removed["removed"], "gallery_equals_snapshot": True}


def _state_equal(a: dict, b: dict) -> bool:
    """Two trainer states equal bit for bit: every tensor, the step, the seed."""
    ta = {**{f"model.{k}": v for k, v in a["model"].items()},
          **{f"opt.{i}.{k}": v for i, st in a["opt"]["state"].items() for k, v in st.items()}}
    tb = {**{f"model.{k}": v for k, v in b["model"].items()},
          **{f"opt.{i}.{k}": v for i, st in b["opt"]["state"].items() for k, v in st.items()}}
    return (ta.keys() == tb.keys() and a["step"] == b["step"] and a["seed"] == b["seed"]
            and all(torch.equal(ta[k].cpu(), tb[k].cpu()) for k in ta))


def phase_train(fp) -> dict:
    from crfr_torch.bench.throughput import run_fit_throughput, run_train_throughput
    from crfr_torch.configs import get_config
    from crfr_torch.data.synthetic import SyntheticFaces
    from crfr_torch.device import strict_fp32
    from crfr_torch.train.loop import Trainer

    cfg = get_config("casia_arcface", ["train.warmup_steps=0"])
    tr = Trainer(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randint(0, 256, (TRAIN_B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    y = torch.randint(0, cfg.data.num_classes, (TRAIN_B,), generator=g, device="cuda")
    before = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    tr.train_step(x, y)                                        # warm
    torch.cuda.synchronize()
    _zero_counts(fp)
    m = tr.train_step(x, y)
    torch.cuda.synchronize()
    launches = _counts(fp)
    loss, gnorm = m["loss"].item(), m["grad_norm"].item()
    changed = sum(not torch.equal(before[k], v) for k, v in tr.model.named_parameters())
    w = tr.model.head.weight
    if launches != {"fused_degrade_normalize": 0, LOWS_NAME: 1, "fused_resize_normalize": 0}:
        raise AssertionError(f"train: one step launched {launches}, want one degrade with a "
                             f"low per image")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"train: loss {loss}, grad norm {gnorm}")
    if changed != len(before) or w.dtype != torch.float32 or tuple(w.shape) != (512, 10572):
        raise AssertionError(f"train: {changed} of {len(before)} parameters changed, "
                             f"head W {w.dtype} {tuple(w.shape)}")
    del tr, before, x, y
    torch.cuda.empty_cache()

    step = run_train_throughput(cfg=cfg, steps=10, repeats=3)
    fit = run_fit_throughput(cfg=cfg, steps=10)

    # float32 parity: one step on the card against the same step on CPU
    # tensors, with the loss of tests/test_train.py (s=16, m=0.2) and lr 0.01.
    # A step of this net moves with the last bits of its input: PReLU's slope
    # flips on activations within rounding of 0, so two CPU runs that differ
    # only in thread count part by more than the tolerance at s=64, lr 0.1
    # (and the card's kernel rounds otherwise than the plain version); here
    # twelve draws of the lows stayed within 40% of it on the CPU
    small = get_config("casia_arcface", [
        "model.backbone=ir_18", "data.image_size=32", "model.input_size=32",
        "data.num_classes=4", "train.batch_size=16", "model.compute_dtype=float32",
        "model.dropout=0.0", "train.warmup_steps=0", "data.degrade_max=32",
        "loss.scale=16.0", "loss.margin=0.2", "train.lr=0.01"])
    imgs, labels = SyntheticFaces(num_classes=4, image_size=32, seed=0).sample(
        np.random.default_rng(1), 16)
    lows = torch.from_numpy(np.random.default_rng(9).integers(8, 33, 16).astype(np.int32))
    on = {}
    for dev in ("cuda", "cpu"):
        t = Trainer(small, device=dev)
        with strict_fp32():
            m = t.train_step(imgs, labels, lows=lows)
        on[dev] = (m["loss"].item(), m["grad_norm"].item(),
                   {k: v.detach().cpu() for k, v in t.model.state_dict().items()})
    rel = abs(on["cuda"][0] - on["cpu"][0]) / abs(on["cpu"][0])
    rel_g = abs(on["cuda"][1] - on["cpu"][1]) / abs(on["cpu"][1])
    worst = max(((a.float() - on["cpu"][2][k].float()).abs()
                 - (1e-4 + 1e-3 * on["cpu"][2][k].float().abs())).max().item()
                for k, a in on["cuda"][2].items())
    if not (rel <= 1e-4 and rel_g <= 1e-4 and worst <= 0):
        raise AssertionError(f"train: float32 step on the card vs CPU: loss rel {rel}, "
                             f"grad norm rel {rel_g}, parameters beyond rtol 1e-3 / "
                             f"atol 1e-4 by {worst}")
    return {"phase": "train", "preset": "casia_arcface", "backbone": "ir_50",
            "classes": cfg.data.num_classes, "batch": TRAIN_B, "compute_dtype": "bfloat16",
            "dropout": cfg.model.dropout, "lows": list(LOWS), "mode": cfg.data.resize_mode,
            "launches": launches, "loss": loss, "grad_norm": gnorm,
            "parameters_changed": changed, "head_dtype": "float32",
            "imgs_per_s": step.imgs_per_sec, "imgs_per_s_windows": step.imgs_per_sec_windows,
            "ms_per_step": step.ms_per_step, "first_step_s": step.first_step_seconds,
            "peak_bytes": step.peak_bytes, "fit_imgs_per_s": fit.imgs_per_sec,
            "fit_peak_bytes": fit.peak_bytes, "f32_step_loss_rel_card_vs_cpu": rel,
            "f32_step_grad_norm_rel_card_vs_cpu": rel_g, "f32_step_param_excess": worst}


def phase_cli() -> dict:
    """The train CLI for 6 steps, then resumed to 9, in child processes."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])])}
    with tempfile.TemporaryDirectory() as tmp:
        ov = ["data.num_classes=64", "train.batch_size=64", "train.checkpoint_every_steps=3",
              f"train.checkpoint_dir={tmp}/ck"]
        runs = []
        t0 = time.perf_counter()
        for extra in (["--max-steps", "6"], ["--max-steps", "9", "--resume"]):
            r = subprocess.run([sys.executable, "-m", "crfr_torch", "train", "--preset",
                                "casia_arcface", *ov, *extra], cwd=root, env=env,
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"cli: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-4000:]}")
            runs.append(r)
        wall = time.perf_counter() - t0
        finals = [json.loads(r.stdout.strip().splitlines()[-1]) for r in runs]
        if finals != [{"final_step": 6}, {"final_step": 9}] or \
                "resumed from step 6" not in runs[1].stderr:
            raise AssertionError(f"cli: {finals}, second run's stderr {runs[1].stderr[-500:]}")
        ck = Checkpointer(f"{tmp}/ck")
        saved = ck.restore(step=6)
        tr = Trainer(get_config("casia_arcface", ov), device="cuda")
        tr.state = saved
        if not _state_equal(tr.state, saved) or tr.host_step != 6:
            raise AssertionError("cli: a trainer restored from step 6 differs from the saved state")
        steps = ck.steps()
    return {"phase": "cli", "final_steps": [f["final_step"] for f in finals],
            "resumed_from": 6, "checkpoints": steps, "restored_equals_saved": True,
            "wall_s_two_runs": wall}


SR_ONE_RESIZE = {"fused_degrade_normalize": 0, LOWS_NAME: 0, "fused_resize_normalize": 1}


def _nested_equal(a, b) -> bool:
    """Two nested state dicts equal: tensors bit for bit, the rest by ==."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _nested_equal(v, b[k]) for k, v in a.items())
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    return a == b


def _beyond(got: dict, want: dict) -> tuple[int, int, float]:
    """The floating elements of ``got`` beyond rtol 1e-3 / atol 1e-4 of
    ``want``'s (Adam's sign flips, after a float32 step on two devices),
    the count of floating elements, and the worst such distance."""
    flips, total, worst = 0, 0, 0.0
    for k, a in got.items():
        if not a.is_floating_point():
            continue
        b = want[k]
        bad = (a - b).abs() > 1e-4 + 1e-3 * b.abs()
        total += b.numel()
        if bad.any():
            flips += int(bad.sum())
            worst = max(worst, (a - b).abs()[bad].max().item())
    return flips, total, worst


def _sr_parity(lr: float = 1e-4) -> dict:
    """One float32 SR step at 32 px, scale 4, 4 priors, batch 4 of
    SyntheticFaces on the card under strict_fp32() against the same step on
    CPU tensors, from the same seeded weights."""
    from crfr_torch.configs import get_config
    from crfr_torch.data.synthetic import SyntheticFaces
    from crfr_torch.device import strict_fp32
    from crfr_torch.train.sr_loop import SRTrainer

    small = get_config("casia_arcface", ["data.image_size=32", "model.input_size=32",
                                         "train.batch_size=4", "train.log_every=1000"])
    imgs, _ = SyntheticFaces(num_classes=4, image_size=32, seed=0).sample(
        np.random.default_rng(1), 4)
    on = {}
    for dev in ("cuda", "cpu"):
        t = SRTrainer(small, scale=4, n_priors=4, lr_g=lr, lr_d=lr, device=dev)
        with strict_fp32():
            m = t.train_step(imgs)
            iq = t.psnr_ssim(imgs)
        state = {f"{n}.{k}": v.detach().cpu() for n in ("g", "d", "g_ema")
                 for k, v in getattr(t, n).state_dict().items() if v.is_floating_point()}
        on[dev] = (m["g_loss"].item(), m["d_loss"].item(), state, iq)
    (g1, d1, s1, iq1), (g0, d0, s0, iq0) = on["cuda"], on["cpu"]
    rel_g, rel_d = abs(g1 - g0) / abs(g0), abs(d1 - d0) / abs(d0)
    flips, total, worst_flip = _beyond(s1, s0)
    iq_err = max(abs(iq1[k] - iq0[k]) / max(1.0, abs(iq0[k])) for k in iq0)
    if not (rel_g <= 1e-4 and rel_d <= 1e-4 and iq_err <= 1e-4):
        raise AssertionError(f"sr_train: float32 step on the card vs CPU: g_loss rel {rel_g}, "
                             f"d_loss rel {rel_d}, psnr/ssim {iq1} vs {iq0}")
    if not (worst_flip <= 2 * lr and flips < 1e-4 * total):
        raise AssertionError(f"sr_train: {flips} of {total} parameters beyond rtol 1e-3 / "
                             f"atol 1e-4, the worst by {worst_flip} (Adam's sign flips are "
                             f"within 2·lr = {2 * lr})")
    return {"f32_step_g_loss_rel_card_vs_cpu": rel_g, "f32_step_d_loss_rel_card_vs_cpu": rel_d,
            "f32_step_adam_sign_flips": flips, "f32_step_elements": total,
            "f32_step_worst_flip": worst_flip, "psnr_ssim_card": iq1, "psnr_ssim_cpu": iq0,
            "psnr_ssim_rel_err": iq_err}


def phase_sr_train(fp) -> dict:
    from crfr_torch.configs import get_config
    from crfr_torch.train.sr_loop import SRTrainer

    cfg = get_config("casia_arcface")
    tr = SRTrainer(cfg, scale=SR_SCALE, n_priors=16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randint(0, 256, (SR_B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.train_step(x)                                           # warm
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if (tr.step + 1) % cfg.train.log_every == 0:
        raise AssertionError("sr_train: the counted step would log PSNR/SSIM")
    before = {n: {k: v.detach().clone() for k, v in getattr(tr, n).named_parameters()}
              for n in ("g", "d")}
    _zero_counts(fp)
    m = tr.train_step(x)
    torch.cuda.synchronize()
    launches = _counts(fp)
    g_loss, d_loss = m["g_loss"].item(), m["d_loss"].item()
    changed = {n: sum(not torch.equal(v, dict(getattr(tr, n).named_parameters())[k])
                      for k, v in before[n].items()) for n in ("g", "d")}
    ema_apart = sum(not torch.equal(a, b) for a, b in zip(tr.g_ema.parameters(),
                                                            tr.g.parameters()))
    if launches != SR_ONE_RESIZE:
        raise AssertionError(f"sr_train: one step launched {launches}, want one resize")
    if not (np.isfinite(g_loss) and np.isfinite(d_loss)):
        raise AssertionError(f"sr_train: g_loss {g_loss}, d_loss {d_loss}")
    if not (changed["g"] and changed["d"] and ema_apart):
        raise AssertionError(f"sr_train: parameters changed {changed}, EMA apart from G in "
                             f"{ema_apart} tensors")
    del before

    tr.r1_gamma, tr.n_d_steps = 10.0, 2                        # R1's double backward
    d_count = tr.d_opt.count()
    m_r1 = tr.train_step(x)
    torch.cuda.synchronize()
    r1 = (m_r1["g_loss"].item(), m_r1["d_loss"].item())
    if not (np.isfinite(r1).all() and tr.d_opt.count() == d_count + 2):
        raise AssertionError(f"sr_train: R1 step losses {r1}, D updates "
                             f"{tr.d_opt.count() - d_count}")
    tr.r1_gamma, tr.n_d_steps = 0.0, 1

    windows = _windows(lambda: tr.train_step(x), SR_B, steps=5)
    peak = torch.cuda.max_memory_allocated()
    n_g = sum(p.numel() for p in tr.g.parameters())
    n_d = sum(p.numel() for p in tr.d.parameters())
    del tr, x
    torch.cuda.empty_cache()
    imgs_per_s = 15 * SR_B / sum(5 * SR_B / w for w in windows)
    return {"phase": "sr_train", "preset": "casia_arcface", "scale": SR_SCALE, "n_priors": 16,
            "batch": SR_B, "image_size": S, "dtype": "float32", "g_parameters": n_g,
            "d_parameters": n_d, "launches": launches, "g_loss": g_loss, "d_loss": d_loss,
            "parameters_changed": changed, "ema_tensors_apart_from_g": ema_apart,
            "r1_step_losses": list(r1), "first_step_s": first_s, "imgs_per_s": imgs_per_s,
            "imgs_per_s_windows": windows, "ms_per_step": 1e3 * SR_B / imgs_per_s,
            "peak_bytes": peak, **_sr_parity()}


def phase_sr_extract(fp) -> dict:
    from crfr_torch.configs import get_config
    from crfr_torch.device import strict_fp32
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.models.irse import build_backbone
    from crfr_torch.serve import build_serving_fn
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.sr_loop import SRTrainer, load_sr_apply

    cfg = get_config("casia_arcface")
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(0, SRTrainer(cfg, scale=SR_SCALE, device="cuda").state_dict(),
                               cfg.to_json())
        sr_apply = load_sr_apply(tmp, cfg, scale=SR_SCALE, device="cuda")   # G at init
    model32 = build_backbone("ir_50", generator=torch.Generator().manual_seed(0)).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    f_sr = make_extract_fn(model32, degrade_to=SR_LOW, sr_apply=sr_apply, device="cuda")
    f_bic = make_extract_fn(model32, degrade_to=SR_LOW, device="cuda")
    with strict_fp32():
        _zero_counts(fp)
        e_sr = f_sr(x)
        torch.cuda.synchronize()
        launches = _counts(fp)
        _zero_counts(fp)
        e_bic = f_bic(x)
        torch.cuda.synchronize()
        launches_bic = _counts(fp)
        serve = build_serving_fn(model32, degrade_to=SR_LOW, sr_apply=sr_apply, flip_tta=True,
                                 device="cuda")(x[:64])
    if launches != SR_ONE_RESIZE:
        raise AssertionError(f"sr_extract: one batch launched {launches}, want one resize")
    if launches_bic["fused_degrade_normalize"] != 1:
        raise AssertionError(f"sr_extract: the bicubic path launched {launches_bic}")
    if tuple(e_sr.shape) != (B, 512) or not torch.isfinite(e_sr).all():
        raise AssertionError(f"sr_extract: bad embeddings {tuple(e_sr.shape)}")
    rel = ((e_sr - e_bic).abs().max() / e_bic.abs().max()).item()
    rel_serve = ((serve - e_sr[:64]).abs().max() / e_sr[:64].abs().max()).item()
    if not (rel <= 1e-4 and rel_serve <= 1e-5):
        raise AssertionError(f"sr_extract: G at init vs the bicubic path rel {rel}, serving "
                             f"fn vs extract rel {rel_serve}")
    ms, runs = event_ms(lambda: f_sr(x))
    ms_bic, runs_bic = event_ms(lambda: f_bic(x))
    del model32, sr_apply
    torch.cuda.empty_cache()
    return {"phase": "sr_extract", "backbone": "ir_50", "dtype": "float32", "batch": B,
            "degrade_to": SR_LOW, "scale": SR_SCALE, "launches": launches,
            "bicubic_path_launches": launches_bic, "g_at_init_vs_bicubic_max_rel": rel,
            "serving_fn_vs_extract_max_rel": rel_serve, "ms_per_batch": ms,
            "ms_per_batch_runs": runs, "bicubic_ms_per_batch": ms_bic,
            "bicubic_ms_per_batch_runs": runs_bic}


def phase_sr_cli() -> dict:
    """``train-sr`` for 4 steps, then resumed to 6, in child processes."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.sr_loop import SRTrainer

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])])}
    with tempfile.TemporaryDirectory() as tmp:
        # 64 synthetic identities (the labels go unused) in place of the
        # preset's 10,572 prototypes, which take most of a run to draw
        ov = ["data.num_classes=64", "train.batch_size=16", "train.checkpoint_every_steps=2",
              f"train.checkpoint_dir={tmp}/ck"]
        runs = []
        t0 = time.perf_counter()
        for extra in (["--max-steps", "4"], ["--max-steps", "6", "--resume"]):
            r = subprocess.run([sys.executable, "-m", "crfr_torch", "train-sr", "--preset",
                                "casia_arcface", "--scale", str(SR_SCALE), *ov, *extra],
                               cwd=root, env=env, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"sr_cli: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-4000:]}")
            runs.append(r)
        wall = time.perf_counter() - t0
        finals = [json.loads(r.stdout.strip().splitlines()[-1]) for r in runs]
        if [f["steps"] for f in finals] != [4, 6] or "resumed SR from step 4" not in runs[1].stderr \
                or not all(np.isfinite([f["g_loss"], f["d_loss"]]).all() for f in finals):
            raise AssertionError(f"sr_cli: {finals}, second run's stderr {runs[1].stderr[-500:]}")
        ck = Checkpointer(f"{tmp}/ck/sr")
        saved = ck.restore(step=4)
        tr = SRTrainer(get_config("casia_arcface", ov), scale=SR_SCALE, device="cuda")
        tr.restore_from(ck, step=4)
        if not _nested_equal(tr.state_dict(), saved) or tr.step != 4:
            raise AssertionError("sr_cli: a trainer restored from step 4 differs from the "
                                 "saved state")
        steps = ck.steps()
    return {"phase": "sr_cli", "final": finals[-1], "steps": [f["steps"] for f in finals],
            "resumed_from": 4, "checkpoints": steps, "restored_equals_saved": True,
            "wall_s_two_runs": wall}


DISTILL_JOINT_B = 256                  # the joint path's batch: G in train mode saves
                                       # ~0.21 GB an image (PERF.md §4), so 512 cannot fit
HEADLINE_CUTS = {"teacher_steps": 60, "sr_steps": 30, "distill_steps": 30, "n_pairs": 128,
                 "probes_per_id": 3, "bootstrap": 500}


def _random_heads(g, seed: int):
    """G's two correction heads drawn small from a seed (G at init is bicubic)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for head in (g.gen.out, g.coarse.out):
            head.weight.copy_(torch.randn(head.weight.shape, generator=gen) * 0.01)
            head.bias.copy_(torch.randn(head.bias.shape, generator=gen) * 0.01)
    return g


def _distill_parity(lr: float = 0.01, sr_lr: float = 1e-5) -> dict:
    """One float32 KD step of each input path at 32 px (ir_18, 4 classes,
    batch 16, s=16, m=0.2, λ=1e-3; G at scale 4 with 4 priors and random
    heads) on the card under strict_fp32() against the same step on CPU
    tensors, from the same seeded weights."""
    from crfr_torch.configs import get_config
    from crfr_torch.data.synthetic import SyntheticFaces
    from crfr_torch.device import strict_fp32
    from crfr_torch.models.sr import build_hallucinator
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import sr_apply_from_state

    small = get_config("casia_arcface", [
        "model.backbone=ir_18", "data.image_size=32", "model.input_size=32",
        "data.num_classes=4", "train.batch_size=16", "model.compute_dtype=float32",
        "model.dropout=0.0", "train.warmup_steps=0", "data.degrade_max=32",
        "loss.scale=16.0", "loss.margin=0.2", f"train.lr={lr}", "loss.distill_weight=1e-3"])
    imgs, labels = SyntheticFaces(num_classes=4, image_size=32, seed=0).sample(
        np.random.default_rng(1), 16)
    lows = torch.from_numpy(np.random.default_rng(9).integers(8, 33, 16).astype(np.int32))
    out = {}
    for path in ("bicubic", "frozen_g", "joint_g"):
        on = {}
        for dev in ("cuda", "cpu"):
            teacher = teacher_from_trainer(Trainer(small, device=dev))
            g = _random_heads(build_hallucinator(4, 4), 12).to(dev)
            kw = ({} if path == "bicubic" else
                  {"sr_scale": 4, "sr_fn": sr_apply_from_state(g)} if path == "frozen_g" else
                  {"sr_scale": 4, "sr_module": g, "sr_lr": sr_lr})
            st = DistillTrainer(small, teacher, device=dev, **kw)
            with strict_fp32():
                m = st.train_step(imgs, labels, lows=lows if path == "bicubic" else None)
            on[dev] = ({k: v.item() for k, v in m.items()},
                       {k: v.detach().cpu() for k, v in st.model.state_dict().items()},
                       {k: v.detach().cpu() for k, v in st.g.state_dict().items()}
                       if st.g is not None else {})
        (m1, s1, g1), (m0, s0, g0) = on["cuda"], on["cpu"]
        rel = max(abs(m1[k] - m0[k]) / abs(m0[k]) for k in m0 if k != "grad_norm")
        worst = max(((a.float() - s0[k].float()).abs() - (1e-4 + 1e-3 * s0[k].float().abs()))
                    .max().item() for k, a in s1.items())
        flips, total, worst_flip = _beyond(g1, g0)
        if not (rel <= 1e-4 and worst <= 0):
            raise AssertionError(f"distill: float32 {path} step on the card vs CPU: losses rel "
                                 f"{rel} ({m1} vs {m0}), student beyond rtol 1e-3 / atol 1e-4 "
                                 f"by {worst}")
        if g1 and not (worst_flip <= 2 * sr_lr and flips < 1e-4 * total):
            raise AssertionError(f"distill: joint G on the card vs CPU: {flips} of {total} "
                                 f"elements apart, the worst by {worst_flip}")
        out[path] = {"loss_rel": rel, "student_excess": worst, "metrics_card": m1,
                     **({"g_adam_sign_flips": flips, "g_elements": total,
                         "g_worst_flip": worst_flip} if g1 else {})}
    return out


def phase_distill(fp) -> dict:
    """Residual KD on the casia_arcface preset at full width with a frozen
    IR-50 teacher at init: the bicubic path (per-image lows, kernel 1's
    per-image form), a frozen G at full width (scale 8, 16 priors, float32;
    kernel 2 and G's eval forward) and G trained jointly, each with its
    launches counted over one step."""
    from crfr_torch.configs import get_config
    from crfr_torch.models.sr import build_hallucinator
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import sr_apply_from_state

    cfg = get_config("casia_arcface", ["train.warmup_steps=0", "loss.distill_weight=1.0"])
    teacher = teacher_from_trainer(Trainer(cfg, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randint(0, 256, (TRAIN_B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    y = torch.randint(0, cfg.data.num_classes, (TRAIN_B,), generator=g, device="cuda")
    paths = {}
    for path in ("bicubic", "frozen_g", "joint_g"):
        b = DISTILL_JOINT_B if path == "joint_g" else TRAIN_B
        kw = {}
        if path == "frozen_g":
            kw = {"sr_scale": SR_SCALE,
                  "sr_fn": sr_apply_from_state(build_hallucinator(SR_SCALE, 16).cuda())}
        elif path == "joint_g":
            kw = {"sr_scale": SR_SCALE, "sr_module": build_hallucinator(SR_SCALE, 16)}
        st = DistillTrainer(cfg, teacher, device="cuda", **kw)
        xb, yb = x[:b], y[:b]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st.train_step(xb, yb)                                  # warm
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        before = {k: v.detach().clone() for k, v in st.model.named_parameters()}
        _zero_counts(fp)
        m = st.train_step(xb, yb)
        torch.cuda.synchronize()
        launches = _counts(fp)
        metrics = {k: v.item() for k, v in m.items()}
        changed = sum(not torch.equal(before[k], v) for k, v in st.model.named_parameters())
        del before
        want = ({"fused_degrade_normalize": 0, LOWS_NAME: 1, "fused_resize_normalize": 0}
                if path == "bicubic" else SR_ONE_RESIZE)
        if launches != want:
            raise AssertionError(f"distill {path}: one step launched {launches}, want {want}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"distill {path}: step metrics {metrics}")
        if changed != len(list(st.model.parameters())):
            raise AssertionError(f"distill {path}: {changed} student parameters changed")
        windows = _windows(lambda: st.train_step(xb, yb), b,
                           steps=5 if path == "joint_g" else 10,
                           repeats=1 if path == "joint_g" else 3)
        ips = len(windows) * b / sum(b / w for w in windows)
        paths[path] = {"batch": b, "launches": launches, "metrics": metrics,
                       "first_step_s": first_s, "imgs_per_s": ips, "imgs_per_s_windows": windows,
                       "ms_per_step": 1e3 * b / ips,
                       "peak_bytes": torch.cuda.max_memory_allocated()}
        del st, kw
        torch.cuda.empty_cache()
    del teacher, x, y
    torch.cuda.empty_cache()
    return {"phase": "distill", "preset": "casia_arcface", "backbone": "ir_50",
            "teacher": "ir_50 at init, frozen", "distill_weight": 1.0, "classes": 10572,
            "compute_dtype": "bfloat16", "lows": list(LOWS), "sr_scale": SR_SCALE,
            "n_priors": 16, "paths": paths,
            "reduced": {"joint_g.batch": f"{TRAIN_B} -> {DISTILL_JOINT_B}: G in train mode "
                                         "saves ~0.21 GB an image"},
            "f32_step_card_vs_cpu": _distill_parity()}


def phase_distill_cli() -> dict:
    """``train`` for 2 steps (the teacher), then ``train-distill`` for 4
    steps, ``--resume`` to 6, and 6 straight, in child processes with
    cuDNN's deterministic algorithms; then 2 steps with a frozen G from an
    SR checkpoint (``--sr-ckpt``)."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.sr_loop import SRTrainer

    root = Path(__file__).resolve().parent
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTHONPATH": os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])])}
    launcher = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
                "from crfr_torch.cli import main; sys.exit(main(sys.argv[1:]))")
    with tempfile.TemporaryDirectory() as tmp:
        ov = ["data.num_classes=64", "train.batch_size=16", "train.checkpoint_every_steps=2",
              "loss.distill_weight=0.05", "train.grad_clip_norm=5.0"]
        cfg = get_config("casia_arcface", ov)
        Checkpointer(f"{tmp}/sr").save(0, SRTrainer(cfg, scale=SR_SCALE, device="cuda")
                                       .state_dict(), cfg.to_json())
        runs = []

        def run(*args):
            r = subprocess.run([sys.executable, "-c", launcher, *args], cwd=root, env=env,
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"distill_cli: {args[:1]} exit {r.returncode}\n"
                                     f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
            runs.append(r)
            return json.loads(r.stdout.strip().splitlines()[-1])

        t0 = time.perf_counter()
        run("train", "--preset", "casia_arcface", *ov, f"train.checkpoint_dir={tmp}/t",
            "--max-steps", "2")
        base = ["train-distill", "--preset", "casia_arcface", "--teacher-ckpt", f"{tmp}/t", *ov]
        finals = [run(*base, f"train.checkpoint_dir={tmp}/a", "--max-steps", "4"),
                  run(*base, f"train.checkpoint_dir={tmp}/a", "--max-steps", "6", "--resume"),
                  run(*base, f"train.checkpoint_dir={tmp}/b", "--max-steps", "6")]
        sr = run(*base, f"train.checkpoint_dir={tmp}/c", "--max-steps", "2", "--sr-ckpt",
                 f"{tmp}/sr", "--sr-scale", str(SR_SCALE))
        wall = time.perf_counter() - t0
        if [f["steps"] for f in finals] != [4, 6, 6] or sr["steps"] != 2 \
                or "resumed student from step 4" not in runs[2].stderr \
                or not all(np.isfinite(f["loss"]) for f in finals + [sr]):
            raise AssertionError(f"distill_cli: {finals}, {sr}, resumed run's stderr "
                                 f"{runs[2].stderr[-500:]}")
        resumed = Checkpointer(f"{tmp}/a/student").restore(step=6)
        straight = Checkpointer(f"{tmp}/b/student").restore(step=6)
        if not _nested_equal(resumed, straight):
            diff = max((a.float() - straight["model"][k].float()).abs().max().item()
                       for k, a in resumed["model"].items())
            raise AssertionError(f"distill_cli: 4 + --resume to 6 differs from 6 straight "
                                 f"(parameters by up to {diff})")
    return {"phase": "distill_cli", "finals": finals, "sr_run": sr,
            "resumed_equals_straight": True, "wall_s_five_runs": wall}


INT8_CPU_ROWS = 4                      # the card-vs-CPU check's images (an IR-50 int8
                                       # forward on the host's cores takes seconds an image)


@torch.no_grad()
def conv_inputs(model, x: torch.Tensor) -> list[tuple]:
    """(conv, input shape) of each conv of groups 1 of ``model``, in call
    order, on one eval-mode forward of ``x``."""
    from crfr_torch.models.quant import quantizable_convs

    seen = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))))
        for _, m in quantizable_convs(model)]
    model.eval()
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    return seen


def _int8_shape_table(b: int) -> list[dict]:
    """Each of IR-50's distinct conv shapes at batch ``b``: one ``QuantConv``
    (bf16 in and out) timed whole and its ``torch._int_mm`` alone, against
    cuDNN's bf16 convolution of the same input and weights, beside the int8
    bound (2 ops a MAC at the int8 peak, or the bytes of the bf16 input,
    the int8 weights and the bf16 output)."""
    import torch.nn.functional as F

    from crfr_torch.models.irse import build_backbone
    from crfr_torch.models.quant import QuantConv, gather_patches, int8_matmul

    model = build_backbone("ir_50", generator=torch.Generator().manual_seed(0)).cuda()
    seen = conv_inputs(model, torch.zeros(1, S, S, 3, device="cuda"))
    shapes: dict[tuple, list] = {}
    for conv, shape in seen:
        key = (conv.in_channels, conv.out_channels, conv.kernel_size[0], conv.stride[0],
               shape[2])
        shapes.setdefault(key, [conv, 0])[1] += 1
    rows = []
    for (cin, cout, k, stride, side), (conv, count) in shapes.items():
        g = torch.Generator(device="cuda").manual_seed(side + cin)
        x = torch.randn((b, cin, side, side), generator=g, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        q = QuantConv(conv, x.abs().amax().item()).to(torch.bfloat16)
        w16 = conv.weight.detach().to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        xq = torch.round(x.float() / q.sx).clamp_(-127, 127).to(torch.int8)
        patches, (_, ho, wo) = gather_patches(xq.permute(0, 2, 3, 1), q.kernel_size, q.stride,
                                              q.padding, q.dilation, q.wmat.shape[1])
        del xq
        int8_ms = cuda_ms(lambda: q(x), iters=10)
        int_mm_ms = cuda_ms(lambda: int8_matmul(patches, q.wmat), iters=10)
        cudnn_ms = cuda_ms(lambda: F.conv2d(x, w16, None, conv.stride, conv.padding), iters=10)
        macs = b * ho * wo * cout * cin * k * k
        bound_ms, bound_by = bound(x.numel() * 2 + conv.weight.numel(), b * ho * wo * cout * 2,
                                   2 * macs, PEAK_INT8_OPS)
        rows.append({"in": cin, "out": cout, "kernel": k, "stride": stride, "side": side,
                     "convs": count, "gmac": macs / 1e9, "int8_ms": int8_ms,
                     "int_mm_ms": int_mm_ms, "cudnn_bf16_ms": cudnn_ms,
                     "int8_bound_ms": bound_ms, "bound_by": bound_by,
                     "int8_over_cudnn": int8_ms / cudnn_ms,
                     "patch_bytes": patches.numel()})
        del x, q, patches
    del model
    torch.cuda.empty_cache()
    return rows


def phase_int8_embed(fp) -> dict:
    """``build_embed_pipeline("ir_50", int8=True)`` at B=256: one launch of
    kernel 1 a batch, the card's embeddings against the same quantized model
    on CPU tensors, the cosine to the bf16 float pipeline, ms a batch against
    it in turns, the per-shape table and the peak of allocated memory."""
    import copy

    from crfr_torch.bench.throughput import build_embed_pipeline
    from crfr_torch.models.quant import QuantConv

    t0 = time.perf_counter()
    embed8 = build_embed_pipeline("ir_50", degrade_to=LOW, image_size=S, int8=True,
                                  device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    embed16 = build_embed_pipeline("ir_50", degrade_to=LOW, image_size=S, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)

    embed8(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fp)
    emb8 = embed8(x)
    torch.cuda.synchronize()
    launches = _counts(fp)
    peak = torch.cuda.max_memory_allocated()
    if tuple(emb8.shape) != (B, 512) or emb8.dtype != torch.float32 \
            or not torch.isfinite(emb8).all():
        raise AssertionError(f"int8_embed: bad output {tuple(emb8.shape)} {emb8.dtype}")
    want = {"fused_degrade_normalize": 1, LOWS_NAME: 0, "fused_resize_normalize": 0}
    if launches != want:
        raise AssertionError(f"int8_embed: one batch launched {launches}, want {want}")
    q = embed8.model
    n_quant = sum(isinstance(m, QuantConv) for m in q.modules())
    if n_quant != 53:
        raise AssertionError(f"int8_embed: {n_quant} QuantConvs, want IR-50's 53")

    # the same quantized model on CPU tensors, on the card's own preprocessed input
    xs = fp.fused_degrade_normalize(x[:INT8_CPU_ROWS], LOW, "pil", torch.bfloat16)
    q_cpu = copy.deepcopy(q).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode():
        card = q(xs).float()
        sums_card = q.input_conv.int_sums(xs.permute(0, 3, 1, 2).to(torch.bfloat16))[0]
        host = q_cpu(xs.cpu()).float()
        sums_host = q_cpu.input_conv.int_sums(xs.cpu().permute(0, 3, 1, 2))[0]
    cpu_s = time.perf_counter() - t0
    cos_cpu = torch.nn.functional.cosine_similarity(card.cpu(), host, dim=-1)
    if not (torch.equal(sums_card.cpu(), sums_host) and cos_cpu.min().item() > 0.999):
        raise AssertionError(f"int8_embed: card vs CPU tensors: input-conv sums equal "
                             f"{torch.equal(sums_card.cpu(), sums_host)}, cosine {cos_cpu}")
    del q_cpu

    emb16 = embed16(x)
    cos_f = torch.nn.functional.cosine_similarity(emb8, emb16, dim=-1)

    def per_batch(fn, n=10) -> float:
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    turns = [("bf16", embed16), ("int8", embed8), ("int8", embed8), ("bf16", embed16)]
    ms = {"bf16": [], "int8": []}
    for name, fn in turns:
        ms[name].append(per_batch(fn))
    del embed16, emb16
    torch.cuda.empty_cache()
    table = _int8_shape_table(B)
    total = {k: sum(r[k] * r["convs"] for r in table)
             for k in ("int8_ms", "int_mm_ms", "cudnn_bf16_ms", "int8_bound_ms", "gmac")}
    return {"phase": "int8_embed", "backbone": "ir_50", "batch": B, "degrade_to": LOW,
            "mode": "pil", "dtype": "bfloat16 around int8 convs", "quant_convs": n_quant,
            "calibration": "2 x 32 seeded noise images, bicubic down-up, normalized",
            "build_s": build_s, "launches": launches, "peak_bytes": peak,
            "card_vs_cpu": {"rows": INT8_CPU_ROWS, "cos_min": cos_cpu.min().item(),
                            "input_conv_sums_equal": True, "cpu_s": cpu_s},
            "int8_vs_bf16_cos_min": cos_f.min().item(),
            "int8_vs_bf16_cos_mean": cos_f.mean().item(),
            "ms_per_batch": {k: min(v) for k, v in ms.items()}, "ms_per_batch_turns": ms,
            "imgs_per_s": {k: 1e3 * B / min(v) for k, v in ms.items()},
            "convs_ms_sum": total, "conv_shapes": table}


INT8_CLI_IMGS = 1024      # two full batches of 512: no zero padding in the calibration
INT8_CLI_PADDED = 640     # a list whose second batch is padded with 384 zero images


def phase_int8_cli(fp, bs) -> dict:
    """``python -m crfr_torch train`` for 2 steps makes a checkpoint; then,
    on a list of seeded noise PNGs written here, ``extract --degrade 16``
    (float), ``extract --int8`` and ``extract --quantize-bank`` and ``match
    --int8`` against the bank, in this process with the launch counters
    read around each command. ``extract --int8`` on the first 640 images is
    reported beside it: its calibration, as crfr's, takes the zero images
    that pad the second batch."""
    import contextlib

    try:
        from PIL import Image
    except ImportError:
        return {"phase": "int8_cli", "run": False, "why": "PIL not installed"}
    from crfr_torch.cli import main as cli

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])])}
    with tempfile.TemporaryDirectory() as tmp:
        ov = ["data.num_classes=64", "train.batch_size=16", f"train.checkpoint_dir={tmp}/ck"]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "crfr_torch", "train", "--preset",
                            "casia_arcface", *ov, "--max-steps", "2"], cwd=root, env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"int8_cli: train exit {r.returncode}\n{r.stderr[-4000:]}")
        train_s = time.perf_counter() - t0
        rng = np.random.default_rng(21)
        lines = []
        for i in range(INT8_CLI_IMGS):
            Image.fromarray(rng.integers(0, 256, (S, S, 3)).astype(np.uint8)).save(
                f"{tmp}/{i}.png")
            lines.append(f"{i}.png")
        Path(f"{tmp}/list.txt").write_text("\n".join(lines) + "\n")
        Path(f"{tmp}/padded.txt").write_text("\n".join(lines[:INT8_CLI_PADDED]) + "\n")
        runs = {}

        def run(name, *argv):
            _zero_counts(fp)
            bs.bank_tilemax.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli(list(argv))
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"int8_cli: {name} exit {rc}")
            runs[name] = {"s": time.perf_counter() - t0,
                          "launches": {**_counts(fp), "bank_tilemax": bs.bank_tilemax.launches},
                          "out": json.loads(out.getvalue().strip().splitlines()[-1])}
            return runs[name]["out"]

        ex = ["extract", "--ckpt", f"{tmp}/ck", "--root", tmp, "--degrade", str(LOW)]
        lst = ["--list", f"{tmp}/list.txt"]
        run("extract", *ex, *lst, "--out", f"{tmp}/f.npy")
        run("extract_int8", *ex, *lst, "--int8", "--out", f"{tmp}/q.npy")
        bank = run("extract_quantize_bank", *ex, *lst, "--quantize-bank", "--out", f"{tmp}/bank")
        res = run("match_int8", "match", "--gallery-npy", bank["out"], "--ckpt", f"{tmp}/ck",
                  *lst, "--root", tmp, "--degrade", str(LOW), "--int8")
        run("extract_int8_padded", *ex, "--list", f"{tmp}/padded.txt", "--int8",
            "--out", f"{tmp}/p.npy")
        ef, eq, ep = np.load(f"{tmp}/f.npy"), np.load(f"{tmp}/q.npy"), np.load(f"{tmp}/p.npy")

    def cosine(a, b):
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))

    cos, cos_padded = cosine(ef, eq), cosine(ef[:INT8_CLI_PADDED], ep)
    top1 = np.array([m["labels"][0] for m in res["matches"]])
    if not (ef.shape == eq.shape == (INT8_CLI_IMGS, 512) and cos.min() > 0.98):
        raise AssertionError(f"int8_cli: extract --int8 vs float cosine min {cos.min()}")
    if ep.shape != (INT8_CLI_PADDED, 512) or not np.isfinite(ep).all():
        raise AssertionError(f"int8_cli: extract --int8 on {INT8_CLI_PADDED} images gave "
                             f"{ep.shape}")
    if not np.array_equal(top1, np.arange(INT8_CLI_IMGS)) or res["gallery"] != INT8_CLI_IMGS:
        raise AssertionError(f"int8_cli: match --int8 top-1 is another row for "
                             f"{int((top1 != np.arange(INT8_CLI_IMGS)).sum())} probes")
    if runs["match_int8"]["launches"]["bank_tilemax"] < 1:
        raise AssertionError("int8_cli: match scanned the bank without bank_tilemax")
    for name, r in runs.items():
        n = INT8_CLI_PADDED if name == "extract_int8_padded" else INT8_CLI_IMGS
        if r["launches"]["fused_degrade_normalize"] != -(-n // 512):
            raise AssertionError(f"int8_cli: {name} launched {r['launches']}, want kernel 1 "
                                 f"once for each of {-(-n // 512)} batches")
    return {"phase": "int8_cli", "run": True, "images": INT8_CLI_IMGS, "degrade": LOW,
            "train_s": train_s, "int8_vs_float_cos_min": float(cos.min()),
            "int8_vs_float_cos_mean": float(cos.mean()), "top1_is_own_row": True,
            "padded_calibration": {"images": INT8_CLI_PADDED, "zero_images": 2 * 512 - INT8_CLI_PADDED,
                                   "int8_vs_float_cos_min": float(cos_padded.min()),
                                   "int8_vs_float_cos_mean": float(cos_padded.mean())},
            "runs": {k: {"s": v["s"], "launches": v["launches"],
                         "out": v["out"] if k != "match_int8" else
                         {"k": v["out"]["k"], "gallery": v["out"]["gallery"]}}
                     for k, v in runs.items()},
            "launches": runs["match_int8"]["launches"]}


def phase_headline(fp) -> dict:
    """``run_headline`` at HeadlineCfg's widths, identities and batch (IR-18
    bf16, b64, 96/64/64 identities × 48 samples, probes 16 and 8 px), the
    steps and the evaluation mass cut (``reduced``) to fit the script's
    time, with the int8 row on (the default): its table has crfr's schema,
    each value in [0, 1], and each system's int8 verification accuracy at
    least its float one − 0.05 (crfr's bound, tests/test_quant.py); the
    int8 ``student_sr`` embedder's kernel-2 launches are counted around its
    calls. The ordering is reported, not asserted: the steps are cut."""
    from crfr_torch.experiments import headline as hl

    int8_sr = {"calls": 0, "fused_resize_normalize": 0}
    twins = hl._int8_probe_embedders

    def counted(*a, **k):
        out = twins(*a, **k)
        f = out["student_sr"]

        def g(x):
            n0 = fp.fused_resize_normalize.launches
            y = f(x)
            int8_sr["calls"] += 1
            int8_sr["fused_resize_normalize"] += fp.fused_resize_normalize.launches - n0
            return y

        out["student_sr"] = g
        return out

    hl._int8_probe_embedders = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            h = hl.HeadlineCfg(out_dir=f"{tmp}/headline", **HEADLINE_CUTS)
            _zero_counts(fp)
            t0 = time.perf_counter()
            table = hl.run_headline(h, device="cuda")
            wall = time.perf_counter() - t0
            launches = _counts(fp)
            with open(os.path.join(h.out_dir, "headline.json")) as f:
                saved = json.load(f)
            has_teacher = os.path.isdir(os.path.join(h.out_dir, "teacher"))
    finally:
        hl._int8_probe_embedders = twins
    full = hl.HeadlineCfg()
    systems = ("teacher_lr", "student_bic", "student_sr")
    metrics = ("verification_acc", "rank1", "cmc5", "tpir_at_fpir0.1")
    for p in h.probe_sizes:
        res = table["results"][str(p)]
        for sysname in systems:
            for metric in metrics:
                v = res[sysname][metric]
                if not 0.0 <= v <= 1.0:
                    raise AssertionError(f"headline: {p} px {sysname} {metric} = {v}")
            row = res["int8"][sysname]
            if set(row) != {"verification_acc", "rank1"} or \
                    not all(0.0 <= v <= 1.0 for v in row.values()):
                raise AssertionError(f"headline: {p} px int8 {sysname} {row}")
            if row["verification_acc"] < res[sysname]["verification_acc"] - 0.05:
                raise AssertionError(f"headline: {p} px int8 {sysname} verification "
                                     f"{row['verification_acc']} below float "
                                     f"{res[sysname]['verification_acc']} - 0.05")
        if set(res["int8"]) != set(systems):
            raise AssertionError(f"headline: {p} px int8 systems {sorted(res['int8'])}")
        if res["student_sr"]["cmc5"] < res["student_sr"]["rank1"]:
            raise AssertionError(f"headline: {p} px CMC-5 below rank-1")
        st = table["stages"][f"students{p}"]
        if not (np.isfinite(st["loss_sr"]) and np.isfinite(st["loss_bic"])
                and np.isfinite(table["stages"][f"sr{p}"]["g_loss"])):
            raise AssertionError(f"headline: {p} px losses {st}")
    if not (int8_sr["calls"] > 0 and int8_sr["fused_resize_normalize"] == int8_sr["calls"]):
        raise AssertionError(f"headline: the int8 student_sr embedder launched kernel 2 "
                             f"{int8_sr['fused_resize_normalize']} times in "
                             f"{int8_sr['calls']} batches, want once a batch")
    if not (has_teacher and saved["results"] == json.loads(json.dumps(table["results"]))
            and saved["stages"]["n_train_imgs"] == h.ids_train * h.samples_per_id
            and np.isfinite(saved["stages"]["teacher"]["loss"])):
        raise AssertionError("headline: the artifact or the teacher's checkpoint is wrong")
    return {"phase": "headline", "results": {p: {s: r[s] for s in systems}
                                             for p, r in table["results"].items()},
            "int8": {p: r["int8"] for p, r in table["results"].items()},
            "int8_student_sr_launches": int8_sr,
            "ordering_holds": {str(p): hl.ordering_holds(table, p) for p in h.probe_sizes},
            "ordering_holds_rank1": {str(p): hl.ordering_holds(table, p, "rank1")
                                     for p in h.probe_sizes},
            "stages": table["stages"], "eval_s": {p: r["eval_s"]
                                                  for p, r in table["results"].items()},
            "total_s": table["total_s"], "wall_s": wall, "launches": launches,
            "reduced": {k: f"{getattr(full, k)} -> {v}" for k, v in HEADLINE_CUTS.items()}}


DETECT_STEPS, DETECT_SCENES = 150, 6   # crfr's slow test (tests/test_mtcnn_synthetic.py:43-86)
DETECT_THRESHOLDS, DETECT_MIN_FACE = (0.6, 0.6, 0.6), 40
WARP_FACES = 256


def _composite(rng, rows: int, cols: int, h: int, w: int):
    """A uint8 (h, w) photo of rows × cols rendered 160² scenes (zeros where
    they do not reach), with each scene's box and landmarks."""
    from crfr_torch.train.mtcnn_train import render_scene

    img = np.zeros((h, w, 3), np.float32)
    boxes, lmks = [], []
    for r in range(rows):
        for c in range(cols):
            sc = render_scene(rng, 160)
            img[160 * r:160 * (r + 1), 160 * c:160 * (c + 1)] = sc.image
            off = np.asarray([160 * c, 160 * r], np.float32)
            boxes.append(sc.box + np.tile(off, 2))
            lmks.append(sc.landmarks + off)
    return np.clip(np.floor(img + 0.5), 0, 255).astype(np.uint8), np.stack(boxes), np.stack(lmks)


def _hits(det, boxes) -> int:
    from crfr_torch.train.mtcnn_train import iou

    return sum(any(iou(d, b) >= 0.5 for d in det.boxes) for b in boxes)


def _same_detections(a, b) -> bool:
    return (a.boxes.shape == b.boxes.shape and a.landmarks.shape == b.landmarks.shape
            and np.allclose(a.boxes, b.boxes, rtol=0, atol=1e-2)
            and np.allclose(a.landmarks, b.landmarks, rtol=0, atol=1e-2)
            and np.allclose(a.scores, b.scores, rtol=0, atol=1e-4))


def _threshold_margin(mt, img) -> float:
    """The smallest distance of any candidate's face probability to its
    stage's threshold in ``mt``'s cascade on ``img``: what a difference of
    float rounding can flip."""
    from crfr_torch.models.mtcnn import crop_resize, photo_tensor

    x = photo_tensor(img, mt.device)
    t1, t2, t3 = mt.thresholds
    with torch.inference_mode():
        margin = min((float((p - t1).abs().min()) for _, p, _ in mt.pyramid(x)),
                     default=np.inf)
        b1 = mt.stage1(x)
        if len(b1):
            margin = min(margin, float((mt.rnet(crop_resize(x, b1, 24))[0] - t2).abs().min()))
            b2 = mt.stage2(x, b1)
            if len(b2):
                margin = min(margin,
                             float((mt.onet(crop_resize(x, b2, 48))[0] - t3).abs().min()))
    return margin


def _card_vs_cpu(mt_cpu, name: str, img, got, near: list) -> None:
    """Card detections ``got`` against the same cascade on CPU tensors; a
    difference is allowed only where a candidate lies within 1e-3 of a
    threshold, and is then named in ``near``."""
    want = mt_cpu.detect(img)
    if _same_detections(got, want):
        return
    margin = _threshold_margin(mt_cpu, img)
    if margin >= 1e-3:
        raise AssertionError(f"detect: {name}: card {len(got.boxes)} detections != CPU "
                             f"{len(want.boxes)}, no candidate near a threshold ({margin})")
    near.append({"photo": name, "card": len(got.boxes), "cpu": len(want.boxes),
                 "threshold_margin": margin})


def _timed_detect(mt, img) -> dict:
    """ms of one detect split by stage (host clock, each stage ending in a
    synchronize): the pyramid's resizes and PNet, the host's decode and NMS
    of stage 1, the R-net stage (crops, net, NMS), the O-net stage."""
    from crfr_torch.models.mtcnn import photo_tensor

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    with torch.inference_mode():
        x, upload = clock(lambda: photo_tensor(img, mt.device))
        levels, pyr = clock(lambda: mt.pyramid(x))
        b1, host = clock(lambda: mt.candidates(levels))
        b2, s2 = clock(lambda: mt.stage2(x, b1)) if len(b1) else (b1, 0.0)
        _, s3 = clock(lambda: mt.stage3(x, b2)) if len(b2) else (None, 0.0)
        _, total = clock(lambda: mt.detect(img))
    return {"upload_ms": upload, "pyramid_pnet_ms": pyr, "host_decode_nms_ms": host,
            "rnet_stage_ms": s2, "onet_stage_ms": s3, "detect_ms": total,
            "stage1_candidates": len(b1), "stage2_candidates": len(b2)}


def phase_detect(fp) -> tuple[dict, dict]:
    """The cascade trained on the card at crfr's slow test's settings, its
    hits and landmark error on six fresh scenes (crfr's bounds), the same
    detections from the cascade on CPU tensors, and composite photos of
    640×480 and 1280×720: kernel-2 launches a photo, ms by stage, hits."""
    from crfr_torch.device import strict_fp32
    from crfr_torch.models.mtcnn import MTCNN
    from crfr_torch.train.mtcnn_train import iou, render_scene, train_mtcnn_synthetic

    mt = MTCNN(min_face=DETECT_MIN_FACE, thresholds=DETECT_THRESHOLDS, seed=0)
    _zero_counts(fp)
    t0 = time.perf_counter()
    losses = train_mtcnn_synthetic(mt, steps=DETECT_STEPS, batch_scenes=DETECT_SCENES, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = _counts(fp)
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"detect: training losses {losses}")
    want_train = DETECT_STEPS * DETECT_SCENES * 3 * 6      # three nets, 6 crops a scene each
    if train_launches["fused_resize_normalize"] != want_train:
        raise AssertionError(f"detect: training launched kernel 2 "
                             f"{train_launches['fused_resize_normalize']} times, "
                             f"want {want_train}")

    test_rng = np.random.default_rng(10**6)
    scenes = [render_scene(test_rng, 160) for _ in range(DETECT_SCENES)]
    mt_cpu = MTCNN(min_face=DETECT_MIN_FACE, thresholds=DETECT_THRESHOLDS, device="cpu")
    mt_cpu.load_state_dict({k: v.cpu() for k, v in mt.state_dict().items()})
    hits, lmk_errs, near, dets = 0, [], [], []
    for i, sc in enumerate(scenes):
        det = mt.detect(sc.image)
        dets.append(det)
        with strict_fp32():
            _card_vs_cpu(mt_cpu, f"scene {i}", sc.image, mt.detect(sc.image), near)
        if len(det.boxes) == 0:
            continue
        best = int(np.argmax(det.scores))
        if iou(det.boxes[best], sc.box) >= 0.5:
            hits += 1
            side = sc.box[2] - sc.box[0]
            lmk_errs.append(float(np.abs(det.landmarks[best] - sc.landmarks).mean() / side))
    if not (hits >= 4 and lmk_errs and np.mean(lmk_errs) < 0.12):
        raise AssertionError(f"detect: {hits}/6 hits, landmark errors {lmk_errs} "
                             f"(crfr's bounds: >= 4, mean < 0.12)")

    photos = {}
    rng = np.random.default_rng(7)
    for name, (rows, cols, h, w) in {"640x480": (3, 4, 480, 640),
                                     "1280x720": (4, 8, 720, 1280)}.items():
        img, boxes, lmks = _composite(rng, rows, cols, h, w)
        mt.detect(img)                                  # warm: band tables, cuDNN plans
        _zero_counts(fp)
        det = mt.detect(img)
        torch.cuda.synchronize()
        launches = _counts(fp)
        with strict_fp32():
            _card_vs_cpu(mt_cpu, name, img, mt.detect(img), near)
        runs = [_timed_detect(mt, img) for _ in range(3)]
        photos[name] = {"faces": len(boxes), "detections": len(det.boxes),
                        "hits": _hits(det, boxes), "launches": launches,
                        "levels": len(mt.pyramid_sizes(h, w)),
                        "ms": min(runs, key=lambda r: r["detect_ms"]), "ms_runs": runs,
                        "image": img, "landmarks": lmks, "boxes": boxes}
    out = {"phase": "detect", "min_face": DETECT_MIN_FACE, "thresholds": DETECT_THRESHOLDS,
           "train": {"steps": DETECT_STEPS, "batch_scenes": DETECT_SCENES, "seed": 0,
                     "losses": losses, "seconds": train_s, "launches": train_launches},
           "hits": hits, "of": len(scenes), "landmark_err": float(np.mean(lmk_errs)),
           "landmark_errs": lmk_errs, "card_equals_cpu": not near, "near_threshold": near,
           "photos": {k: {kk: vv for kk, vv in v.items()
                          if kk not in ("image", "landmarks", "boxes")}
                      for k, v in photos.items()},
           "launches": photos["640x480"]["launches"],
           "train_launches": train_launches}
    return out, {"mtcnn": mt, "scenes": scenes, "dets": dets, "photos": photos}


def _warp_replay(img: np.ndarray, lmks: np.ndarray, size: int):
    """float64 solve and bilinear warp of each face (crfr's C++ in double):
    the values (N, size, size, C) and the float32 rounding slack of each:
    1e-3 plus the gradient times a coordinate error of 1e-4 px + 2e-7 of
    the coordinate (a few float32 ulps of it)."""
    from crfr_torch.ops.similarity import REFERENCE_LANDMARKS_112 as tmpl

    src, dst = lmks.astype(np.float64), tmpl.astype(np.float64)
    ms, md = src.mean(1), dst.mean(0)
    ps, pd = src - ms[:, None], dst - md
    den = (ps ** 2).sum((1, 2))
    a = (ps[..., 0] * pd[:, 0] + ps[..., 1] * pd[:, 1]).sum(1) / den
    b = (ps[..., 0] * pd[:, 1] - ps[..., 1] * pd[:, 0]).sum(1) / den
    det = a * a + b * b                                  # inverse of [[a, -b], [b, a]]
    ia, ib = a / det, b / det
    tx = md[0] - (a * ms[:, 0] - b * ms[:, 1])
    ty = md[1] - (b * ms[:, 0] + a * ms[:, 1])
    yo, xo = np.mgrid[0:size, 0:size].astype(np.float64)
    xs = ia[:, None, None] * (xo - tx[:, None, None]) + ib[:, None, None] * (yo - ty[:, None, None])
    ys = -ib[:, None, None] * (xo - tx[:, None, None]) + ia[:, None, None] * (yo - ty[:, None, None])
    h, w = img.shape[:2]
    src_img = img.astype(np.float64)
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]

    def at(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return src_img[yy.clip(0, h - 1), xx.clip(0, w - 1)] * ok[..., None]

    v00, v01, v10, v11 = at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    val = (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy
    grad = (np.abs((v01 - v00) * (1 - fy) + (v11 - v10) * fy)
            + np.abs((v10 - v00) * (1 - fx) + (v11 - v01) * fx))
    coord = np.maximum(np.abs(xs), np.abs(ys))[..., None]
    return val, 1e-3 + (1e-4 + 2e-7 * coord) * grad


def phase_recognize(fp, det_state: dict) -> dict:
    """``FaceRecognizer`` with the trained cascade: ir_18 float32 against
    crfr's bound (cosine > 0.8 between the detected-landmark and the
    GT-landmark crop), IR-50 bf16 at full width timed per photo, and the
    batched warp of 256 faces on the card against CPU tensors."""
    from crfr_torch.configs import Config, ModelCfg
    from crfr_torch.ops.warp import align_faces
    from crfr_torch.pipeline import FaceRecognizer
    from crfr_torch.train.mtcnn_train import iou

    mt = det_state["mtcnn"]
    pick = next(i for i, (sc, d) in enumerate(zip(det_state["scenes"], det_state["dets"]))
                if len(d.boxes) and iou(d.boxes[int(np.argmax(d.scores))], sc.box) >= 0.5)
    sc = det_state["scenes"][pick]
    rec = FaceRecognizer.from_config(
        Config(model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0)),
        detector=mt)
    crops_det = rec.detect_and_align(sc.image)
    crops_gt = rec.detect_and_align(sc.image, sc.landmarks[None])
    cos = float(rec.similarity(rec.embed(crops_det[:1]), rec.embed(crops_gt))[0, 0])
    if not cos > 0.8:
        raise AssertionError(f"recognize: detected-landmark crop cosine {cos} (crfr: > 0.8)")

    photo = det_state["photos"]["640x480"]
    rec50 = FaceRecognizer.from_config(
        Config(model=ModelCfg(backbone="ir_50", compute_dtype="bfloat16", dropout=0.0)),
        detector=mt)
    rec50.embed(rec50.detect_and_align(photo["image"]))            # warm
    _zero_counts(fp)
    rec50.embed(rec50.detect_and_align(photo["image"]))
    torch.cuda.synchronize()
    launches = _counts(fp)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        faces = rec50.detect_and_align(photo["image"])
        t1 = time.perf_counter()
        emb = rec50.embed(faces)
        t2 = time.perf_counter()
        runs.append({"detect_align_ms": 1e3 * (t1 - t0), "embed_ms": 1e3 * (t2 - t1),
                     "photo_ms": 1e3 * (t2 - t0)})
    if not (emb.shape == (len(faces), 512) and np.isfinite(emb).all() and len(faces)):
        raise AssertionError(f"recognize: IR-50 embeddings {emb.shape}")

    big = det_state["photos"]["1280x720"]
    rng = np.random.default_rng(8)
    lmks = (np.repeat(big["landmarks"], WARP_FACES // len(big["landmarks"]), 0)
            + rng.normal(0, 1.0, (WARP_FACES, 5, 2))).astype(np.float32)
    x = torch.from_numpy(big["image"]).cuda()
    lm_dev = torch.from_numpy(lmks).cuda()
    card = align_faces(x, lm_dev, 112).cpu().numpy()
    cpu = align_faces(big["image"], lmks, 112, device="cpu").numpy()
    val, slack = _warp_replay(big["image"], lmks, 112)
    tied = np.abs(val - np.floor(val) - 0.5) < slack
    exact = np.clip(np.floor(val + 0.5), 0, 255)
    apart = card != cpu
    if (apart & ~tied).any() or np.abs(card.astype(int) - cpu).max() > 1 \
            or (card != exact)[~tied].any():
        raise AssertionError(f"recognize: the card's warp differs from the CPU's at "
                             f"{int((apart & ~tied).sum())} pixels off a near-tie")
    warp_ms = cuda_ms(lambda: align_faces(x, lm_dev, 112))
    return {"phase": "recognize", "ir18_cos_detected_vs_gt": cos, "scene": pick,
            "ir50_bf16": {"photo": "640x480", "faces": len(faces), "runs": runs,
                          "photo_ms": min(r["photo_ms"] for r in runs)},
            "warp": {"faces": WARP_FACES, "photo": "1280x720", "ms": warp_ms,
                     "pixels_apart": int(apart.sum()), "near_ties": int(tied.sum()),
                     "card_equals_cpu_outside_ties": True},
            "launches": launches}


def phase_mobilefacenet(fp) -> dict:
    """``build_embed_pipeline("mobilefacenet")`` at B=256, 16 px, bf16: one
    kernel-1 launch a batch, cosine > 0.99 to the float32 plain path, ms a
    batch in turns with IR-50's."""
    from crfr_torch.bench.throughput import build_embed_pipeline
    from crfr_torch.device import strict_fp32
    from crfr_torch.models.irse import build_backbone

    mfn = build_embed_pipeline("mobilefacenet", degrade_to=LOW, image_size=S, seed=0)
    ir50 = build_embed_pipeline("ir_50", degrade_to=LOW, image_size=S, seed=0)
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    _zero_counts(fp)
    emb = mfn(x)
    torch.cuda.synchronize()
    launches = _counts(fp)
    if launches["fused_degrade_normalize"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"mobilefacenet: one batch launched {launches}, want kernel 1 once")
    model32 = build_backbone("mobilefacenet", generator=torch.Generator().manual_seed(0))
    model32 = model32.cuda().eval()
    with strict_fp32(), torch.inference_mode():
        ref = model32(fp.fused_degrade_normalize_reference(x, LOW, "pil", torch.float32))
    cos = torch.nn.functional.cosine_similarity(emb, ref, dim=-1)
    if not (emb.shape == (B, 512) and torch.isfinite(emb).all() and cos.min().item() > 0.99):
        raise AssertionError(f"mobilefacenet: {tuple(emb.shape)}, cosine to float32 "
                             f"{cos.min().item()}")

    def per_batch(fn, n=20) -> float:
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    turns = [("mobilefacenet", per_batch(mfn)), ("ir_50", per_batch(ir50)),
             ("ir_50", per_batch(ir50)), ("mobilefacenet", per_batch(mfn))]
    return {"phase": "mobilefacenet", "batch": B, "degrade_to": LOW, "dtype": "bfloat16",
            "launches": launches, "cos_to_f32_min": cos.min().item(),
            "cos_to_f32_mean": cos.mean().item(),
            "ms_per_batch": min(t for n, t in turns if n == "mobilefacenet"),
            "ir50_ms_per_batch": min(t for n, t in turns if n == "ir_50"), "turns": turns}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from crfr_torch.ops import _build
    from crfr_torch.ops import bank_scan as bs
    from crfr_torch.ops import fused_preprocess as fp

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0})

    kernels = phase_kernels(fp) + [phase_kernels_bank(bs), phase_kernels_lows(fp)]
    emit({"phase": "kernels", "cases": sum(len(k["cases"]) for k in kernels)})
    embed, state = phase_embed(fp)
    emit({**embed, "card": smi})
    emit(phase_verify(fp, state["model32"]))
    gallery = phase_gallery(bs)
    emit({**gallery, "card": smi})
    serve = phase_serve(fp, bs, state["model32"])
    emit(serve)
    del state
    torch.cuda.empty_cache()
    train = phase_train(fp)
    emit({**train, "card": smi})
    emit(phase_cli())
    sr_train = phase_sr_train(fp)
    emit({**sr_train, "card": smi})
    sr_extract = phase_sr_extract(fp)
    emit({**sr_extract, "card": smi})
    emit(phase_sr_cli())
    distill = phase_distill(fp)
    emit({**distill, "card": smi})
    emit(phase_distill_cli())
    int8_embed = phase_int8_embed(fp)
    emit({**int8_embed, "card": smi})
    int8_cli = phase_int8_cli(fp, bs)
    emit(int8_cli)
    headline = phase_headline(fp)
    emit({**headline, "card": smi})
    torch.cuda.empty_cache()
    detect, det_state = phase_detect(fp)
    emit({**detect, "card": smi})
    recognize = phase_recognize(fp, det_state)
    emit({**recognize, "card": smi})
    del det_state
    mobilefacenet = phase_mobilefacenet(fp)
    emit({**mobilefacenet, "card": smi})
    # launches on each kernel's own main path: embed for the int form of the
    # preprocessing kernel, the gallery scan for bank_tilemax, a train step
    # for the form with a low per image, an SR train step for the resize
    paths = {"embed": embed["launches"], "gallery": gallery["launches"],
             "serve": serve["launches"], "train": train["launches"],
             "sr_train": sr_train["launches"], "sr_extract": sr_extract["launches"],
             **{f"distill_{p}": v["launches"] for p, v in distill["paths"].items()},
             "int8_embed": int8_embed["launches"],
             **({"int8_cli_match": int8_cli["launches"]} if int8_cli["run"] else {}),
             "headline": headline["launches"], "detect": detect["launches"],
             "train_mtcnn": detect["train_launches"], "recognize": recognize["launches"],
             "mobilefacenet": mobilefacenet["launches"]}
    own = {"bank_tilemax": gallery, LOWS_NAME: train, "fused_resize_normalize": sr_train}
    for k in kernels:
        k["launches"] = own.get(k["name"], embed)["launches"][k["name"]]
        k["launches_by_path"] = {p: v[k["name"]] for p, v in paths.items() if k["name"] in v}
    emit({"kernels": kernels, "card": smi, "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

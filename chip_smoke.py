#!/usr/bin/env python3
"""Smoke run of crfr_torch on one CUDA card: kernels, embed, verify,
gallery, serve, train, the train CLI, in-loop eval, a recycled run, the
soak, the schedule soak, debug and profiling, the roofline, SR training, hallucinated
extraction, the SR CLI, residual KD, the KD CLI, the int8 embed path, the
int8 serving CLI, the headline experiment, detection, recognition from a
photo, MobileFaceNet, the serving artifact, the artifact daemon in this
process and from the CLI, the evaluation CLI, two rank processes on
the card (the sharded gallery scan, data-parallel and class-sharded
training, the two-process train CLI), the ``bench`` subcommand and its
CPU yardstick, and the MS1M-scale step and FIT tools.

    python3 chip_smoke.py

The child processes of the correctness phases (the CLIs, the recycled
chain, the schedule soak, the MS1M FIT, phase 24's CLI ranks) run in the
background beside each other or beside in-process work that is not
timed, so their start-ups overlap; each phase's own seconds are in its line (``wall_s`` and the
like). The timed work runs alone on the card, but for ``ms1m_scale``,
which runs while the FIT child renders its faces on the host, and phase
24's ranks, whose launch runs beside the one-process float32 reference.

Phases, each printing one JSON line (with ``elapsed_s``, the seconds
since the script started):

1. device: the card, its power limit (nvidia-smi), and the kernel build time;
1b. first_launch: the ragged forms of kernel 2 (a photo's pyramid, a
   stage's crops) launched for the first time in a child process under a
   300 s limit, small, against their plain versions and the launches of
   their own; a kernel that hangs fails this phase by name (the child
   starts before the build and waits for the library);
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
   the two-pass plan). The ragged forms are entries of their own: each
   photo's pyramid in one launch and 223 boxes of the 640×480 photo (some
   outside it, one with no area) cut to 24 px (timed) and 48 px in one
   launch, held against the plain versions (1e-4), float64 (2e-3) and, bit
   for bit, the launches of their own; timed beside the bound, the plain
   version, the per-level launches' summed ms (the per-crop path's device
   time) and the summed per-level (per-crop) einsums. The main case and the
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
   gathered per-image operators, and with every low at one band height
   (56, 28, 16 rows; 56 for all was the plan of old); its entry carries the
   plan (each low's band height, the shared-memory budget, CTAs an SM by
   the occupancy API), and one call at B=512 runs under
   ``torch.cuda.set_sync_debug_mode("error")`` with the launch count set to
   0 just before it and read just after (``launches_a_call``, which must be 1).
   The train-mode BN's four kernels (``ops.batch_norm``, entry
   ``batch_norm``): IR-50's five BN shapes at B=512 in bf16 (64×112² …
   512×7²), a forward and backward each held against the plain version and
   against float64 on the card (y and dx within rtol 2⁻⁷, dw and db within
   1e-5 of their sums of |terms|, the running statistics within rtol 1e-5;
   four launches), then timed with the L2 overwritten before each call
   beside the plain version, ATen's ``F.batch_norm`` (the library), each
   pass's bound (its bytes at 3.35 TB/s) and each kernel's µs from a
   ``torch.profiler`` trace; the entry's numbers are the step's, each
   shape's times its count among IR-50's 54 BatchNorm2d;
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
   just before and read just after (exactly one preprocessing launch, and
   the BN kernels 216 times: 4 for each of IR-50's 54 BatchNorm2d; every
   train path below counts them too, 216 an IR-50 step, and where G or D
   trains 4 a train-mode BatchNorm2d call, counted by ``bn_calls``);
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
   ``{"final_step": 9}``), both children started before phase 8a and run
   beside it and phase 8b; a trainer restored from step 6 equals the saved
   state bit for bit (parameters, BN statistics, momentum buffers, step);
8a. train_eval: ``train --eval-bin`` in this process (phase 8's cut: 64
   classes, batch 64) from a ``.crfrpack`` of ``bench/soak.py``'s
   ``_build_pack`` and a 600-pair ``.bin`` of its ``_build_eval_bin``, 6
   steps, an eval every 3 degraded to 16 px: eval lines at 3 and 6, the
   per-image kernel once a step, kernel 1 once an eval batch (counted from 0
   just before the command); ``eval-bin --ckpt`` on the step-6 checkpoint
   equal to the in-loop eval of step 6. The ``.bin`` holds 600 pairs of
   hard renders (``soak._build_eval_bin``'s synthetic pairs are separable
   at init: accuracy 1.0, EER 0 at every step). Without PIL it prints
   ``"run": false``;
8b. recycle: ``python -m crfr_torch train --max-steps 9 --recycle-every-steps
   3`` in a child: recycles at (3, 1) and (6, 2), both resumes in its
   stderr, ``{"final_step": 9}``, steps 1..9 logged once each; two
   straight 9-step runs in this process while the child runs (and phase
   8d's child beside both): the chain equal to the first bit
   for bit, or (cuDNN's backward not being deterministic) no further from
   it than the second is; both maxima printed;
8c. soak: ``bench.soak.run_soak`` at IR-50, batch 256, 112², 120 steps on a
   pack of 200 × 40 images, an eval and a checkpoint at step 100: the fit,
   step-only, host-pipeline and pinned-copy rates, ``fit_over_step``, the
   first step's seconds, peak memory, the seconds of the eval and the
   checkpoint inside the window, the loop thread's ms a step in the feed,
   and the device's idle share over ten traced steps of the fit loop and
   of the step alone; launches counted around it (kernel 1′ 197: 120
   steps, the step-only ceiling's 31, the traced windows' 46; kernel 1
   six: one eval);
8d. schedule_soak: ``python -m crfr_torch.bench.schedule_soak --smoke
   --device cuda`` in a child: exit 0, two recycles, a stream with no gap
   to step 48, warmup and drops as configured; its wall seconds;
8e. debug (run between recycle and soak): ``no_host_transfers`` makes
   ``.item()`` and ``.cpu()`` of a CUDA tensor raise and lets them pass
   after; ``debug_mode(nans=True)`` raises on a CUDA ``log`` of a negative
   value naming the op; ``profiling.trace`` writes a trace with an
   ``annotate`` span and kernels; ``timed``;
8f. roofline: the embed phase's ms a batch against
   ``summarize(ir_layer_bounds("50", 256, 112))`` (attainment), and a traced
   train step at batch 512 (``xprof_check.trace_train``, 3 steps) with
   crfr's roofline keys and each group's time against
   ``train_step_bounds`` (BN and PReLU by bytes, convs by FLOPs);
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
11. sr_cli (run beside phase 13, after phase 12): ``python -m crfr_torch
   train-sr`` (64 synthetic identities) at batch 16 with a checkpoint
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
13. distill_cli: ``train`` for 2 steps in this process as the teacher,
   then ``python -m crfr_torch train-distill`` (64 synthetic identities,
   batch 16) in children with cuDNN's deterministic algorithms, three at
   once: 4 steps and ``--resume`` to 6, 6 straight, and one run with
   ``--sr-ckpt`` (G at init): the resumed state equals the straight one
   bit for bit;
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
   losses finite, the crop form once a net and scene and no other launch,
   counted from 0 just before), then
   six fresh 160² scenes (``default_rng(10**6)``): hits ≥ 4 and mean
   landmark error < 0.12 of the side (crfr's bounds); the detections of
   the card (``strict_fp32``) equal to the same cascade's on CPU tensors
   (count, boxes and landmarks within 1e-2 px, scores within 1e-4; a
   difference is allowed only where a candidate lies within 1e-3 of a
   threshold, and is then named in ``near_threshold``); composite photos
   of 640×480 (12 scenes) and 1280×720 (32 scenes): kernel-2 launches of
   one ``detect`` counted from 0 just before (exactly one pyramid and two
   crop launches), hits, ms by stage (pyramid + PNet, the host's decode
   and NMS, the R-net stage, the O-net stage), and the R-net stage's crops
   timed alone against the per-crop path; ``--only photo`` runs phases 1b,
   the photo cases and this one;
18. recognize: ``FaceRecognizer`` with the trained cascade, ir_18 float32:
   cosine > 0.8 between the detected-landmark crop and the GT-landmark
   crop (crfr's bound); IR-50 bf16 at full width on the 640×480 photo,
   detect + align + embed timed, its launches counted; the batched warp
   of 256 faces of the 1280×720 photo on the card equal to the CPU's
   outside pixels within float32 error of a half-integer (a float64
   replay marks them) and equal to the replay's rounding, timed;
19. mobilefacenet: ``build_embed_pipeline("mobilefacenet")`` at B=256, 16
   px, bf16: exactly one kernel-1 launch a batch, cosine > 0.99 to the
   float32 plain path, ms a batch in turns with IR-50's;
20. export: ``serve.export_embed`` of the casia_arcface trainer at full
   width (IR-50, 112², bf16 compute, weights from the preset's seed), low
   16 pil, B=256 uint8: export and load seconds and the file's bytes; the
   loaded weights equal the trainer's on the card (device, strides,
   values); one call launches kernel 1 exactly once (the custom op's CUDA
   body); cosine ≥ 0.9999 a row to ``build_serving_fn`` on the same weights
   and images (bit equality reported); ms a batch of both in turns; the
   host's µs a call of kernel 1 through the public function, through the
   op's dispatcher and as a bare launch, in turns. The
   same for the int8 backbone (``export --int8``'s noise calibration; its
   cosine to the float artifact reported) and, in float32 under
   ``strict_fp32``, for G at init behind ↓14 (one kernel-2 launch, no
   kernel 1; within 1e-2 of the bicubic artifact);
21. serve_artifact: ``serve_http.serve_artifact`` on the bf16 artifact in
   this process: ``/embed`` of 300 images (two coalesced static batches,
   two kernel-1 launches) equal to the artifact on the same padded
   batches within 1e-5; ``/match`` of 8 faces against a 2^16-row bank with
   those faces planted equal to ``topk_matches_bank`` (one
   ``bank_tilemax`` launch); with ``mutable=True``: ``/enroll``,
   ``/match``, ``/remove``, ``/match``; the latency of ``/embed`` (1 and
   256 images), ``/match`` (pixels and embeddings) and ``/enroll``;
22. serve_cli: the trainer saved as a checkpoint, ``python -m crfr_torch
   export`` in a child process (its meta equal to phase 20's), then
   ``serve-http --artifact --gallery-npz --mutable-gallery --port 0`` in
   another: its JSON line, ``/embed`` and ``/match`` equal to phase 21's
   answers, ``/enroll`` of eight other faces found by ``/match``,
   ``/remove``, then SIGINT and exit 0;
23. eval_cli: rendered faces at 64 px written as each protocol's files and a
   2-step float32 IR-18 ``train`` checkpoint: ``eval-verification``
   (bicubic, ``--sr-ckpt`` with G at init), ``eval-scface``,
   ``eval-openset`` (image lists; ``--probe-npy``), ``eval-bin`` (a
   ``save_bin`` set), ``eval-ijbc`` (1:1 and 1:N; ``--probe-tpl-npy``) and
   ``eval-verification`` on an ``import-torch`` of a seeded face.evoLVe
   dict, each on the card under ``strict_fp32`` (launches counted around
   it) and with ``--device cpu``: the same JSON, accuracies and ranks
   exactly, other numbers within 1e-4; ``import-torch`` on both equal;
   ``pack`` of a folder tree and of an MX ``.rec``, read back.
   Without PIL it prints ``{"phase": "eval_cli", "run": false, ...}``;
24. distributed: two rank processes on the one card (this script with
   ``--rank``, or ``python -m crfr_torch train``), started through the
   port's ``CRFR_*`` launch variables on gloo (NCCL refuses two ranks on
   one card; gloo stages CUDA tensors through the host, the kernels run on
   the card), each with a time limit, (c) started before phase 23 and
   run beside it, then (a) and (b) in one launch of the ranks, (b)'s
   one-process reference computed meanwhile: (a) phase 5's bank row-sharded, each
   rank uploading and scanning its 2^19 rows (``bank_tilemax`` once a
   rank, counted in the rank), equal to phase 5's one-process fused scan
   (scores within 1e-6, labels outside ties, top-1 planted); (b) the
   preset at full width (IR-50, 10,572 classes) as data=2 and as model=2
   (the class-sharded head): three float32 steps at a global batch of 64
   (s=16, m=0.2, lr 1e-3) under ``strict_fp32()`` against the one-process
   trainer here (losses
   within 1e-4 relative, parameters and BN statistics within rtol 1e-3 /
   atol 1e-4), then ten bf16 steps at 512 (ms a step, peak memory and
   kernel 1' launches a rank: one a step), then a split extract of 256
   faces (kernel 1 once a rank, cosine to the whole batch > 0.999); (c)
   ``train`` as two processes on a ``.crfrpack``: 4 steps + ``--resume`` to
   6 equal to 6 straight (or within two straight runs' spread; the 6
   straight run beside the 4-step one, four ranks at once), metrics
   from rank 0 alone, ``data_state_{0,1}.json``.
   ``python3 chip_smoke.py --only distributed`` runs phase 5 and this one.
25. bench (run after phase 14): ``python -m crfr_torch bench`` and ``bench
   --int8`` at B=256 (``--steps`` cut, in ``reduced``) as child processes,
   alone on the card: ``crfr``'s three keys, ``per_batch_ms`` within 5% of
   the embed and int8_embed phases' ms a batch; one in-process
   ``run_throughput`` of each pipeline with the counters from 0: kernel 1
   once a batch; the CPU yardstick (``measure_cpu_reference``, uncached) on
   the host's cores beside the card's imgs/s where PIL imports (else
   ``"run": false``, not a failure);
26. ms1m (its line after phase 15's): ``python -m crfr_torch.bench.ms1m_fit``
   at C=85,742 in a child beside ``ms1m_scale`` and phase 15 (40 steps at
   batch 64: 2,560 renders; cuts in ``reduced``): exit 0, no
   gap in the metrics stream, ``final_step`` 40, the device step measured
   on this card; ``bench.ms1m_scale`` in this process at the
   full shape (C=85,742, IR-50, B=256, streaming CE, control C=1,000,
   steps cut): the loss finite and falling on its repeated batch, the
   head's marginal ms and the peak memory, kernel 1' once a step.
   ``python3 chip_smoke.py --only bench`` runs phases 3, 14, 25 and 26;
   ``--only bn`` the BN kernels' entry and phases 7, 9 and 12.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and the exit code is
not 0. Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import signal
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
PYRAMID_NAME, CROP_NAME = "fused_pyramid_normalize", "fused_crop_resize_normalize"
BN_NAME = "batch_norm"                 # ops.batch_norm's four kernels, counted together
OFF_PATH = {PYRAMID_NAME: 0, CROP_NAME: 0, BN_NAME: 0}   # off a path unless it says so: the
                                       # ragged forms (the detector's), the train-mode BN
IR50_BN = 4 * 54                       # BN launches an IR-50 train step: 4 a BatchNorm2d
IR50_BNS = ((64, 112, 2), (64, 56, 7), (128, 28, 9), (256, 14, 29), (512, 7, 7))
                                       # IR-50's BN shapes at 112²: (C, side, how many of 54)
BANK_M, BANK_D, BANK_K = 1 << 20, 512, 10
SR_SCALE, SR_B = 8, 256                # the SR phase's batch: the largest power of two
                                       # under ~60 GB (~0.21 GB an image, PERF.md §4)
SR_LOW = S // SR_SCALE


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


SPIN_CYCLES_PER_CALL = 400_000   # ~0.2 ms of a spin kernel per call to enqueue


def cuda_ms(fn, iters: int = 20, warmup: int = 3, spin: int = SPIN_CYCLES_PER_CALL) -> float:
    """Mean device time of one call over ``iters`` back-to-back calls. A
    spin kernel ahead of them (``spin`` cycles a call) holds the device while
    the host enqueues the calls, so the host's own time per call does not
    pace them."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin * iters)
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


_CHILDREN: list[subprocess.Popen] = []      # every child started, for stop_children


def _kill(p: subprocess.Popen) -> None:
    """``p`` and its own children (each child leads a process group)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    p.wait()


def _run_child(argv: list[str], env: dict, timeout: float = 600) -> subprocess.CompletedProcess:
    """``subprocess.run`` of ``argv`` from the checkout's root, recorded so
    that ``stop_children`` ends it if the script fails meanwhile."""
    p = subprocess.Popen(argv, cwd=Path(__file__).resolve().parent, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    _CHILDREN.append(p)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill(p)
        out, err = p.communicate()
    return subprocess.CompletedProcess(argv, p.returncode, out, err)


def stop_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            _kill(p)


class Background:
    """``fn()`` on a thread while the script goes on; ``result()`` waits and
    returns its value or raises its exception. The child processes of the
    correctness phases run so, beside each other or beside in-process work
    that is not timed: their start-ups and host work overlap."""

    def __init__(self, fn):
        self._value, self._error, self.wall_s = None, None, None
        self._thread = threading.Thread(target=self._run, args=(fn,), daemon=True)
        self._thread.start()

    def _run(self, fn) -> None:
        t0 = time.perf_counter()
        try:
            self._value = fn()
        except Exception as e:                # re-raised by result()
            self._error = e
        self.wall_s = time.perf_counter() - t0

    def result(self):
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._value


def children(*argvs: list[str], env: dict, timeout: float = 600) -> Background:
    """``argvs`` as child processes one after another, in the background,
    stopping after the first that fails; → their ``CompletedProcess``es."""
    def run():
        out = []
        for argv in argvs:
            out.append(_run_child(list(argv), env, timeout))
            if out[-1].returncode != 0:
                break
        return out
    return Background(run)


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
    at each band height of ``rows_sweep`` (for an int low, those no taller
    than its plan's, the tallest that fits; for a low per image, every low
    at that height). ``arg`` is a degrade's low, a resize's (oh, ow), or a
    degrade's (B,) int32 tensor of lows in ``LOWS``, one per image; that
    form must also equal, bit for bit, launches of the int form on each
    low's images."""
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
            ms=cuda_ms(call, spin=CROP_SPIN), host_us=host_us(call),
            plain_ms=cuda_ms(lambda: plain(x, arg, mode, out_dtype, **kw), iters=iters),
            library_ms=cuda_ms(library, iters=iters), library_call=library_call,
            bound_ms=bms, bound_by=by, flops=flops, bytes=in_bytes + out_bytes)
        if rows_sweep:
            sweep = {}
            for r in rows_sweep:
                if (which == "fused_degrade_normalize" and not per_image
                        and r > case["plan"]["rows"]):
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


def lows_one_call(fp, x: torch.Tensor, lows: torch.Tensor) -> dict:
    """One call of the form with a low per image at B=512 (its caches
    filled) under ``torch.cuda.set_sync_debug_mode("error")``: it must
    neither read the lows back nor wait on the card, equal the call before
    it, and launch the kernel once (the count set to 0 just before the call
    and read just after)."""
    want = fp.fused_degrade_normalize(x, lows, "pil", torch.bfloat16, lows=LOWS)
    torch.cuda.synchronize()
    fp.fused_degrade_normalize.lows_launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fp.fused_degrade_normalize(x, lows, "pil", torch.bfloat16, lows=LOWS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = fp.fused_degrade_normalize.lows_launches
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{LOWS_NAME}: the call under the sync check differs")
    if launches != 1:
        raise AssertionError(f"{LOWS_NAME}: a call launched the kernel {launches} times, not 1")
    return {"sync_debug_mode": "error", "synchronized": False, "equal": True,
            "launches": launches}


def phase_kernels_lows(fp) -> dict:
    g = torch.Generator(device="cuda").manual_seed(7)
    u8 = torch.randint(0, 256, (TRAIN_B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    lows = torch.randint(LOWS[0], LOWS[1] + 1, (TRAIN_B,), generator=g, device="cuda",
                         dtype=torch.int32)
    # each low at its own height by default; the sweep puts every low at one
    # height (56 rows for all was the plan of old, one CTA an SM)
    which, sweep = "fused_degrade_normalize", (56, 28, 16)
    cases = [kernel_case(fp, which, u8, lows, "pil", torch.bfloat16, True, sweep),
             kernel_case(fp, which, u8.float(), lows, "pil", torch.float32, True, sweep),
             kernel_case(fp, which, u8, lows, "cv2", torch.bfloat16, False),
             kernel_case(fp, which, u8.float(), lows, "cv2", torch.float32, False)]
    for case in cases:
        heights = case["plan"]["rows_by_low"]
        case["plan"]["rows_by_low"] = {str(r): [LOWS[0] + i for i, h in enumerate(heights)
                                                if h == r] for r in sorted(set(heights))}
    plan = {k: cases[0]["plan"][k] for k in ("registers", "spill_bytes", "smem_bytes", "ctas",
                                             "rows", "bands", "ctas_per_sm", "smem_budget",
                                             "rows_by_low")}
    one_call = lows_one_call(fp, u8, lows)
    plan["launches_a_call"] = one_call["launches"]
    return {"name": LOWS_NAME, "route": "cuda",
            "source": "crfr_torch/ops/csrc/fused_preprocess.cu",
            "replaces": "crfr/ops/fused_pallas.py:34",
            "computes": "crfr/train/loop.py:263-278 (the train step's per-image einsum and "
                        "normalize)", "on_main_path": True,
            "cases": cases, "one_call": one_call, **_headline(cases[0]), **plan}


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
    photo, ragged = photo_cases(fp, g)
    resize += photo
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
        *ragged,
    ]


PHOTOS = ((480, 640), (720, 1280))      # (H, W) of the detector's photo cases
PHOTO_MIN_FACE = 20                     # MTCNN's default: the deepest pyramid
BOX = 400                               # a large face box's side, cropped to 24 and 48 px
CROP_BOXES = 223                        # the R-net stage's crops of the 640×480 composite
OLD_PATH_SPIN = 80_000_000              # ~40 ms of spin a call: the host's per-crop loop
                                        # enqueues behind it, so it does not pace the timing
CROP_SPIN = 4_000_000                   # ~2 ms a call: the crop form's host work (~0.5-1.2
                                        # ms a call) enqueues behind it


def old_crops(fp, img: torch.Tensor, boxes: np.ndarray, size: int,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The crops as a launch a crop made them before the crop form: a fill,
    a copy of each box into a zero-padded crop where it leaves the image, and
    one ``fused_resize_normalize`` launch a crop."""
    out = torch.full((len(boxes), size, size, img.shape[2]), -127.5 / 128.0, dtype=out_dtype,
                     device=img.device)
    for i, (x1, y1, x2, y2) in enumerate(boxes.tolist()):
        if x2 > x1 and y2 > y1:
            crop = fp.padded_crop(img, x1, y1, x2, y2).contiguous()[None]
            out[i] = fp.fused_resize_normalize(crop, (size, size), "pil", out_dtype)[0]
    return out


def _ragged_check(name: str, got: list, want: list, exact: list, old: list) -> tuple[float, float]:
    """Each output of a ragged form against its plain version (1e-4), the
    float64 product (2e-3), and the launch of its own (bit for bit)."""
    err = max((g - wn).abs().max().item() for g, wn in zip(got, want))
    err64 = max((g.double() - e).abs().max().item() for g, e in zip(got, exact))
    if not (err <= 1e-4 and err64 <= 2e-3):
        raise AssertionError(f"{name}: max_abs_err {err} (tol 1e-4), vs float64 {err64} "
                             f"(tol 2e-3)")
    differ = [i for i, (g, o) in enumerate(zip(got, old)) if not torch.equal(g, o)]
    if differ:
        raise AssertionError(f"{name}: outputs {differ[:10]} differ from their own launches")
    return err, err64


def pyramid_case(fp, x: torch.Tensor, sizes: list, levels: list[dict]) -> dict:
    """The pyramid form on the photo ``x``: every level in one launch,
    against its plain version, float64 and the per-level launches; timed
    beside its bound, its plain version, the per-level launches (``levels``,
    their cases) and the per-level einsums."""
    _, h, w, c = x.shape
    call = lambda: fp.fused_pyramid_normalize(x, sizes, "pil", torch.float32)  # noqa: E731
    plain = lambda: fp.fused_pyramid_normalize_reference(x, sizes, "pil", torch.float32)  # noqa: E731
    got = call()
    offsets = [g.data_ptr() - got[0].data_ptr() for g in got]
    keys = [fp.operator_key(h, w, tuple(hw), "pil") for hw in sizes]
    exact = []
    for key in keys:
        wr, wc = fp._operators(key, x.device)
        e = torch.einsum("oi,bijc,pj->bopc", wr.double(), x.double(), wc.double())
        exact.append((e - 127.5) / 128.0)
    old = [fp.fused_resize_normalize(x, tuple(hw), "pil", torch.float32) for hw in sizes]
    err, err64 = _ragged_check(f"{PYRAMID_NAME} {w}x{h}", got, plain(), exact, old)
    if not all(g.is_contiguous() and g.shape == (1, *hw, c) for g, hw in zip(got, sizes)):
        raise AssertionError(f"{PYRAMID_NAME}: bad levels {[tuple(g.shape) for g in got]}")
    flops = sum(needed_flops("fused_resize_normalize", 1, c, h, w, tuple(hw), "pil")
                for hw in sizes)
    in_bytes = x.numel() * x.element_size() + operator_bytes(fp, keys)
    out_bytes = sum(g.numel() * 4 for g in got)
    bms, by = bound(in_bytes, out_bytes, flops)
    plan = fp.pyramid_plan(h, w, c, x.element_size(), tuple(map(tuple, sizes)), "pil")
    return {"case": f"{w}x{h} pyramid, {len(sizes)} levels in one launch",
            "shape": [1, h, w, c], "levels": [list(hw) for hw in sizes], "in": "uint8",
            "out": "float32", "max_abs_err": err, "tolerance": 1e-4,
            "max_abs_err_vs_f64": err64, "equals_per_level_launches": True,
            "sums_split_levels": [], "level_offsets": offsets,
            "ms": cuda_ms(call), "host_us": host_us(call),
            "plain_ms": cuda_ms(plain, iters=5),
            "per_level_sum_ms": sum(c["ms"] for c in levels),
            "per_level_ms": [c["ms"] for c in levels],
            "library_ms": sum(c["library_ms"] for c in levels),
            "library_call": "the sum of one torch.einsum('oi,bijc,pj->bopc', Wr, x.float(), "
                            "Wc) a level, each timed alone: no one PyTorch call makes a pyramid",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": in_bytes + out_bytes,
            "plan": {"tiles": len(plan["tiles"]), "tile_shapes": plan["shapes"],
                     "smem_bytes": plan["smem"], **fp.ragged_info(x.dtype, torch.float32)}}


def crop_case(fp, img: torch.Tensor, boxes: np.ndarray, size: int, timed: bool) -> dict:
    """The crop form on ``img``: every box in one launch, against its plain
    version, float64 and the per-crop launches of ``old_crops``; timed
    beside its bound, its plain version, the per-crop path and the
    per-crop einsums when ``timed``."""
    h, w, c = img.shape
    call = lambda: fp.fused_crop_resize_normalize(img, boxes, size, "pil", torch.float32)  # noqa: E731
    plain = lambda: fp.fused_crop_resize_normalize_reference(img, boxes, size, "pil",  # noqa: E731
                                                            torch.float32)
    got = call()
    cw, ch = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    ok = (cw > 0) & (ch > 0)
    pad = int(max(0, -boxes[:, :2].min(), (boxes[:, 2] - w).max(), (boxes[:, 3] - h).max()))
    big = torch.zeros((h + 2 * pad, w + 2 * pad, c), dtype=torch.float64, device=img.device)
    big[pad:pad + h, pad:pad + w] = img.double()
    exact, einsums = [], []
    for (x1, y1, x2, y2), good in zip(boxes.tolist(), ok):
        if not good:
            exact.append(torch.full((size, size, c), -127.5 / 128.0, dtype=torch.float64,
                                    device=img.device))
            continue
        wr, wc = fp._operators(fp.operator_key(y2 - y1, x2 - x1, (size, size), "pil"),
                               img.device)
        crop = big[y1 + pad:y2 + pad, x1 + pad:x2 + pad]
        exact.append((torch.einsum("oi,ijc,pj->opc", wr.double(), crop, wc.double()) - 127.5)
                     / 128.0)
        cf = crop.float()
        einsums.append(lambda wr=wr, wc=wc, cf=cf: torch.einsum("oi,ijc,pj->opc", wr, cf, wc))
    err, err64 = _ragged_check(f"{CROP_NAME} {size} px", list(got), list(plain()), exact,
                               list(old_crops(fp, img, boxes, size)))
    case = {"case": f"{len(boxes)} boxes of a {w}x{h} photo -> {size} px in one launch",
            "shape": [h, w, c], "boxes": len(boxes), "size": size,
            "outside": int(((boxes[:, 0] < 0) | (boxes[:, 1] < 0) | (boxes[:, 2] > w)
                            | (boxes[:, 3] > h)).sum()), "no_area": int((~ok).sum()),
            "in": "uint8", "out": "float32", "max_abs_err": err, "tolerance": 1e-4,
            "max_abs_err_vs_f64": err64, "equals_per_crop_launches": True,
            "plan": {**fp.crop_plan(ch[ok], cw[ok], size, c, 1, "pil"),
                     **fp.ragged_info(img.dtype, torch.float32, crops=True)}}
    if timed:
        sides = {int(v) for v in np.concatenate([cw[ok], ch[ok]])}
        read = np.zeros((h, w), bool)              # the photo's pixels some box covers
        for x1, y1, x2, y2 in boxes[ok].tolist():
            read[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)] = True
        in_bytes = (int(read.sum()) * c * img.element_size() + boxes.nbytes
                    + sum(s.nbytes + t.nbytes for s, t in (fp.band_table(v, size)
                                                           for v in sides)))
        flops = sum(needed_flops("fused_resize_normalize", 1, c, int(y2 - y1), int(x2 - x1),
                                 (size, size), "pil") for x1, y1, x2, y2 in boxes[ok])
        bms, by = bound(in_bytes, got.numel() * 4, flops)
        case.update(
            ms=cuda_ms(call, spin=CROP_SPIN), host_us=host_us(call),
            plain_ms=cuda_ms(plain, iters=2, warmup=1, spin=OLD_PATH_SPIN),
            per_crop_sum_ms=cuda_ms(lambda: old_crops(fp, img, boxes, size), iters=2,
                                    warmup=1, spin=OLD_PATH_SPIN),
            per_crop_path="a fill, a zero-padded copy where the box leaves the photo, one "
                          "fused_resize_normalize launch a crop: the device time of the loop",
            library_ms=cuda_ms(lambda: [f() for f in einsums], iters=2, warmup=1,
                               spin=OLD_PATH_SPIN),
            library_call="the sum of one torch.einsum('oi,ijc,pj->opc', Wr, crop.float(), Wc) "
                         "a crop with area (the crops cut beforehand): no one PyTorch call "
                         "crops and resizes",
            bound_ms=bms, bound_by=by, flops=flops, bytes=in_bytes + got.numel() * 4)
    return case


def photo_cases(fp, g) -> tuple[list[dict], list[dict]]:
    """Kernel 2 at the detector's shapes, uint8 → float32 as ``MTCNN.detect``
    calls it: every pyramid level of a 640×480 and a 1280×720 photo at
    min_face 20 launched alone, and a 400 px box's R- and O-net crops, each
    timed and labelled with its plan (``resample_info``: bands of how many
    rows, or the two-pass plan); then the two ragged forms' entries: each
    photo's pyramid in one launch, and 223 boxes of the 640×480 photo
    (some outside it) cut to 24 px (timed) and 48 px in one launch each."""
    from crfr_torch.bench.ragged_levels import photo_boxes
    from crfr_torch.models.mtcnn import MTCNN

    levels = MTCNN(min_face=PHOTO_MIN_FACE, device="cpu")
    cases, pyramids = [], []
    for h, w in PHOTOS:
        x = torch.randint(0, 256, (1, h, w, 3), generator=g, device="cuda", dtype=torch.uint8)
        sizes = [hw for _, hw in levels.pyramid_sizes(h, w)]
        per = []
        for i, hw in enumerate(sizes):
            c = kernel_case(fp, "fused_resize_normalize", x, hw, "pil", torch.float32, True)
            per.append({"case": f"{w}x{h} pyramid level {i}", **c})
        cases += per
        pyramids.append(pyramid_case(fp, x, sizes, per))
    box = torch.randint(0, 256, (1, BOX, BOX, 3), generator=g, device="cuda", dtype=torch.uint8)
    for side, net in ((24, "R-net"), (48, "O-net")):
        c = kernel_case(fp, "fused_resize_normalize", box, (side, side), "pil", torch.float32,
                        True)
        cases.append({"case": f"{BOX} px box, {net} crop", **c})
    for c in cases:
        c["plan_taken"] = (c["plan"]["plan"] if c["plan"]["plan"] == "two_pass"
                           else f"bands of {c['plan']['rows']} rows")
    h, w = PHOTOS[0]
    img = torch.randint(0, 256, (h, w, 3), generator=g, device="cuda", dtype=torch.uint8)
    boxes = photo_boxes(CROP_BOXES, h, w)
    crops = [crop_case(fp, img, boxes, 24, True), crop_case(fp, img, boxes, 48, False),
             crop_case(fp, img.float(), boxes[:40], 24, False)]
    crops[-1].update(case=f"40 boxes of a float32 {w}x{h} photo -> 24 px", **{"in": "float32"})
    src = "crfr_torch/ops/csrc/fused_preprocess.cu"
    replaces = "crfr/ops/fused_pallas.py:93"
    return cases, [
        {"name": PYRAMID_NAME, "route": "cuda", "source": src, "replaces": replaces,
         "computes": "crfr/models/mtcnn.py:294 (a native bicubic resize a level)",
         "on_main_path": True, "cases": pyramids, **_headline(pyramids[0])},
        {"name": CROP_NAME, "route": "cuda", "source": src, "replaces": replaces,
         "computes": "crfr/models/mtcnn.py:206-228 (crop_resize)", "on_main_path": True,
         "cases": crops, **_headline(crops[0])}]


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


BN_PASSES = (("stats", 1), ("transform", 2), ("backward_reduce", 2), ("backward_apply", 3))
                                       # each pass's elements moved an element of x
BN_SPIN = 20_000_000                   # ~11 ms a call: the host's issue of a forward and
                                       # backward (~0.5-1 ms) enqueues behind it


def _bn_args(b: int, c: int, side: int, seed: int) -> dict:
    """bf16 x (a mean of up to ±3 a channel, so the variance comes out of
    E[x²] − E[x]² with some cancellation) and dy, channels_last; float32
    weight, bias and running statistics away from 1 and 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn(b, c, side, side, generator=g, device="cuda") * 2 \
        + 3 * torch.rand(1, c, 1, 1, generator=g, device="cuda")
    dy = torch.randn(b, c, side, side, generator=g, device="cuda")
    return {"x": x.bfloat16().contiguous(memory_format=cl),
            "dy": dy.bfloat16().contiguous(memory_format=cl),
            "w": torch.rand(c, generator=g, device="cuda") + 0.5,
            "b": torch.randn(c, generator=g, device="cuda"),
            "rm": torch.randn(c, generator=g, device="cuda"),
            "rv": torch.rand(c, generator=g, device="cuda") + 0.5}


def _bn_step(fn, a: dict):
    """A forward and backward of ``fn`` on ``a`` (fresh leaves, the running
    statistics moved in copies): → run() and its (y, dx, dw, db, rm, rv)."""
    x = a["x"].detach().requires_grad_(True)
    w, b = a["w"].detach().requires_grad_(True), a["b"].detach().requires_grad_(True)
    rm, rv = a["rm"].clone(), a["rv"].clone()

    def run():
        x.grad = w.grad = b.grad = None
        y = fn(x, w, b, rm, rv, 0.1, 1e-5)
        y.backward(a["dy"])
        return y

    y = run()
    return run, (y.detach(), x.grad, w.grad, b.grad, rm, rv)


def _bn_exact(a: dict) -> tuple:
    """The same forward and backward in float64 on the card."""
    x, dy = a["x"].double(), a["dy"].double()
    dims, shape = (0, 2, 3), (1, -1, 1, 1)
    n = x.numel() // x.shape[1]
    mean, var = x.mean(dims), x.var(dims, unbiased=False)
    invstd = (var + 1e-5).rsqrt()
    xhat = (x - mean.view(shape)) * invstd.view(shape)
    del x
    db, dw = dy.sum(dims), (dy * xhat).sum(dims)
    w = a["w"].double()
    y = xhat * w.view(shape) + a["b"].double().view(shape)
    dx = (dy - (db / n).view(shape) - xhat * (dw / n).view(shape)) * (w * invstd).view(shape)
    scale = {"dw": (dy * xhat).abs().sum(dims), "db": dy.abs().sum(dims),
             "running_mean": a["x"].double().abs().mean(dims).max(),
             "running_var": a["x"].double().square().mean(dims).max()}
    return (y, dx, dw, db, 0.9 * a["rm"].double() + 0.1 * mean,
            0.9 * a["rv"].double() + 0.1 * var), scale


def _bn_errors(got: tuple, want: tuple, scale: dict) -> dict:
    """Each output's largest error, as a share of its tolerance (≤ 1 passes):
    y and dx in bf16 within one bf16 ulp (rtol 2⁻⁷, twice the rounding's
    half ulp) and 1e-4 of the largest |value| (the values that cancel); dw
    and db, float32 sums over the rows, within 1e-5 of their channel's sum
    of |terms|; the running statistics within rtol 1e-5 and 1e-6 of the
    largest E|x| (E[x²]), where ``new = 0.9·old + 0.1·batch`` cancels."""
    out = {}
    for name, g, w in zip(("y", "dx", "dw", "db", "running_mean", "running_var"), got, want):
        err = (g.double() - w.double()).abs()
        if name in ("y", "dx"):
            tol = 2 ** -7 * w.double().abs() + 1e-4 * w.double().abs().max()
        elif name in ("dw", "db"):
            tol = 1e-5 * scale[name]
        else:
            tol = 1e-5 * w.double().abs() + 1e-6 * scale[name]
        out[name] = {"max_abs_err": err.max().item(), "worst_share_of_tol":
                     (err / tol).max().item()}
        del err, tol
    return out


def _bn_kernel_us(run, flush, iters: int) -> dict[str, float]:
    """Device µs a call of each kernel whose name holds ``batch_norm``, from
    a ``torch.profiler`` trace, the L2 overwritten before each call."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        with open(os.path.join(d, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    out: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel" and "batch_norm" in e.get("name", ""):
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / iters
    return out


def _bn_call_ms(run, flush, iters: int) -> tuple[float, float]:
    """(device ms, host µs) of a call: each after the L2 is overwritten,
    as in a train step where other layers run between two BNs, behind a
    spin, so that the host's issue does not pace the device."""
    dev_ms = host_s = 0.0
    for _ in range(iters):
        flush()
        torch.cuda._sleep(BN_SPIN)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        run()
        host_s += time.perf_counter() - t0
        end.record()
        end.synchronize()
        dev_ms += start.elapsed_time(end)
    return dev_ms / iters, 1e6 * host_s / iters


def bn_case(bn_op, c: int, side: int, count: int, flush, iters: int = 10) -> dict:
    """One of IR-50's BN shapes at B=512 in bf16: ``ops.batch_norm``'s
    forward and backward (its four kernels) against its plain version
    (``batch_norm_reference``: ATen's kernels, the running variance
    rescaled) and float64, then timed beside the plain version, ATen's
    ``F.batch_norm`` alone (the library) and each pass's bound (its bytes
    at 3.35 TB/s)."""
    import torch.nn.functional as F

    def library(x, w, b, rm, rv, m, eps):
        return F.batch_norm(x, rm, rv, w, b, True, m, eps)

    a = _bn_args(TRAIN_B, c, side, seed=c + side)
    rows = a["x"].numel() // c
    before = bn_op.batch_norm.launches
    run, got = _bn_step(bn_op.batch_norm, a)
    torch.cuda.synchronize()
    launches = bn_op.batch_norm.launches - before
    plain_run, plain = _bn_step(bn_op.batch_norm_reference, a)
    exact, scale = _bn_exact(a)
    errs = {"vs_f64": _bn_errors(got, exact, scale),
            "plain_vs_f64": _bn_errors(plain, exact, scale)}
    del exact, scale
    vs_plain = {k: (g.float() - p.float()).abs().max().item()
                for k, g, p in zip(("y", "dx", "dw", "db"), got, plain)}
    worst = max(e["worst_share_of_tol"] for e in errs["vs_f64"].values())
    if launches != 4 or not worst <= 1.0:
        raise AssertionError(f"batch_norm {c}x{side}² at B={TRAIN_B}: {launches} launches, "
                             f"errors against float64 {errs['vs_f64']}")
    case = {"shape": [TRAIN_B, c, side, side], "dtype": "bfloat16", "rows": rows,
            "count_in_ir50": count, "launches": launches, "plan": list(bn_op._plan(a["x"])),
            "max_abs_err": max(vs_plain.values()), "max_abs_err_vs_plain": vs_plain,
            "errors": errs, "bound_by": "bytes"}
    for tag, fn in (("", run), ("plain_", plain_run),
                    ("library_", _bn_step(library, a)[0])):
        for _ in range(3):
            fn()
        case[f"{tag}ms"], case[f"{tag}host_us"] = _bn_call_ms(fn, flush, iters)
        case[f"{tag}kernel_us"] = _bn_kernel_us(fn, flush, iters)
    case["bound_us"] = {p: 1e6 * k * rows * c * a["x"].element_size() / PEAK_BYTES_PER_S
                        for p, k in BN_PASSES}
    case["bound_ms"] = sum(case["bound_us"].values()) / 1e3
    return case


def phase_kernels_bn() -> dict:
    """The train-mode BN's four kernels at IR-50's five BN shapes at B=512
    (``bn_case``), and the step's sums: each shape's numbers times its
    count among IR-50's 54 BatchNorm2d."""
    from crfr_torch.ops import batch_norm as bn_op

    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    cases = []
    for c, side, count in IR50_BNS:
        cases.append(bn_case(bn_op, c, side, count, lambda: scrub.fill_(1)))
        torch.cuda.empty_cache()

    def total(key):
        return sum(cs[key] * cs["count_in_ir50"] for cs in cases)

    def by_kernel(key, names):
        return {p: sum(us * cs["count_in_ir50"] for cs in cases for n, us in cs[key].items()
                       if f"crfr_batch_norm_{p}_kernel" in n.split("<")[0]) / 1e3
                for p in names}

    passes = [p for p, _ in BN_PASSES]
    step = {"max_abs_err": max(cs["max_abs_err"] for cs in cases), "ms": total("ms"),
            "plain_ms": total("plain_ms"), "library_ms": total("library_ms"),
            "bound_ms": total("bound_ms"), "bound_by": "bytes",
            "host_us": total("host_us"), "plain_host_us": total("plain_host_us"),
            "library_host_us": total("library_host_us")}
    step["ms_by_pass"] = by_kernel("kernel_us", passes)
    step["bound_ms_by_pass"] = {p: sum(cs["bound_us"][p] * cs["count_in_ir50"]
                                       for cs in cases) / 1e3 for p in passes}
    library_kernels: dict[str, float] = {}
    for cs in cases:
        for n, us in cs["library_kernel_us"].items():
            library_kernels[n] = library_kernels.get(n, 0.0) + us * cs["count_in_ir50"] / 1e3
    step["library_kernel_ms"] = library_kernels
    if sorted(k for k, v in step["ms_by_pass"].items() if v > 0) != sorted(passes):
        raise AssertionError(f"batch_norm: the trace lacks a pass: {step['ms_by_pass']}, "
                             f"kernels {sorted(cases[0]['kernel_us'])}")
    return {"name": BN_NAME, "route": "cuda", "source": "crfr_torch/ops/csrc/batch_norm.cu",
            "replaces": None, "computes": "crfr/models/irse.py:86-154 (nnx.BatchNorm in train "
                                          "mode, compiled by XLA)",
            "on_main_path": True, "case": "IR-50's 54 BatchNorm2d of a train step at B=512, "
                                          "bf16, forward and backward",
            "cases": cases, **_headline(step), "step": step}


def _headline(case: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = {k: case[k] for k in keys}
    out["kernel_ms"] = case["ms"]
    return out


def _counts(fp) -> dict:
    from crfr_torch.ops import batch_norm as bn_op

    return {"fused_degrade_normalize": fp.fused_degrade_normalize.launches,
            LOWS_NAME: fp.fused_degrade_normalize.lows_launches,
            "fused_resize_normalize": fp.fused_resize_normalize.launches,
            PYRAMID_NAME: fp.fused_resize_normalize.pyramid_launches,
            CROP_NAME: fp.fused_resize_normalize.crop_launches,
            BN_NAME: bn_op.batch_norm.launches}


def _only(name: str) -> dict:
    """The launch counts of a path that launches kernel ``name`` once and no
    other."""
    return {**{k: 0 for k in (*OFF_PATH, "fused_degrade_normalize", LOWS_NAME,
                              "fused_resize_normalize")}, name: 1}


def _zero_counts(fp) -> None:
    from crfr_torch.ops import batch_norm as bn_op

    bn_op.batch_norm.launches = 0
    fp.fused_degrade_normalize.launches = 0
    fp.fused_degrade_normalize.lows_launches = 0
    fp.fused_resize_normalize.launches = 0
    fp.fused_resize_normalize.pyramid_launches = 0
    fp.fused_resize_normalize.crop_launches = 0


@contextlib.contextmanager
def bn_calls():
    """Counts, while open, the calls of ``irse.BatchNorm2d`` that its
    kernels should take (train mode, on the card, one rank's batch) and the
    backward passes through their outputs: ``bn_launches`` of them is what
    ``batch_norm.launches`` must read, 2 a forward and 2 a backward."""
    from crfr_torch.models import irse

    calls = {"forward": 0, "backward": 0}
    plain = irse.BatchNorm2d.forward

    def backward(_grad):
        calls["backward"] += 1

    def counted(self, x):
        y = plain(self, x)
        if self.training and x.is_cuda and not self.global_stats:
            calls["forward"] += 1
            if y.requires_grad:
                y.register_hook(backward)
        return y

    irse.BatchNorm2d.forward = counted
    try:
        yield calls
    finally:
        del irse.BatchNorm2d.forward


def bn_launches(calls: dict) -> int:
    return 2 * (calls["forward"] + calls["backward"])


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


GALLERY_REF: dict = {}                 # the one-process fused scan, for phase 24


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
    GALLERY_REF.update(probes=probes, planted=planted, s=s_f, l=l_f)   # for phase 24

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
    if launches != {"fused_degrade_normalize": 0, LOWS_NAME: 1, "fused_resize_normalize": 0,
                    **OFF_PATH, BN_NAME: IR50_BN}:
        raise AssertionError(f"train: one step launched {launches}, want one degrade with a "
                             f"low per image and the BN kernels 4 times a BatchNorm2d")
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


def start_cli() -> dict:
    """The train CLI for 6 steps, then resumed to 9, in child processes one
    after the other, in the background (beside the train_eval phase)."""
    tmp = tempfile.mkdtemp()
    ov = [*CLI_OV, "train.checkpoint_every_steps=3", f"train.checkpoint_dir={tmp}/ck"]
    cmd = [sys.executable, "-m", "crfr_torch", "train", "--preset", "casia_arcface", *ov]
    return {"tmp": tmp, "ov": ov, "runs": children([*cmd, "--max-steps", "6"],
                                                   [*cmd, "--max-steps", "9", "--resume"],
                                                   env=_child_env())}


def phase_cli(started: dict) -> dict:
    """``start_cli``'s runs: ``{"final_step": 6}``, then a resume at 6 that
    ends at 9; a trainer restored from step 6 equals the saved state."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    tmp, ov = started["tmp"], started["ov"]
    try:
        runs = started["runs"].result()
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"cli: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-4000:]}")
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "cli", "final_steps": [f["final_step"] for f in finals],
            "resumed_from": 6, "checkpoints": steps, "restored_equals_saved": True,
            "wall_s_two_runs": started["runs"].wall_s}


CLI_OV = ["data.num_classes=64", "train.batch_size=64"]     # phase_cli's cut of the preset


def _cli_json(argv: list[str]) -> tuple[dict, str]:
    """``crfr_torch.cli.main(argv)`` in this process: its last JSON line and
    all it printed (the metrics lines)."""
    import contextlib

    from crfr_torch.cli import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]}: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), out.getvalue()


def phase_train_eval(fp) -> dict:
    """``train --eval-bin`` in this process on a ``.crfrpack`` of
    ``soak._build_pack`` and a ``.bin`` of 600 hard-rendered pairs
    (``RenderedIdentities``: ``soak._build_eval_bin``'s synthetic pairs
    read accuracy 1.0 and EER 0 at any step, which would make the equality
    below vacuous), 6 steps with an eval every 3 degraded to 16 px: eval lines at
    steps 3 and 6, kernel 1′ once a step and kernel 1 once an eval batch
    (counted from 0 just before the command, read just after); then
    ``eval-bin --ckpt`` on the step-6 checkpoint equals the in-loop eval of
    step 6."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return {"phase": "train_eval", "run": False, "why": "PIL not installed"}
    from crfr_torch.bench.soak import _build_pack
    from crfr_torch.configs import get_config
    from crfr_torch.data.bins import save_bin
    from crfr_torch.data.render import RenderedIdentities

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _build_pack(f"{tmp}/train.crfrpack", 64, 8, S)
        i1, i2, same = RenderedIdentities(64, S, seed=7).eval_pairs(   # 300 + 300 pairs
            np.random.default_rng(7), 300)
        save_bin(f"{tmp}/pairs.bin", i1.astype(np.uint8), i2.astype(np.uint8), same)
        fixtures_s = time.perf_counter() - t0
        argv = ["train", "--preset", "casia_arcface", *CLI_OV, "--train-records",
                f"{tmp}/train.crfrpack", "--eval-bin", f"{tmp}/pairs.bin", "--max-steps", "6",
                "train.eval_every_steps=3", "train.checkpoint_every_steps=3",
                f"data.eval_degrade_size={LOW}", f"train.checkpoint_dir={tmp}/ck"]
        _zero_counts(fp)
        t0 = time.perf_counter()
        final, printed = _cli_json(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(fp)
        rows = [json.loads(r) for r in printed.splitlines() if r.startswith('{"step"')]
        evals = {r["step"]: r for r in rows if "eval_accuracy" in r}
        eval_b = min(get_config("casia_arcface").eval.batch_size, 600)
        per_eval = 2 * -(-600 // eval_b)                     # both sides of the pairs
        want = {"fused_degrade_normalize": 2 * per_eval, LOWS_NAME: 6,
                "fused_resize_normalize": 0, **OFF_PATH, BN_NAME: 6 * IR50_BN}
        if final != {"final_step": 6} or sorted(evals) != [3, 6] or launches != want:
            raise AssertionError(f"train_eval: {final}, eval steps {sorted(evals)}, "
                                 f"launches {launches}, want {want}")
        again, _ = _cli_json(["eval-bin", "--ckpt", f"{tmp}/ck", "--bin", f"{tmp}/pairs.bin"])
        got = (evals[6]["eval_accuracy"], evals[6]["eval_eer"])
        if (again["accuracy"], again["eer"]) != got:
            raise AssertionError(f"train_eval: in-loop step 6 {got} != eval-bin --ckpt "
                                 f"{(again['accuracy'], again['eer'])}")
    return {"phase": "train_eval", "run": True, "launches": launches,
            "eval_batches_per_eval": per_eval,
            "evals": {s: [r["eval_accuracy"], r["eval_eer"]] for s, r in evals.items()},
            "eval_bin_of_step_6": [again["accuracy"], again["eer"]],
            "in_loop_equals_eval_bin": True, "wall_s": wall, "fixtures_s": fixtures_s}


def _max_diff(a: dict, b: dict) -> float:
    return max((v.float() - b["model"][k].float()).abs().max().item()
               for k, v in a["model"].items())


def phase_recycle() -> dict:
    """``python -m crfr_torch train --max-steps 9 --recycle-every-steps 3`` in
    a child: recycles at (3, 1) and (6, 2), "resumed from step 3" and "... 6"
    in its stderr, ``{"final_step": 9}``, steps 1..9 logged once each; two
    straight 9-step runs in this process while the child runs. The chain's
    final state equals the first's bit for bit, or is no further from it
    than the second straight run is (cuDNN's backward may not be
    deterministic); both maxima printed."""
    from crfr_torch.train.checkpoints import Checkpointer

    with tempfile.TemporaryDirectory() as tmp:
        base = ["train", "--preset", "casia_arcface", *CLI_OV, "--max-steps", "9",
                "train.checkpoint_every_steps=100", "train.log_every=1"]
        env = _child_env()
        env.pop("CRFR_RECYCLE_GEN", None)
        chain_run = children([sys.executable, "-m", "crfr_torch", *base, "--recycle-every-steps",
                              "3", f"train.checkpoint_dir={tmp}/chain"], env=env)
        straight = []
        for run in ("a", "b"):
            _cli_json([*base, f"train.checkpoint_dir={tmp}/{run}"])
            straight.append(Checkpointer(f"{tmp}/{run}").restore(step=9))
        r = chain_run.result()[0]
        if r.returncode != 0:
            raise AssertionError(f"recycle: exit {r.returncode}\n{r.stderr[-4000:]}")
        recs = [json.loads(line) for line in open(f"{tmp}/chain/recycles.jsonl")]
        steps = [json.loads(line)["step"] for line in open(f"{tmp}/chain/metrics.jsonl")
                 if '"loss"' in line]
        final = json.loads(r.stdout.strip().splitlines()[-1])
        if ([(x["step"], x["gen"]) for x in recs] != [(3, 1), (6, 2)]
                or "resumed from step 3" not in r.stderr or "resumed from step 6" not in r.stderr
                or final != {"final_step": 9} or steps != list(range(1, 10))):
            raise AssertionError(f"recycle: records {recs}, final {final}, steps {steps}, "
                                 f"stderr {r.stderr[-1500:]}")
        chain = Checkpointer(f"{tmp}/chain").restore(step=9)
        bitwise = _state_equal(chain, straight[0])
        chain_vs_straight = _max_diff(chain, straight[0])
        straight_vs_straight = _max_diff(straight[0], straight[1])
        if not bitwise and chain_vs_straight > straight_vs_straight:
            raise AssertionError(f"recycle: the chain is {chain_vs_straight} from a straight "
                                 f"run, two straight runs {straight_vs_straight} apart")
    return {"phase": "recycle", "records": recs, "final_step": 9, "generations": 3,
            "chain_equals_straight_bitwise": bitwise,
            "chain_vs_straight_max_abs": chain_vs_straight,
            "straight_vs_straight_max_abs": straight_vs_straight,
            "max_cuda_mb": [x.get("max_cuda_mb") for x in recs], "chain_wall_s": chain_run.wall_s}


def phase_soak(fp) -> dict:
    """``bench.soak`` at IR-50, batch 256, 112², 120 steps of the production
    path on a 200 × 40-image pack, an eval and a checkpoint at step 100; the
    kernel launches of the whole soak counted from 0 just before it (kernel
    1′ once a train step: the soak's 120, the step-only ceiling's 31 and
    the two traced windows' 46; kernel 1 once an eval batch: six)."""
    from crfr_torch.bench import soak

    with tempfile.TemporaryDirectory() as tmp:
        args = soak.parse_args(["--steps", "120", "--warm-steps", "20", "--batch", "256",
                                "--classes", "200", "--per-class", "40", "--eval-every", "100",
                                "--ckpt-every", "100", "--workdir", tmp])
        _zero_counts(fp)
        t0 = time.perf_counter()
        out = soak.run_soak(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(fp)
    # 120 soak steps, the step-only ceiling's 1 + 30, and the traced windows'
    # 2 × (3 + 10 + 10); one eval: both sides of 600 pairs at batch 256
    want = {"fused_degrade_normalize": 2 * -(-600 // 256), LOWS_NAME: 120 + 31 + 46,
            "fused_resize_normalize": 0, **OFF_PATH, BN_NAME: (120 + 31 + 46) * IR50_BN}
    if launches != want or len(out["eval_accuracy"]) != 1 or not np.isfinite(out["final_loss"]):
        raise AssertionError(f"soak: launches {launches}, want {want}; {out}")
    out.pop("workdir")
    return {"phase": "soak", **out, "launches": launches, "wall_s": wall}


def start_schedule_soak() -> dict:
    """``python -m crfr_torch.bench.schedule_soak --smoke --device cuda`` in a
    child, in the background (beside the recycle phase)."""
    tmp = tempfile.mkdtemp()
    return {"tmp": tmp, "run": children([sys.executable, "-m", "crfr_torch.bench.schedule_soak",
                                         "--smoke", "--device", "cuda", "--workdir", tmp],
                                        env=_child_env())}


def phase_schedule_soak(started: dict) -> dict:
    """``start_schedule_soak``'s child (its ``train`` child recycles twice):
    exit 0, recycles at (20, 1) and (40, 2), a stream with no gap ending at
    step 48, the warmup and both drops as configured, and ``analyze``'s
    keys."""
    try:
        r = started["run"].result()[0]
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    if r.returncode != 0:
        raise AssertionError(f"schedule_soak: exit {r.returncode}\n{r.stderr[-4000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    keys = {"steps_logged", "final_step", "expected_final_step", "continuity_gaps",
            "warmup_ok", "drops", "loss_per_epoch", "eval_trajectory", "recycles", "bn_drift"}
    if (not keys <= set(res) or [(x["step"], x["gen"]) for x in res["recycles"]]
            != [(20, 1), (40, 2)] or res["continuity_gaps"] or res["final_step"] != 48
            or not res["warmup_ok"] or not all(d["lr_ok"] for d in res["drops"])):
        raise AssertionError(f"schedule_soak: {res}")
    return {"phase": "schedule_soak", "wall_s": started["run"].wall_s, **res}


def phase_debug() -> dict:
    """``utils.debug`` and ``utils.profiling`` on the card: inside
    ``no_host_transfers`` ``.item()`` and ``.cpu()`` of a CUDA tensor raise,
    after it they work; ``debug_mode(nans=True)`` raises on a CUDA ``log`` of
    a negative value, naming the op; ``trace`` writes a trace holding the
    ``annotate`` span and a kernel; ``timed`` fences a CUDA result."""
    from crfr_torch.utils import profiling
    from crfr_torch.utils.debug import debug_mode, no_host_transfers

    t = torch.arange(4.0, device="cuda")
    raised = []
    for name, fn in (("item", lambda: t.sum().item()), ("cpu", lambda: t.cpu())):
        try:
            with no_host_transfers():
                fn()
        except RuntimeError as e:
            raised.append((name, str(e).splitlines()[0][:80]))
    after = (t.sum().item(), t.cpu().tolist())
    if [n for n, _ in raised] != ["item", "cpu"] or after != (6.0, [0.0, 1.0, 2.0, 3.0]):
        raise AssertionError(f"debug: no_host_transfers raised {raised}, after {after}")
    try:
        with debug_mode(nans=True):
            torch.log(torch.tensor([-1.0], device="cuda"))
        nan_error = None
    except FloatingPointError as e:
        nan_error = str(e)
    if not nan_error or "aten.log" not in nan_error:
        raise AssertionError(f"debug: debug_mode(nans=True) gave {nan_error!r}")
    # A trace of two small kernels taken after other profiler sessions in
    # this process (the soak's) held no kernel events, where the first
    # session of a process holds them: so this phase runs before the soak,
    # on 20 products of 1024² matrices
    a = torch.randn(1024, 1024, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            with profiling.annotate("crfr_smoke_span"):
                for _ in range(20):
                    a = (a @ a).tanh()
                torch.cuda.synchronize()
        events = json.load(open(prof.trace_path))["traceEvents"]
    span = any(e.get("name") == "crfr_smoke_span" for e in events)
    kernels = sum(e.get("cat") == "kernel" for e in events)
    sec, _ = profiling.timed(lambda: torch.randn(2048, 2048, device="cuda") @
                             torch.randn(2048, 2048, device="cuda"), iters=5)
    if not (span and kernels and sec > 0):
        raise AssertionError(f"debug: span {span}, kernels {kernels}, timed {sec}")
    return {"phase": "debug", "no_host_transfers_raised": raised, "nan_error": nan_error,
            "trace_span": span, "trace_kernels": kernels, "timed_2048_matmul_ms": 1e3 * sec}


def phase_roofline(embed: dict) -> dict:
    """``bench.roofline`` at the embed phase's batch (IR-50, 256, bf16): its
    measured ms a batch against the summed per-layer bound; and a traced
    train step at the train phase's batch (``xprof_check.trace_train``:
    casia_arcface, 512, 3 steps) with each group's time against
    ``train_step_bounds`` (BN and PReLU by bytes, convs by FLOPs)."""
    from crfr_torch.bench.roofline import (group_bounds, ir_layer_bounds, summarize,
                                           train_step_bounds)
    from crfr_torch.bench.xprof_check import trace_train

    s = summarize(ir_layer_bounds("50", B, S))
    groups = group_bounds(train_step_bounds("50", TRAIN_B, S))
    tr = trace_train(TRAIN_B, 3, "ir_50")
    torch.cuda.empty_cache()
    keys = ("fwd_conv_bound_ms", "train_conv_bound_3x_fwd_ms", "conv_over_3x_bound",
            "dispatch_gap_ms", "group_bound_ms", "group_over_bound", "wall_ms_per_step",
            "device_busy_ms_per_step", "idle_share_traced", "group_ms_per_step")
    return {"phase": "roofline",
            "embed": {"batch": B, "bound_ms": 1e3 * s.bound_s, "flops_bound_ms":
                      1e3 * s.t_flops_ideal_s, "bytes_bound_ms": 1e3 * s.t_mem_s,
                      "measured_ms": embed["ms_per_batch"],
                      "attainment": s.attainment(embed["ms_per_batch"] / 1e3),
                      "mfu_bf16": s.mfu(embed["ms_per_batch"] / 1e3)},
            "train": {"batch": TRAIN_B, "bound_ms_by_group": {k: 1e3 * v
                                                              for k, v in groups.items()},
                      **{k: tr[k] for k in keys}}}


SR_ONE_RESIZE = {"fused_degrade_normalize": 0, LOWS_NAME: 0, "fused_resize_normalize": 1, **OFF_PATH}


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
    with bn_calls() as calls:
        m = tr.train_step(x)
    torch.cuda.synchronize()
    launches = _counts(fp)
    g_loss, d_loss = m["g_loss"].item(), m["d_loss"].item()
    changed = {n: sum(not torch.equal(v, dict(getattr(tr, n).named_parameters())[k])
                      for k, v in before[n].items()) for n in ("g", "d")}
    ema_apart = sum(not torch.equal(a, b) for a, b in zip(tr.g_ema.parameters(),
                                                            tr.g.parameters()))
    want = {**SR_ONE_RESIZE, BN_NAME: bn_launches(calls)}
    if launches != want or not calls["forward"]:
        raise AssertionError(f"sr_train: one step launched {launches}, want one resize and "
                             f"the BN kernels for G's and D's {calls} BatchNorm2d calls")
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


def start_sr_cli() -> dict:
    """``train-sr`` for 4 steps, then resumed to 6, in child processes one
    after the other, in the background (beside the distill_cli phase)."""
    tmp = tempfile.mkdtemp()
    # 64 synthetic identities (the labels go unused) in place of the
    # preset's 10,572 prototypes, which take most of a run to draw
    ov = ["data.num_classes=64", "train.batch_size=16", "train.checkpoint_every_steps=2",
          f"train.checkpoint_dir={tmp}/ck"]
    cmd = [sys.executable, "-m", "crfr_torch", "train-sr", "--preset", "casia_arcface",
           "--scale", str(SR_SCALE), *ov]
    return {"tmp": tmp, "ov": ov, "runs": children([*cmd, "--max-steps", "4"],
                                                   [*cmd, "--max-steps", "6", "--resume"],
                                                   env=_child_env())}


def phase_sr_cli(started: dict) -> dict:
    """``start_sr_cli``'s runs: 4 steps, then a resume at 4 that ends at 6;
    a trainer restored from step 4 equals the saved state bit for bit."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.sr_loop import SRTrainer

    tmp, ov = started["tmp"], started["ov"]
    try:
        runs = started["runs"].result()
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"sr_cli: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-4000:]}")
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "sr_cli", "final": finals[-1], "steps": [f["steps"] for f in finals],
            "resumed_from": 4, "checkpoints": steps, "restored_equals_saved": True,
            "wall_s_two_runs": started["runs"].wall_s}


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
        with bn_calls() as calls:
            m = st.train_step(xb, yb)
        torch.cuda.synchronize()
        launches = _counts(fp)
        metrics = {k: v.item() for k, v in m.items()}
        changed = sum(not torch.equal(before[k], v) for k, v in st.model.named_parameters())
        del before
        want = ({"fused_degrade_normalize": 0, LOWS_NAME: 1, "fused_resize_normalize": 0, **OFF_PATH}
                if path == "bicubic" else SR_ONE_RESIZE)
        # the student's 54 BatchNorm2d, and G's where it trains
        want = {**want, BN_NAME: bn_launches(calls)}
        if launches != want or (path != "joint_g" and want[BN_NAME] != IR50_BN):
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
    """``train`` for 2 steps in this process (the teacher), then in child
    processes with cuDNN's deterministic algorithms, side by side:
    ``train-distill`` for 4 steps and ``--resume`` to 6, 6 straight, and 2
    steps with a frozen G from an SR checkpoint (``--sr-ckpt``)."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.sr_loop import SRTrainer

    env = {**_child_env(), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    launcher = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
                "from crfr_torch.cli import main; sys.exit(main(sys.argv[1:]))")
    with tempfile.TemporaryDirectory() as tmp:
        ov = ["data.num_classes=64", "train.batch_size=16", "train.checkpoint_every_steps=2",
              "loss.distill_weight=0.05", "train.grad_clip_norm=5.0"]
        cfg = get_config("casia_arcface", ov)
        Checkpointer(f"{tmp}/sr").save(0, SRTrainer(cfg, scale=SR_SCALE, device="cuda")
                                       .state_dict(), cfg.to_json())
        t0 = time.perf_counter()
        _cli_json(["train", "--preset", "casia_arcface", *ov, f"train.checkpoint_dir={tmp}/t",
                   "--max-steps", "2"])
        base = [sys.executable, "-c", launcher, "train-distill", "--preset", "casia_arcface",
                "--teacher-ckpt", f"{tmp}/t", *ov]
        chain = children([*base, f"train.checkpoint_dir={tmp}/a", "--max-steps", "4"],
                         [*base, f"train.checkpoint_dir={tmp}/a", "--max-steps", "6", "--resume"],
                         env=env)
        straight_run = children([*base, f"train.checkpoint_dir={tmp}/b", "--max-steps", "6"],
                                env=env)
        sr_run = children([*base, f"train.checkpoint_dir={tmp}/c", "--max-steps", "2",
                           "--sr-ckpt", f"{tmp}/sr", "--sr-scale", str(SR_SCALE)], env=env)
        runs = chain.result() + straight_run.result() + sr_run.result()
        wall = time.perf_counter() - t0
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"distill_cli: {r.args[3:4]} exit {r.returncode}\n"
                                     f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        finals = [json.loads(r.stdout.strip().splitlines()[-1]) for r in runs[:3]]
        sr = json.loads(runs[3].stdout.strip().splitlines()[-1])
        if [f["steps"] for f in finals] != [4, 6, 6] or sr["steps"] != 2 \
                or "resumed student from step 4" not in runs[1].stderr \
                or not all(np.isfinite(f["loss"]) for f in finals + [sr]):
            raise AssertionError(f"distill_cli: {finals}, {sr}, resumed run's stderr "
                                 f"{runs[1].stderr[-500:]}")
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
    want = {"fused_degrade_normalize": 1, LOWS_NAME: 0, "fused_resize_normalize": 0, **OFF_PATH}
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


BENCH_STEPS = 10          # bench's --steps: crfr's 30 cut to 10 (three windows of 10 batches)
BENCH_KEYS = {"imgs_per_sec", "per_batch_ms", "int8"}       # crfr's line, crfr/cli.py:1028-1030


def phase_bench(fp, embed: dict, int8_embed: dict) -> dict:
    """``python -m crfr_torch bench`` and ``bench --int8`` at B=256 in child
    processes, one after the other with nothing beside them: ``crfr``'s
    keys, ``per_batch_ms`` within 5% of the embed and int8_embed phases'
    in-process ms a batch of the same pipeline; one in-process
    ``run_throughput`` of each (steps 2, one window) with the counters from
    0 just before it: kernel 1 once a batch; and the CPU yardstick
    (``bench.torch_reference.measure_cpu_reference``, uncached) on the
    host's cores beside the card's imgs/s, where PIL imports."""
    from crfr_torch.bench.throughput import run_throughput

    out = {}
    for int8 in (False, True):
        name = "int8" if int8 else "bf16"
        r = _run_child([sys.executable, "-m", "crfr_torch", "bench", "--batch", str(B),
                        "--steps", str(BENCH_STEPS), *(["--int8"] if int8 else [])],
                       _child_env())
        if r.returncode != 0:
            raise AssertionError(f"bench {name}: exit {r.returncode}\n{r.stderr[-4000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        in_process = int8_embed["ms_per_batch"]["int8"] if int8 else embed["ms_per_batch"]
        rel = line["per_batch_ms"] / in_process - 1
        if set(line) != BENCH_KEYS or line["int8"] is not int8 or not abs(rel) <= 0.05:
            raise AssertionError(f"bench {name}: {line} against the in-process "
                                 f"{in_process} ms a batch ({rel:+.4f})")
        _zero_counts(fp)
        run_throughput(batch=B, steps=2, repeats=1, int8=int8, device="cuda")
        torch.cuda.synchronize()
        launches = _counts(fp)
        want = {"fused_degrade_normalize": 4, LOWS_NAME: 0, "fused_resize_normalize": 0, **OFF_PATH}
        if launches != want:         # batches: the first, one re-warm, two timed
            raise AssertionError(f"bench {name}: four batches launched {launches}, want {want}")
        out[name] = {"line": line, "in_process_ms_per_batch": in_process,
                     "rel_to_in_process": rel, "launches": launches, "launches_batches": 4}
    try:
        import PIL  # noqa: F401
    except ImportError:
        cpu = {"run": False, "why": "PIL (the pillow package) is not installed"}
    else:
        from crfr_torch.bench.torch_reference import measure_cpu_reference

        t0 = time.perf_counter()
        ips = measure_cpu_reference(use_cache=False)
        cpu = {"run": True, "imgs_per_sec": ips, "batch": 32, "iters": 3,
               "threads": torch.get_num_threads(), "seconds": time.perf_counter() - t0,
               "card_over_cpu": {k: v["line"]["imgs_per_sec"] / ips for k, v in out.items()}}
    return {"phase": "bench", "batch": B, "steps": BENCH_STEPS, **out, "cpu_reference": cpu,
            "reduced": {"steps": f"30 -> {BENCH_STEPS}: three windows of {BENCH_STEPS} "
                                 "batches (crfr's 30) already spread < 1%"}}


MS1M_C, MS1M_STEPS = 85742, 10              # ms1m_scale: crfr's 30 steps cut to 10
MS1M_FIT_STEPS, MS1M_FIT_B = 40, 64         # ms1m_fit: 200 steps of 256 cut (2,560 renders)
MS1M_SCALE_KEYS = {"backbone", "batch", "ce_impl", "ms1m", "control", "head_marginal_ms",
                   "loss_first", "loss_after_steps", "ln_C", "peak_allocated_gb", "device"}


def start_ms1m_fit() -> dict:
    """``python -m crfr_torch.bench.ms1m_fit`` at C=85,742, steps and batch
    cut, in a child in the background: its renders take the host while
    ``ms1m_scale`` and then the int8_cli phase run here."""
    tmp = tempfile.mkdtemp()
    return {"tmp": tmp, "run": children([sys.executable, "-m", "crfr_torch.bench.ms1m_fit",
                                         "--workdir", tmp, "--classes", str(MS1M_C),
                                         "--steps", str(MS1M_FIT_STEPS),
                                         "--batch", str(MS1M_FIT_B), "--device", "cuda"],
                                        env=_child_env())}


def ms1m_scale_run(fp) -> dict:
    """``bench.ms1m_scale``'s ``main`` in this process at the full shape
    (C=85,742, IR-50, B=256, streaming CE; control C=1,000), steps cut, with
    the counters from 0 just before it: the loss finite and falling on the
    repeated batch, the head's marginal ms and the peak memory printed,
    kernel 1' once a step."""
    import contextlib

    from crfr_torch.bench import ms1m_scale

    buf = io.StringIO()
    torch.cuda.empty_cache()
    _zero_counts(fp)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ms1m_scale.main(["--classes", str(MS1M_C), "--steps", str(MS1M_STEPS)])
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t0
    launches = _counts(fp)
    scale = json.loads(buf.getvalue().strip().splitlines()[-1])
    # two run_train_throughput runs (a first step, three windows) and
    # the repeated batch's first step and MS1M_STEPS more
    steps = 2 * (1 + 3 * MS1M_STEPS) + 1 + MS1M_STEPS
    want = {"fused_degrade_normalize": 0, LOWS_NAME: steps, "fused_resize_normalize": 0, **OFF_PATH,
            BN_NAME: steps * IR50_BN}
    if (rc != 0 or set(scale) != MS1M_SCALE_KEYS or launches != want
            or not np.isfinite([scale["loss_first"], scale["loss_after_steps"]]).all()
            or not scale["loss_after_steps"] < scale["loss_first"]
            or not np.isfinite(scale["head_marginal_ms"])
            or not scale["peak_allocated_gb"] > 0):
        raise AssertionError(f"ms1m scale: {scale}, launches {launches}, want {want}")
    return {"scale": scale, "scale_s": scale_s, "scale_steps": steps, "launches": launches}


def phase_ms1m(started: dict, scale: dict) -> dict:
    """``start_ms1m_fit``'s child: exit 0, no gap in the metrics stream,
    ``final_step`` the steps, the step reference measured on this card;
    beside it ``ms1m_scale_run``'s results."""
    try:
        r = started["run"].result()[0]
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    if r.returncode != 0:
        raise AssertionError(f"ms1m fit: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-4000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if (res["continuity_gaps"] or res["final_step"] != MS1M_FIT_STEPS
            or not (res["device_step_ms_ref"] or 0) > 0
            or res["device_step_device"] != torch.cuda.get_device_name(0)
            or not np.isfinite(res["loss_first"])):
        raise AssertionError(f"ms1m fit: {res}")
    return {"phase": "ms1m", **scale, "fit": res, "fit_wall_s": started["run"].wall_s,
            "reduced": {"scale.steps": f"30 -> {MS1M_STEPS}",
                        "fit.steps": f"200 -> {MS1M_FIT_STEPS}",
                        "fit.batch": f"256 -> {MS1M_FIT_B}: {MS1M_FIT_STEPS * MS1M_FIT_B} "
                                     "renders on the host, not 51,200"}}


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

    int8_sr = {"calls": 0, "fused_resize_normalize": 0, **OFF_PATH}
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
            with bn_calls() as calls:
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
    if launches[BN_NAME] != bn_launches(calls) or not calls["backward"]:
        raise AssertionError(f"headline: the BN kernels launched {launches[BN_NAME]} times "
                             f"for {calls} train-mode BatchNorm2d calls")
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
    from crfr_torch.models.mtcnn import MTCNN, crop_resize, photo_tensor
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
    # three nets a scene, each scene's crops in one launch of the crop form
    want_train = {**_only(CROP_NAME), CROP_NAME: DETECT_STEPS * DETECT_SCENES * 3}
    if train_launches != want_train:
        raise AssertionError(f"detect: training launched {train_launches}, want {want_train}")

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
        want = {**_only(PYRAMID_NAME), CROP_NAME: 2}       # the pyramid, R-net, O-net
        if launches != want:
            raise AssertionError(f"detect: {name} launched {launches}, want {want}")
        with strict_fp32():
            _card_vs_cpu(mt_cpu, name, img, mt.detect(img), near)
        runs = [_timed_detect(mt, img) for _ in range(3)]
        x = photo_tensor(img, mt.device)
        b1 = mt.stage1(x)                   # the R-net stage's boxes
        crops = lambda: crop_resize(x, b1, 24)  # noqa: E731
        rnet_crops = {
            "boxes": len(b1), "ms": cuda_ms(crops, spin=CROP_SPIN), "host_us": host_us(crops),
            "per_crop_path_ms": cuda_ms(lambda: old_crops(fp, x, b1[:, :4].astype(int), 24),
                                        iters=2, warmup=1, spin=OLD_PATH_SPIN)}
        photos[name] = {"faces": len(boxes), "detections": len(det.boxes),
                        "hits": _hits(det, boxes), "launches": launches,
                        "rnet_crops": rnet_crops, "levels": len(mt.pyramid_sizes(h, w)),
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


# ---------------------------------------------------------------------------
# The serving artifact, the artifact daemon and the evaluation CLI
# ---------------------------------------------------------------------------

SERVE_IMGS = 300                       # one /embed request: two coalesced static batches
SERVE_BANK_M = 1 << 16


def _one_call(fp, fn, x):
    """``fn(x)`` with the preprocessing counters set to 0 just before and
    read just after."""
    _zero_counts(fp)
    out = fn(x)
    torch.cuda.synchronize()
    return out, _counts(fp)


def _turns(fns: dict, x, iters: int = 10) -> dict[str, list[float]]:
    """ms a batch of each function (CUDA events over ``iters`` calls after
    one warm call), in turns a, b, b, a."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        fns[n](x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fns[n](x)
        end.record()
        torch.cuda.synchronize()
        out[n].append(start.elapsed_time(end) / iters)
    return out


def _cos_min(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min().item()


def _weights_match(fn, module: torch.nn.Module, prefix: str) -> int:
    """Every parameter and buffer of ``module`` is in the loaded program,
    on the same device, with the same strides and values; returns the
    count."""
    held = fn.program.state_dict
    n = 0
    for k, t in module.state_dict().items():
        got = held.get(f"{prefix}.{k}")
        if got is None:
            if t.numel() == 1 and k.endswith("num_batches_tracked"):
                continue                         # read by no eval-mode op
            raise AssertionError(f"export: {prefix}.{k} is not in the loaded program")
        if got.device != t.device or got.stride() != t.stride() or not torch.equal(got, t):
            raise AssertionError(f"export: the loaded {prefix}.{k} differs ({got.device}, "
                                 f"strides {got.stride()} vs {t.device}, {t.stride()})")
        n += 1
    return n


def phase_export(fp, tmp: str) -> tuple[dict, dict]:
    """``export_embed`` on the card at full width (casia_arcface: IR-50,
    112², bf16 compute, weights from the preset's seed) with low 16 pil, B
    = 256 uint8: exported, saved, loaded back; the loaded weights are the
    trainer's on the card; one call launches kernel 1 exactly once; it
    equals ``build_serving_fn`` on the same weights and images at cosine ≥
    0.9999 a row; ms a batch of both in turns. The same for the int8
    backbone (``export --int8``'s calibration) and, in float32, for G at
    init behind ↓14 (one kernel-2 launch, the bicubic artifact within 1e-2,
    under ``strict_fp32``)."""
    from crfr_torch.cli import _quantized_backbone
    from crfr_torch.configs import get_config
    from crfr_torch.device import strict_fp32
    from crfr_torch.models.sr import build_hallucinator
    from crfr_torch.serve import build_serving_fn, export_embed, load_embed
    from crfr_torch.train.distill_loop import frozen_copy
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import sr_apply_from_state

    cfg = get_config("casia_arcface")
    tr = Trainer(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(30)
    x = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    one_launch = {"fused_degrade_normalize": 1, LOWS_NAME: 0, "fused_resize_normalize": 0, **OFF_PATH}

    def export(name, **kw):
        path = f"{tmp}/{name}.crfrt"
        t0 = time.perf_counter()
        meta = export_embed(tr, path, batch=B, **kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = load_embed(path)
        load_s = time.perf_counter() - t0
        return fn, {"path": path, "export_s": export_s, "load_s": load_s,
                    "bytes": os.path.getsize(path), "meta": meta}

    def compare(name, fn, live, want_launches, info, min_cos=0.9999, iters=10):
        out, launches = _one_call(fp, fn, x)
        want = live(x)
        if tuple(out.shape) != (B, 512) or out.dtype != torch.float32 or \
                not torch.isfinite(out).all():
            raise AssertionError(f"export: {name} gave {tuple(out.shape)} {out.dtype}")
        if launches != want_launches:
            raise AssertionError(f"export: one call of the {name} artifact launched {launches}, "
                                 f"want {want_launches}")
        cos = _cos_min(out, want)
        if cos < min_cos:
            raise AssertionError(f"export: {name} artifact vs build_serving_fn cosine {cos}")
        ms = _turns({"build_serving_fn": live, "artifact": fn}, x, iters)
        info.update(launches=launches, cos_to_live_min=cos,
                    equal_to_live=bool(torch.equal(out, want)),
                    max_abs_to_live=(out - want).abs().max().item(),
                    ms_per_batch={k: min(v) for k, v in ms.items()}, ms_turns=ms)
        return out

    art, bf16 = export("bf16", degrade_to=LOW)
    bf16["weights_checked"] = _weights_match(art, tr.model.backbone, "backbone")
    live = build_serving_fn(lambda y: tr.backbone_apply(tr.model.backbone, y), degrade_to=LOW,
                            image_size=S, device="cuda")
    e_float = compare("bf16", art, live, one_launch, bf16)
    if not tr.model.backbone.training:
        raise AssertionError("export: the trainer's backbone was left in eval mode")
    # the host's time a call of kernel 1: the public function (eager: the
    # op's CUDA body), the op through the dispatcher (as a loaded program
    # calls it) and the bare launch, in turns
    key = fp.operator_key(S, S, LOW, "pil")
    op = torch.ops.crfr_torch.fused_degrade_normalize
    paths = {"function": lambda: fp.fused_degrade_normalize(x, LOW, "pil", torch.bfloat16),
             "custom_op": lambda: op(x, LOW, "pil", torch.bfloat16),
             "launch": lambda: fp._launch(x, key, S, S, torch.bfloat16, "t")}
    host = {n: [] for n in paths}
    for n in (*paths, *reversed(paths)):
        host[n].append(host_us(paths[n]))
    bf16["kernel1_host_us"] = {n: min(v) for n, v in host.items()}
    bf16["kernel1_host_us_turns"] = host

    q = _quantized_backbone(tr, cfg, degrade_to=LOW)
    art8, int8 = export("int8", degrade_to=LOW, backbone_apply=q, quantized=True)
    int8["weights_checked"] = _weights_match(art8, q, "backbone")
    e_int8 = compare("int8", art8, build_serving_fn(lambda y: q(y).float(), degrade_to=LOW,
                                                    image_size=S, device="cuda"),
                     one_launch, int8, iters=4)
    int8["cos_to_float_artifact_min"] = _cos_min(e_int8, e_float)
    del q, art8

    bb = frozen_copy(tr.model.backbone)                  # float32, eval mode
    gen = build_hallucinator(SR_SCALE, 16, "pil", True).to("cuda")
    plug = sr_apply_from_state(gen)
    art_sr, sr = export("hallucinated", degrade_to=SR_LOW, sr_apply=plug, backbone_apply=bb)
    art_bic, bic = export("bicubic14", degrade_to=SR_LOW, backbone_apply=bb)
    live_sr = build_serving_fn(lambda y: bb(y).float(), degrade_to=SR_LOW, image_size=S,
                               sr_apply=plug, device="cuda")
    with strict_fp32():
        e_sr = compare("hallucinated", art_sr, live_sr, SR_ONE_RESIZE, sr, iters=2)
        e_bic, bic_launches = _one_call(fp, art_bic, x)
    diff = (e_sr - e_bic).abs().max().item()
    if bic_launches != one_launch or diff > 1e-2:
        raise AssertionError(f"export: G at init vs the bicubic artifact max diff {diff} "
                             f"(want ≤ 1e-2), bicubic launches {bic_launches}")
    sr.update(float32=True, vs_bicubic_max_abs=diff, bicubic14=bic)
    del art_sr, art_bic, bb, gen, plug, live_sr
    torch.cuda.empty_cache()
    out = {"phase": "export", "backbone": "ir_50", "batch": B, "degrade_to": LOW,
           "input_dtype": "uint8", "bf16": bf16, "int8": int8, "hallucinated": sr,
           "launches": bf16["launches"]}
    return out, {"trainer": tr, "cfg": cfg, "art": art, "path": bf16["path"], "meta": bf16["meta"]}


def _post(url: str, arr=None, timeout: float = 300):
    data = b""
    if arr is not None:
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        data = buf.getvalue()
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        return (json.loads(body) if r.headers["Content-Type"] == "application/json"
                else np.load(io.BytesIO(body), allow_pickle=False))


def _latency_ms(fn, n: int = 5) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_serve_artifact(fp, bs, st: dict, tmp: str) -> tuple[dict, dict]:
    """``serve_artifact`` in this process on the bf16 artifact: ``/embed`` of
    300 images (two coalesced static batches, two kernel-1 launches) equal
    to the loaded artifact on the same padded batches; ``/match`` (pixels)
    against a 2^16-row bank, with the first eight rows planted, equal to
    ``topk_matches_bank`` on the ``/embed`` rows, one ``bank_tilemax``
    launch a request; with ``--mutable-gallery``: ``/enroll``, ``/match``,
    ``/remove``, ``/match``; the latency of a few requests."""
    from crfr_torch.eval.bank import save_bank, topk_matches_bank
    from crfr_torch.serve_http import serve_artifact

    art = st["art"]
    imgs = np.random.default_rng(31).integers(0, 256, (SERVE_IMGS, S, S, 3)).astype(np.uint8)
    pad = np.zeros((2 * B - SERVE_IMGS, S, S, 3), np.uint8)
    direct = torch.cat([art(imgs[:B]), art(np.concatenate([imgs[B:], pad]))[:SERVE_IMGS - B]])
    direct = direct.cpu().numpy()
    rows = unit_rows(32, SERVE_BANK_M)
    rows[:8] = direct[:8] / np.linalg.norm(direct[:8], axis=1, keepdims=True)
    save_bank(f"{tmp}/bank.npz", build_bank(rows))
    faces = imgs[:8]

    def serving(srv):
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        return f"http://127.0.0.1:{srv.server_address[1]}", th

    def stop(srv, th):
        srv.shutdown()
        srv.server_close()
        srv.service.close()
        th.join(timeout=30)
        if th.is_alive():
            raise AssertionError("serve_artifact: the server thread did not stop")

    srv = serve_artifact(st["path"], f"{tmp}/bank.npz")
    url, th = serving(srv)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        _zero_counts(fp)
        t0 = time.perf_counter()
        emb = _post(url + "/embed", imgs)
        embed_s = time.perf_counter() - t0
        embed_launches = _counts(fp)
        bs.bank_tilemax.launches = 0
        matched = _post(url + "/match?k=5", faces)
        match_launches = bs.bank_tilemax.launches
        latency = {"embed_1": _latency_ms(lambda: _post(url + "/embed", imgs[:1])),
                   "embed_256": _latency_ms(lambda: _post(url + "/embed", imgs[:B]), 3),
                   "match_8_pixels": _latency_ms(lambda: _post(url + "/match?k=5", faces)),
                   "match_8_embeddings": _latency_ms(
                       lambda: _post(url + "/match?k=5", emb[:8]))}
    finally:
        stop(srv, th)
    if not (health["ok"] and health["gallery"] == SERVE_BANK_M and not health["mutable"]):
        raise AssertionError(f"serve_artifact: health {health}")
    err = float(np.abs(emb - direct).max())
    if emb.shape != (SERVE_IMGS, 512) or err > 1e-5:
        raise AssertionError(f"serve_artifact: /embed {emb.shape} vs the artifact max diff {err}")
    if embed_launches["fused_degrade_normalize"] != 2:
        raise AssertionError(f"serve_artifact: /embed of {SERVE_IMGS} launched {embed_launches}")
    dev_bank = build_bank(rows).to_device("cuda")
    p = np.pad(emb[:8], ((0, 24), (0, 0)))                     # the server's (32, 16) bucket
    s_want, l_want = topk_matches_bank(p, dev_bank, k=16)
    labels = [m["labels"] for m in matched["matches"]]
    scores = np.array([m["scores"] for m in matched["matches"]])
    if labels != l_want[:8, :5].tolist() or np.abs(scores - s_want[:8, :5]).max() > 1e-4:
        raise AssertionError(f"serve_artifact: /match {labels} != topk_matches_bank "
                             f"{l_want[:8, :5].tolist()}")
    if [row[0] for row in labels] != list(range(8)) or match_launches != 1:
        raise AssertionError(f"serve_artifact: planted rows not top-1 ({labels}) or "
                             f"bank_tilemax launched {match_launches} times, want once")

    srv = serve_artifact(st["path"], mutable=True)
    url, th = serving(srv)
    try:
        new = list(range(1000, 1008))
        t0 = time.perf_counter()
        enrolled = _post(url + "/enroll?labels=" + ",".join(map(str, new)), faces)
        enroll_ms = 1e3 * (time.perf_counter() - t0)
        bs.bank_tilemax.launches = 0
        found = _post(url + "/match?k=1", faces)
        mutable_launches = bs.bank_tilemax.launches
        removed = _post(url + "/remove?labels=" + ",".join(map(str, new[:4])))
        after = _post(url + "/match?k=1", faces)
    finally:
        stop(srv, th)
    if enrolled["labels"] != new or [m["labels"][0] for m in found["matches"]] != new:
        raise AssertionError(f"serve_artifact: /enroll {enrolled}, /match {found['matches']}")
    if removed != {"removed": 4, "gallery": 4} or \
            [m["labels"][0] for m in after["matches"]][4:] != new[4:] or \
            any(m["labels"][0] in new[:4] for m in after["matches"]) or mutable_launches != 1:
        raise AssertionError(f"serve_artifact: /remove {removed}, then {after['matches']}")
    launches = {**embed_launches, "bank_tilemax": match_launches}
    return ({"phase": "serve_artifact", "images": SERVE_IMGS, "static_batch": B,
             "bank_rows": SERVE_BANK_M, "embed_max_abs_vs_artifact": err,
             "embed_equal_to_artifact": bool(err == 0.0), "embed_s_300": embed_s,
             "dispatches": health["dispatches"], "match_equals_topk_matches_bank": True,
             "latency_ms": {**latency, "enroll_8_pixels": enroll_ms},
             "mutable": {"enrolled": new, "removed": 4, "bank_tilemax_per_match":
                         mutable_launches},
             "launches": launches},
            {"embed": emb, "match": matched, "imgs": imgs, "faces": faces})


def _child_env() -> dict:
    root = Path(__file__).resolve().parent
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])])}


def phase_serve_cli(st: dict, served: dict, tmp: str) -> dict:
    """The export phase's trainer saved as a checkpoint; ``python -m
    crfr_torch export`` in a child process (its meta equal to phase 20's),
    then ``python -m crfr_torch serve-http --artifact --gallery-npz
    --mutable-gallery --port 0`` in another: its JSON line read, ``/embed``
    and ``/match`` equal to the in-process server's answers (the 2^16-row
    bank now a ``ServingBank``), ``/enroll`` of eight other faces found by
    ``/match``, ``/remove`` of them, then SIGINT (exit 0)."""
    import signal

    from crfr_torch.serve import read_meta
    from crfr_torch.train.checkpoints import Checkpointer

    root = Path(__file__).resolve().parent
    tr = st["trainer"]
    Checkpointer(f"{tmp}/ck").save(0, tr.state, st["cfg"].to_json(), force=True)
    art = f"{tmp}/cli.crfrt"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "crfr_torch", "export", "--ckpt", f"{tmp}/ck",
                        "--out", art, "--batch", str(B), "--degrade", str(LOW)], cwd=root,
                       env=_child_env(), capture_output=True, text=True, timeout=600)
    export_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"serve_cli: export exit {r.returncode}\n{r.stderr[-4000:]}")
    printed = json.loads(r.stdout.strip().splitlines()[-1])
    if read_meta(art) != st["meta"] or printed != {**st["meta"], "out": art}:
        raise AssertionError(f"serve_cli: export meta {printed} != {st['meta']}")
    new = list(range(10_000_000, 10_000_008))           # labels past the bank's
    others = served["imgs"][8:16]                       # faces not planted in the bank
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "crfr_torch", "serve-http", "--artifact", art,
                             "--gallery-npz", f"{tmp}/bank.npz", "--mutable-gallery",
                             "--port", "0"], cwd=root, env=_child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline() or "{}")
        start_s = time.perf_counter() - t0
        if not (line.get("serving") and line.get("artifact") == art and line.get("gallery")
                and line.get("mutable")):
            raise AssertionError(f"serve_cli: serve-http printed {line}")
        url = line["serving"]
        emb = _post(url + "/embed", served["imgs"])
        matched = _post(url + "/match?k=5", served["faces"])
        enrolled = _post(url + "/enroll?labels=" + ",".join(map(str, new)), others)
        found = _post(url + "/match?k=1", others)
        removed = _post(url + "/remove?labels=" + ",".join(map(str, new)))
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=30)
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    if rc != 0:
        raise AssertionError(f"serve_cli: serve-http exit {rc}\n{err[-4000:]}")
    diff = float(np.abs(emb - served["embed"]).max())
    got, want = matched["matches"], served["match"]["matches"]
    if diff > 1e-5 or matched["gallery"] != served["match"]["gallery"] or \
            [m["labels"] for m in got] != [m["labels"] for m in want] or \
            np.abs(np.array([m["scores"] for m in got]) -
                   np.array([m["scores"] for m in want])).max() > 1e-4:
        raise AssertionError(f"serve_cli: the child's /embed differs by {diff} or its /match "
                             f"{got[:2]} != {want[:2]}")
    if enrolled["labels"] != new or [m["labels"][0] for m in found["matches"]] != new or \
            removed != {"removed": 8, "gallery": SERVE_BANK_M}:
        raise AssertionError(f"serve_cli: /enroll {enrolled}, /match {found['matches'][:2]}, "
                             f"/remove {removed}")
    return {"phase": "serve_cli", "export_s": export_s, "serve_start_s": start_s,
            "embed_max_abs_vs_in_process": diff, "match_equals_in_process": True,
            "enrolled_found": True, "removed": removed, "serving": line, "exit_code": rc}


EVAL_S, EVAL_IDS = 64, 16              # the eval phase's image size and identities


def _write_protocols(d: Path, rng) -> dict:
    """Rendered faces (``data.render``) as the files of each protocol: an LFW
    tree and pairs.txt, SCface gallery and probe directories, open-set
    lists, an insightface .bin, IJB-C meta lists and pairs, an identity
    folder tree and an MX .rec of it."""
    from PIL import Image

    from crfr_torch.data.bins import save_bin
    from crfr_torch.data.mxrec import write_mx_record
    from crfr_torch.data.render import RenderedIdentities

    ren = RenderedIdentities(EVAL_IDS, image_size=EVAL_S, seed=5)

    def face(i: int) -> np.ndarray:
        return np.clip(np.rint(ren.render(i, rng)), 0, 255).astype(np.uint8)

    def save(path: Path, img) -> str:
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(path)
        return str(path)

    for i in range(EVAL_IDS):
        for j in (1, 2, 3):
            save(d / "lfw" / f"p{i}" / f"p{i}_{j:04d}.jpg", face(i))
    same = [f"p{i} 1 {j}" for i in range(EVAL_IDS) for j in (2, 3)]
    diff = [f"p{i} 1 p{(i + k) % EVAL_IDS} {k + 1}" for i in range(EVAL_IDS) for k in (1, 2)]
    (d / "pairs.txt").write_text("\n".join(["4 16", *[v for pair in zip(same, diff)
                                                       for v in pair]]) + "\n")
    for i in range(EVAL_IDS):
        save(d / "sc_gallery" / f"{i:03d}_frontal.png", face(i))
        for cam in (1, 2):
            save(d / "sc_probes" / f"{i:03d}_cam{cam}_1.png", face(i))
    lists = {"gallery": [], "mated": [], "unmated": []}
    for i in range(EVAL_IDS):
        kind = "gallery" if i < 12 else "unmated"
        lists[kind].append(f"{save(d / 'os' / f'g{i}.png', face(i))} {i}")
        lists["mated" if i < 12 else "unmated"].append(
            f"{save(d / 'os' / f'p{i}.png', face(i))} {i}")
    for k, v in lists.items():
        (d / f"os_{k}.txt").write_text("\n".join(v) + "\n")
    i1, i2, issame = ren.eval_pairs(rng, 16)
    save_bin(str(d / "pairs.bin"), np.clip(np.rint(i1), 0, 255).astype(np.uint8),
             np.clip(np.rint(i2), 0, 255).astype(np.uint8), issame)
    meta, tid = [], 0
    for s_id in range(8):
        for _ in range(2):
            for m in range(2):
                meta.append(f"{save(d / 'ijbc' / f't{tid}_{m}.png', face(s_id))} {tid} "
                            f"{10 * tid + m} {s_id}")
            tid += 1
    (d / "ijbc_meta.txt").write_text("\n".join(meta) + "\n")
    (d / "ijbc_pairs.txt").write_text("\n".join(f"{2 * s} {2 * s + 1} 1\n{2 * s} "
                                                f"{(2 * s + 3) % 16} 0" for s in range(8)))
    (d / "ijbc_probe.txt").write_text("\n".join(meta[0::4]) + "\n")
    (d / "ijbc_g1.txt").write_text("\n".join(meta[1::4][:4] + meta[2::4][4:]) + "\n")
    (d / "ijbc_g2.txt").write_text("\n".join(meta[2::4][:4] + meta[1::4][4:]) + "\n")
    jpegs = []
    for i in range(4):
        for j in range(3):
            img = face(i)
            save(d / "tree" / f"id{i}" / f"{j}.png", img)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=95)
            jpegs.append((float(i), buf.getvalue()))
    write_mx_record(str(d / "train.rec"), jpegs, insightface_meta=True)
    return {"tree_images": 12, "rec_images": len(jpegs)}


def phase_eval_cli(fp, bs) -> dict:
    """The evaluation commands on rendered faces at 64 px with a 2-step
    float32 IR-18 checkpoint of ``train``, in this process, each on the
    card (under ``strict_fp32``, kernel launches counted around it) and
    again with ``--device cpu``: ``eval-verification`` (bicubic and
    ``--sr-ckpt`` of G at init), ``eval-scface``, ``eval-openset`` (image
    lists, and ``--probe-npy``), ``eval-bin`` on a ``.bin`` of ``save_bin``,
    ``eval-ijbc`` (1:1 and 1:N, and ``--probe-tpl-npy``), ``import-torch``
    of a seeded face.evoLVe dict followed by ``eval-verification`` on it;
    each pair of JSON lines equal (accuracies and ranks exactly, other
    numbers within 1e-4). ``pack`` of the folder tree and of the ``.rec``
    read back through ``PackSource``."""
    import contextlib

    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return {"phase": "eval_cli", "run": False, "why": "PIL not installed"}
    from crfr_torch.cli import main as cli
    from crfr_torch.device import strict_fp32
    from crfr_torch.models.irse import build_backbone
    from crfr_torch.train.torch_import import export_face_evolve_state_dict

    def run(*argv) -> tuple[dict, float]:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli(list(argv))
        if rc != 0:
            raise AssertionError(f"eval_cli: {argv[0]} exit {rc}")
        return json.loads(out.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0

    def close(a, b, path="") -> None:
        if isinstance(a, dict):
            if set(a) != set(b):
                raise AssertionError(f"eval_cli: keys {path} {sorted(a)} != {sorted(b)}")
            for k in a:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            if len(a) != len(b):
                raise AssertionError(f"eval_cli: {path} lengths {len(a)} != {len(b)}")
            for i, (u, v) in enumerate(zip(a, b)):
                close(u, v, f"{path}[{i}]")
        elif isinstance(a, float) and path.split(".")[-1] not in ("accuracy", "rank1",
                                                                    "rank1_g1", "rank1_g2"):
            if abs(a - b) > 1e-4:
                raise AssertionError(f"eval_cli: {path} {a} vs {b}")
        elif a != b:
            raise AssertionError(f"eval_cli: {path} {a} != {b}")

    rng = np.random.default_rng(40)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        written = _write_protocols(d, rng)
        ov = [f"data.image_size={EVAL_S}", f"model.input_size={EVAL_S}",
              f"data.num_classes={EVAL_IDS}", "model.backbone=ir_18",
              "model.compute_dtype=float32", "model.dropout=0.0", "train.batch_size=16",
              "eval.batch_size=32", "eval.n_folds=4"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            if cli(["train", "--preset", "casia_arcface", *ov, f"train.checkpoint_dir={d}/ck",
                    "--max-steps", "2"]) != 0:
                raise AssertionError("eval_cli: train failed")
        train_s = time.perf_counter() - t0
        from crfr_torch.configs import get_config
        from crfr_torch.train.checkpoints import Checkpointer
        from crfr_torch.train.sr_loop import SRTrainer

        sr = SRTrainer(get_config("casia_arcface", ov), scale=4, device="cpu")
        Checkpointer(f"{d}/sr").save(0, sr.state_dict(), force=True)
        del sr
        sd = export_face_evolve_state_dict(build_backbone(
            "ir_18", input_size=EVAL_S, generator=torch.Generator().manual_seed(41)))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "evolve.pth")
        emb = np.random.default_rng(42).normal(size=(60, 512)).astype(np.float32)
        np.save(d / "g.npy", emb[:40])
        np.save(d / "gl.npy", np.arange(40))
        np.save(d / "p.npy", emb[:20] + 0.3 * np.random.default_rng(43).normal(
            size=(20, 512)).astype(np.float32))
        np.save(d / "pl.npy", np.r_[np.arange(10), np.arange(100, 110)])
        np.save(d / "mated.npy", np.r_[np.ones(10, bool), np.zeros(10, bool)])
        for name, v in (("ptpl", emb[:12]), ("psub", np.arange(12)), ("g1tpl", emb[:6]),
                        ("g1sub", np.arange(6)), ("g2tpl", emb[6:12]),
                        ("g2sub", np.arange(6, 12))):
            np.save(d / f"{name}.npy", v)
        ck = ["--ckpt", f"{d}/ck"]
        commands = {
            "eval_verification": ["eval-verification", *ck, "--pairs", f"{d}/pairs.txt",
                                  "--lfw-root", f"{d}/lfw", "--degrade", "16"],
            "eval_verification_sr": ["eval-verification", *ck, "--pairs", f"{d}/pairs.txt",
                                     "--lfw-root", f"{d}/lfw", "--sr-ckpt", f"{d}/sr",
                                     "--sr-scale", "4"],
            "eval_scface": ["eval-scface", *ck, "--gallery", f"{d}/sc_gallery",
                            "--probes", f"{d}/sc_probes", "--distance", "1"],
            "eval_openset": ["eval-openset", *ck, "--gallery-list", f"{d}/os_gallery.txt",
                             "--mated-list", f"{d}/os_mated.txt",
                             "--unmated-list", f"{d}/os_unmated.txt", "--degrade", "16",
                             "--max-rank", "5"],
            "eval_openset_npy": ["eval-openset", "--probe-npy", f"{d}/p.npy",
                                 "--probe-labels-npy", f"{d}/pl.npy",
                                 "--gallery-npy", f"{d}/g.npy",
                                 "--gallery-labels-npy", f"{d}/gl.npy",
                                 "--mated-npy", f"{d}/mated.npy"],
            "eval_bin": ["eval-bin", *ck, "--bin", f"{d}/pairs.bin", "--degrade", "16"],
            "eval_ijbc": ["eval-ijbc", *ck, "--meta", f"{d}/ijbc_meta.txt",
                          "--pairs", f"{d}/ijbc_pairs.txt", "--probe-meta", f"{d}/ijbc_probe.txt",
                          "--gallery-g1", f"{d}/ijbc_g1.txt", "--gallery-g2", f"{d}/ijbc_g2.txt"],
            "eval_ijbc_npy": ["eval-ijbc", "--probe-tpl-npy", f"{d}/ptpl.npy",
                              "--probe-subjects-npy", f"{d}/psub.npy",
                              "--g1-tpl-npy", f"{d}/g1tpl.npy", "--g1-subjects-npy",
                              f"{d}/g1sub.npy", "--g2-tpl-npy", f"{d}/g2tpl.npy",
                              "--g2-subjects-npy", f"{d}/g2sub.npy"],
        }
        with strict_fp32():
            for dev in ("cuda", "cpu"):
                imp, _ = run("import-torch", "--torch-ckpt", f"{d}/evolve.pth", "--out",
                             f"{d}/imported_{dev}", "--device", dev, *ov)
                if imp["keys"] != len(sd):
                    raise AssertionError(f"eval_cli: import-torch {imp}")
            commands["eval_verification_imported"] = [
                "eval-verification", "--ckpt", f"{d}/imported_cuda", "--pairs", f"{d}/pairs.txt",
                "--lfw-root", f"{d}/lfw", "--degrade", "16"]
            for name, argv in commands.items():
                _zero_counts(fp)
                bs.bank_tilemax.launches = 0
                card, card_s = run(*argv, "--device", "cuda")
                torch.cuda.synchronize()
                launches = {**_counts(fp), "bank_tilemax": bs.bank_tilemax.launches}
                cpu, cpu_s = run(*argv, "--device", "cpu")
                close(card, cpu, name)
                runs[name] = {"card": card, "card_s": card_s, "cpu_s": cpu_s,
                              "launches": launches}
        a = Checkpointer(f"{d}/imported_cuda").restore()["model"]
        b = Checkpointer(f"{d}/imported_cpu").restore()["model"]
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("eval_cli: import-torch on the card and on the CPU differ")
        from crfr_torch.data.records import PackSource

        packs = {}
        for name, src in (("tree", ["--root", f"{d}/tree", "--size", str(EVAL_S)]),
                          ("rec", ["--from-rec", f"{d}/train.rec"])):
            out, _ = run("pack", *src, "--out", f"{d}/{name}.crfrpack")
            ps = PackSource(f"{d}/{name}.crfrpack")
            labels = [ps[i][0] for i in range(len(ps))]
            if out["images"] != written[f"{name}_images"] or out["identities"] != 4 or \
                    labels != [i // 3 for i in range(12)] or ps[0][1].shape != (EVAL_S, EVAL_S, 3):
                raise AssertionError(f"eval_cli: pack {name} {out}, labels {labels}")
            packs[name] = out
    want = {"eval_verification": 1, "eval_verification_sr": 0, "eval_openset": 1,
            "eval_bin": 1, "eval_verification_imported": 1}
    for name, n in want.items():
        got = runs[name]["launches"]["fused_degrade_normalize"]
        if (got == 0) != (n == 0):
            raise AssertionError(f"eval_cli: {name} launched kernel 1 {got} times")
    if runs["eval_verification_sr"]["launches"]["fused_resize_normalize"] < 1:
        raise AssertionError("eval_cli: --sr-ckpt did not launch kernel 2")
    return {"phase": "eval_cli", "run": True, "image_size": EVAL_S, "identities": EVAL_IDS,
            "train_s": train_s, "card_equals_cpu": True, "packs": packs,
            "runs": {k: {"card": v["card"] if k != "eval_openset_npy" else
                         {"rank1": v["card"]["rank1"]}, "card_s": v["card_s"],
                         "cpu_s": v["cpu_s"], "launches": v["launches"]}
                     for k, v in runs.items()},
            "launches": {k: v["launches"] for k, v in runs.items()}}



# ---------------------------------------------------------------------------
# 24. distributed: two rank processes on the one card
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_F32_B, DIST_F32_STEPS = 64, 3     # the float32 comparison's global batch and steps
DIST_BF16_STEPS = 10
# the float32 comparison: the preset at full width (IR-50, 10,572 classes,
# per-image lows 8-112, dropout 0.4) with phase 7's parity loss (s=16,
# m=0.2, no warmup) on SyntheticFaces images, at lr 1e-3: at phase 7's lr
# 0.01 the loss falls 23% in three steps and the last-bit differences of
# the first step (two ranks sum BN statistics and gradients in another
# order than one process) grow past the bound by the third, on either
# layout, with dropout or without
DIST_F32_OV = ["model.compute_dtype=float32", "train.warmup_steps=0", "loss.scale=16.0",
               "loss.margin=0.2", "train.lr=0.001", f"train.batch_size={DIST_F32_B}"]
DIST_LAYOUTS = {"data2": (2, 1), "model2": (1, 2)}


def _dist_env(tmp: str, tag: str) -> dict:
    """The rank processes' environment: the port's own launch variables,
    a group through a file, and gloo (NCCL refuses two ranks on one card;
    gloo stages CUDA tensors through the host for its collectives, while
    every kernel still runs on the card)."""
    return {**_child_env(), "CRFR_COORDINATOR": f"file://{tmp}/pg_{tag}",
            "CRFR_NUM_PROCESSES": str(DIST_WORLD), "CRFR_DIST_BACKEND": "gloo"}


def _launch_ranks(argv: list[str], env: dict, what: str, timeout: float = 300,
                  wait=None) -> list:
    """``argv`` as DIST_WORLD processes (CRFR_PROCESS_ID 0..), each with a
    time limit; ``wait`` (a callable) runs here while they do; every one is
    stopped before this returns. → their (stdout, stderr)."""
    root = Path(__file__).resolve().parent
    procs = [subprocess.Popen(argv, cwd=root, env={**env, "CRFR_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True)
             for r in range(DIST_WORLD)]
    _CHILDREN.extend(procs)
    outs, deadline = [], time.time() + timeout
    try:
        if wait is not None:
            wait()
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"distributed {what}: ranks {bad} failed\n"
                             + "\n".join(f"{o[-1500:]}\n{e[-3000:]}" for o, e in outs))
    return outs


def _run_rank_cases(cases: list[str], tmp: str, timeout: float = 300,
                    wait=None) -> dict[str, list[dict]]:
    """``cases`` one after another in one launch of the rank processes (one
    start-up for all); ``wait`` runs here meanwhile. → each case's outputs
    by rank."""
    what = ",".join(cases)
    _launch_ranks([sys.executable, str(Path(__file__).resolve()), "--rank", what, tmp],
                  _dist_env(tmp, what.replace(",", "_")), what, timeout, wait)
    return {c: [torch.load(f"{tmp}/{c}_{r}.pt", weights_only=False) for r in range(DIST_WORLD)]
            for c in cases}


def _rank_gallery(tmp: str, rank: int) -> dict:
    """The gallery phase's bank row-sharded over the ranks: each uploads and
    scans only its 2^19 rows (one bank_tilemax launch), then the k·ranks
    merge."""
    from crfr_torch.eval.bank import QuantBank, bank_topk_fused, topk_matches_bank
    from crfr_torch.eval.identification import merge_shards, shard_rows
    from crfr_torch.ops import bank_scan as bs
    from crfr_torch.parallel import make_mesh

    probes = np.load(f"{tmp}/gallery_in.npz")["probes"]
    bank = build_bank(unit_rows(5, BANK_M))          # on the host: ranks copy their rows
    mesh = make_mesh(None, "cuda")
    torch.cuda.synchronize()
    bs.bank_tilemax.launches = 0
    t0 = time.perf_counter()
    s, lab = topk_matches_bank(probes, bank, k=BANK_K, mesh=mesh, device="cuda")
    wall_s = time.perf_counter() - t0
    launches = bs.bank_tilemax.launches
    # the steady scan: this rank's rows already on the card, then the merge
    lo, hi, _ = shard_rows(BANK_M, DIST_WORLD)
    local = QuantBank(bank.q[lo:hi], bank.scale[lo:hi], bank.labels[lo:hi]).to_device("cuda")
    p = torch.from_numpy(probes).cuda()
    scan_ms, _ = event_ms(lambda: bank_topk_fused(p, local.q, local.scale, local.labels,
                                                  k=BANK_K))
    ls, ll = bank_topk_fused(p, local.q, local.scale, local.labels, k=BANK_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        merge_shards(ls, ll, BANK_K)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) / 5 * 1e3
    return {"s": s, "l": lab, "launches": launches, "rows": hi - lo,
            "first_call_s": wall_s, "local_scan_ms": scan_ms, "merge_ms": merge_ms}


def _rank_train(tmp: str, rank: int) -> dict:
    """For each layout: DIST_F32_STEPS float32 steps of the preset at full
    width on the saved global batches (state gathered, rank 0 saves it);
    then DIST_BF16_STEPS bf16 steps at the preset's global batch 512, timed,
    kernel 1' counted per rank; then ``make_extract_fn`` split over the
    ranks on 256 images (one kernel-1 launch a rank)."""
    from crfr_torch.configs import get_config
    from crfr_torch.device import strict_fp32
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.ops import fused_preprocess as fp
    from crfr_torch.train.loop import Trainer

    inp = torch.load(f"{tmp}/train_in.pt", weights_only=False)
    batches = inp["batches"]
    out = {}
    for name in inp["layouts"]:
        d, m = DIST_LAYOUTS[name]
        mesh_ov = [f"mesh.data={d}", f"mesh.model={m}"]
        tr = Trainer(get_config("casia_arcface", inp["ov"] + mesh_ov), device="cuda")
        with strict_fp32():
            metrics = [{k: v.item() for k, v in tr.train_step(x, y).items()} for x, y in batches]
        st = tr.state
        if rank == 0:
            torch.save({k: v.cpu() for k, v in st["model"].items()}, f"{tmp}/state_{name}.pt")
        w_local = list(tr.model.head.weight.shape)
        del tr, st
        torch.cuda.empty_cache()
        out[name] = {"f32_metrics": metrics, "w_local": w_local}
        if not inp["bf16"]:
            continue

        cfg = get_config("casia_arcface", ["train.warmup_steps=0", *mesh_ov])
        tr = Trainer(cfg, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(8)
        x = torch.randint(0, 256, (TRAIN_B, S, S, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
        y = torch.randint(0, cfg.data.num_classes, (TRAIN_B,), generator=g, device="cuda")
        tr.train_step(x, y)                                    # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(fp)
        t0 = time.perf_counter()
        with bn_calls() as calls:
            for _ in range(DIST_BF16_STEPS):
                m_bf16 = tr.train_step(x, y)
        loss = m_bf16["loss"].item()
        ms = (time.perf_counter() - t0) / DIST_BF16_STEPS * 1e3
        counts = _counts(fp)
        peak = torch.cuda.max_memory_allocated()
        faces = x[:B]
        fn = make_extract_fn(tr.backbone_apply, state_fn=tr.embed_state, degrade_to=LOW,
                             mesh=tr.mesh, device="cuda")
        whole = make_extract_fn(tr.backbone_apply, state_fn=tr.embed_state, degrade_to=LOW,
                                device="cuda")(faces)
        _zero_counts(fp)
        split = fn(faces)
        torch.cuda.synchronize()
        extract_counts = _counts(fp)
        out[name].update({"bf16_ms_per_step": ms,
                     "bf16_loss": loss, "peak_bytes": peak, "launches": counts,
                     "bn_calls": calls,
                     "extract_launches": extract_counts,
                     "extract_cos_min_vs_whole": _cos_min(split.float(), whole.float())})
        del tr, x, y, fn
        torch.cuda.empty_cache()
    return out


RANK_CASES = {"gallery": _rank_gallery, "train": _rank_train}


def rank_main(cases: str, tmp: str) -> int:
    """One rank process of the distributed phase, started through the
    port's own launch variables (``parallel.multihost``), running the
    comma-separated ``cases`` in order."""
    import torch.distributed as dist

    from crfr_torch.parallel.multihost import maybe_initialize_distributed, process_index

    if not maybe_initialize_distributed("cuda"):
        raise RuntimeError("no launch described in CRFR_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID")
    try:
        rank = process_index()
        for case in cases.split(","):
            torch.save(RANK_CASES[case](tmp, rank), f"{tmp}/{case}_{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def _dist_f32_reference(batches, ov=DIST_F32_OV) -> dict:
    """The one-process trainer's DIST_F32_STEPS float32 steps."""
    from crfr_torch.configs import get_config
    from crfr_torch.device import strict_fp32
    from crfr_torch.train.loop import Trainer

    tr = Trainer(get_config("casia_arcface", ov), device="cuda")
    with strict_fp32():
        metrics = [{k: v.item() for k, v in tr.train_step(x, y).items()} for x, y in batches]
    state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    del tr
    torch.cuda.empty_cache()
    return {"metrics": metrics, "state": state}


def _dist_cli(tmp: str) -> dict:
    """``python -m crfr_torch train`` (phase 8's cut, on IR-18) as two
    processes on a ``.crfrpack``: 4 steps, ``--resume`` to 6, and 6
    straight beside them (two groups of ranks at once), with cuDNN's
    deterministic algorithms; a second straight run only when the first
    two differ, to bound the difference by the spread of straight runs."""
    from crfr_torch.data.records import write_pack
    from crfr_torch.train.checkpoints import Checkpointer

    rng = np.random.default_rng(12)
    write_pack(f"{tmp}/train.crfrpack", [(int(i % 64), rng.integers(0, 256, (S, S, 3))
                                          .astype(np.uint8)) for i in range(256)])
    launcher = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
                "from crfr_torch.cli import main; sys.exit(main(sys.argv[1:]))")
    env = {**_dist_env(tmp, "cli"), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    ov = [*CLI_OV, "model.backbone=ir_18", "train.checkpoint_every_steps=2",
          "train.log_every=1", f"mesh.data={DIST_WORLD}", "--train-records",
          f"{tmp}/train.crfrpack"]

    def launch(i: int, tag: str, steps: int, resume: bool) -> list:
        argv = [sys.executable, "-c", launcher, "train", "--preset", "casia_arcface", *ov,
                f"train.checkpoint_dir={tmp}/{tag}", "--max-steps", str(steps),
                *(["--resume"] if resume else [])]
        outs = _launch_ranks(argv, {**env, "CRFR_COORDINATOR": f"file://{tmp}/pg_cli{i}"},
                             "cli", timeout=300)
        finals = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
        if finals != [{"final_step": steps}] * DIST_WORLD or (
                resume and not all("resumed from step 4" in e for _, e in outs)):
            raise AssertionError(f"distributed cli: {finals}, {[e[-400:] for _, e in outs]}")
        return outs

    t0 = time.perf_counter()
    # 4 steps and --resume to 6 beside 6 straight: two groups of ranks at once
    chain = Background(lambda: [launch(0, "a", 4, False), launch(1, "a", 6, True)])
    runs = {"b6": launch(2, "b", 6, False)}
    runs["a4"], runs["a6"] = chain.result()
    if not _state_equal(*[Checkpointer(f"{tmp}/{t}").restore(step=6) for t in ("a", "b")]):
        runs["c6"] = launch(3, "c", 6, False)
    wall = time.perf_counter() - t0
    a, b = (Checkpointer(f"{tmp}/{t}").restore(step=6) for t in ("a", "b"))
    diff_ab = _max_diff(a, b)
    diff_bc = 0.0
    if "c6" in runs:
        diff_bc = _max_diff(b, Checkpointer(f"{tmp}/c").restore(step=6))
        if diff_ab > diff_bc:
            raise AssertionError(f"distributed cli: 4 + --resume to 6 differs from 6 straight "
                                 f"by {diff_ab}, beyond two straight runs' {diff_bc}")
    rows = [json.loads(ln) for ln in Path(f"{tmp}/a/metrics.jsonl").read_text().splitlines()]
    logged = [r["step"] for r in rows if "loss" in r]
    states = sorted(p.name for p in Path(f"{tmp}/a").glob("data_state*.json"))
    if logged != [1, 2, 3, 4, 5, 6] or states != ["data_state_0.json", "data_state_1.json"]:
        raise AssertionError(f"distributed cli: metrics rows {logged}, data states {states}")
    return {"resumed_equals_straight": diff_ab == 0.0, "resumed_vs_straight_max": diff_ab,
            "straight_spread_max": diff_bc if "c6" in runs else None,
            "metrics_rows_by_rank0": len(rows), "data_states": states,
            "wall_s": wall, "launch_pairs": len(runs)}


def start_dist_cli() -> dict:
    """(c) of phase 24, ``_dist_cli``, in the background (beside the
    eval_cli phase, whose work is not timed)."""
    tmp = tempfile.mkdtemp()
    return {"tmp": tmp, "run": Background(lambda: _dist_cli(tmp))}


def phase_distributed(gallery_ref: dict, cli_started: dict) -> dict:
    """Two rank processes on the one card through the port's launch
    variables (gloo: see ``_dist_env``), against the one-process runs in
    this call: (c) the train CLI's resume (``start_dist_cli``'s, awaited
    first, so nothing runs beside (b)'s timed steps), (a) the gallery
    phase's bank row-sharded, (b) the preset's training at full width as
    data=2 and as model=2 (the class-sharded head), float32 against the
    one-process trainer, then bf16 at batch 512."""
    from crfr_torch.data.synthetic import SyntheticFaces

    t_phase = time.perf_counter()
    try:
        cli = cli_started["run"].result()
    finally:
        shutil.rmtree(cli_started["tmp"], ignore_errors=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # one launch of the ranks runs (a) and (b); the one-process float32
        # reference of (b) is computed here meanwhile
        np.savez(f"{tmp}/gallery_in.npz", probes=gallery_ref["probes"])
        faces = SyntheticFaces(num_classes=64, image_size=S, seed=0)
        rng = np.random.default_rng(13)
        batches = []
        for _ in range(DIST_F32_STEPS):
            x, y = faces.sample(rng, DIST_F32_B)
            batches.append((torch.from_numpy(x.astype(np.uint8)),
                            torch.from_numpy(y.astype(np.int64) * 165)))    # over all 10,572
        torch.save({"batches": batches, "ov": DIST_F32_OV, "layouts": list(DIST_LAYOUTS),
                    "bf16": True}, f"{tmp}/train_in.pt")
        ref = {}
        t0 = time.perf_counter()
        by_case = _run_rank_cases(["gallery", "train"], tmp, timeout=500,
                                  wait=lambda: ref.update(_dist_f32_reference(batches)))
        ranks_wall = time.perf_counter() - t0

        # (a) the gallery
        ranks = by_case["gallery"]
        want_s, want_l, planted = gallery_ref["s"], gallery_ref["l"], gallery_ref["planted"]
        for r, out in enumerate(ranks):
            err = float(np.abs(out["s"] - want_s).max())
            if out["launches"] != 1 or out["rows"] != BANK_M // DIST_WORLD:
                raise AssertionError(f"distributed gallery: rank {r} launched bank_tilemax "
                                     f"{out['launches']} times on {out['rows']} rows")
            if not (err <= 1e-6 and _same_outside_ties(want_s, want_l, out["s"], out["l"])):
                raise AssertionError(f"distributed gallery: rank {r} differs from the "
                                     f"one-process fused scan (scores {err})")
            if not np.array_equal(out["l"][:, 0], planted):
                raise AssertionError(f"distributed gallery: rank {r} top-1 misses planted rows")
        gallery = {"launches_by_rank": [o["launches"] for o in ranks],
                   "rows_by_rank": [o["rows"] for o in ranks],
                   "max_abs_score_err": max(float(np.abs(o["s"] - want_s).max()) for o in ranks),
                   "top1_is_planted": True,
                   "first_call_s_by_rank": [o["first_call_s"] for o in ranks],
                   "local_scan_ms_by_rank": [o["local_scan_ms"] for o in ranks],
                   "merge_ms_by_rank": [o["merge_ms"] for o in ranks]}

        # (b) training at full width
        ranks = by_case["train"]
        train = {}
        for name in DIST_LAYOUTS:
            got = torch.load(f"{tmp}/state_{name}.pt", weights_only=True)
            rels = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
                    for g, w in zip(ranks[0][name]["f32_metrics"], ref["metrics"])]
            rels_g = [abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
                      for g, w in zip(ranks[0][name]["f32_metrics"], ref["metrics"])]
            rel = max(rels)
            worst = max(((a.float() - ref["state"][k].float()).abs()
                         - (1e-4 + 1e-3 * ref["state"][k].float().abs())).max().item()
                        for k, a in got.items())
            same = ranks[0][name]["f32_metrics"] == ranks[1][name]["f32_metrics"]
            if not (rel <= 1e-4 and worst <= 0 and same):
                raise AssertionError(f"distributed train {name}: float32 against one process: "
                                     f"loss rel {rel}, parameters beyond rtol 1e-3 / atol 1e-4 "
                                     f"by {worst}, ranks agree {same}")
            per_rank = [o[name] for o in ranks]
            for r, o in enumerate(per_rank):
                # the global BN (``_GlobalBatchNorm``) where the batch spans the ranks
                want = {"fused_degrade_normalize": 0, LOWS_NAME: DIST_BF16_STEPS,
                        "fused_resize_normalize": 0, **OFF_PATH,
                        BN_NAME: bn_launches(o["bn_calls"])}
                if o["launches"] != want or o["extract_launches"] != {
                        "fused_degrade_normalize": 1, LOWS_NAME: 0, "fused_resize_normalize": 0, **OFF_PATH}:
                    raise AssertionError(f"distributed train {name}: rank {r} launched "
                                         f"{o['launches']} in {DIST_BF16_STEPS} steps and "
                                         f"{o['extract_launches']} in one split extract")
                if not np.isfinite(o["bf16_loss"]) or o["extract_cos_min_vs_whole"] < 0.999:
                    raise AssertionError(f"distributed train {name}: rank {r} bf16 loss "
                                         f"{o['bf16_loss']}, split extract cosine "
                                         f"{o['extract_cos_min_vs_whole']}")
            train[name] = {"mesh": list(DIST_LAYOUTS[name]), "w_local": per_rank[0]["w_local"],
                           "f32_loss_rel_vs_one_process_by_step": rels,
                           "f32_grad_norm_rel_vs_one_process_by_step": rels_g,
                           "f32_param_excess": worst,
                           "bf16_ms_per_step_by_rank": [o["bf16_ms_per_step"] for o in per_rank],
                           "bf16_loss": per_rank[0]["bf16_loss"],
                           "peak_bytes_by_rank": [o["peak_bytes"] for o in per_rank],
                           "lows_launches_by_rank": [o["launches"][LOWS_NAME] for o in per_rank],
                           "extract_cos_min_vs_whole": min(o["extract_cos_min_vs_whole"]
                                                           for o in per_rank),
                           "launches": per_rank[0]["launches"],
                           "extract_launches": per_rank[0]["extract_launches"]}

    return {"phase": "distributed", "ranks": DIST_WORLD, "backend": "gloo",
            "gallery": gallery, "train": train, "ranks_wall_s": ranks_wall, "cli": cli,
            "f32_batch": DIST_F32_B, "f32_steps": DIST_F32_STEPS, "bf16_batch": TRAIN_B,
            "bf16_steps": DIST_BF16_STEPS, "wall_s": time.perf_counter() - t_phase,
            "launches": {"gallery": {"bank_tilemax": gallery["launches_by_rank"][0]},
                         **{f"train_{n}": t["launches"] for n, t in train.items()},
                         **{f"extract_{n}": t["extract_launches"] for n, t in train.items()}}}


FIRST_LAUNCH_TIMEOUT = 300


def first_launch_main() -> int:
    """The ragged forms' first launches on the card, small and checked: the
    pyramid of a 160×120 photo and 20 boxes of it (some outside it, one
    with no area), uint8 and float32 in, float32 and bf16 out, against the
    plain versions and the launches of their own (bit for bit). Started
    beside the parent's build: it waits for the library to appear."""
    from crfr_torch.bench.ragged_levels import photo_boxes
    from crfr_torch.ops import _build
    from crfr_torch.ops import fused_preprocess as fp

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 256, (1, 120, 160, 3), generator=g, device="cuda", dtype=torch.uint8)
    sizes = [(72, 96), (51, 68), (36, 48), (12, 16), (14, 200)]
    boxes = photo_boxes(20, 120, 160, seed=5)
    while not _build.library_path().exists():    # the parent builds it; its limit bounds this
        time.sleep(0.1)
    errs = []
    for xx in (x, x.float()):
        for od, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            got = fp.fused_pyramid_normalize(xx, sizes, "pil", od)
            want = fp.fused_pyramid_normalize_reference(xx, sizes, "pil", od)
            old = [fp.fused_resize_normalize(xx, hw, "pil", od) for hw in sizes]
            crops = fp.fused_crop_resize_normalize(xx[0], boxes, 24, "pil", od)
            crops_want = fp.fused_crop_resize_normalize_reference(xx[0], boxes, 24, "pil", od)
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip([*got, crops], [*want, crops_want]))
            if err > tol or not all(torch.equal(a, b) for a, b in zip(got, old)):
                raise AssertionError(f"first launch {xx.dtype} -> {od}: max_abs_err {err} "
                                     f"(tol {tol}), per-level launches equal: "
                                     f"{[torch.equal(a, b) for a, b in zip(got, old)]}")
            if not torch.equal(crops, old_crops(fp, xx[0], boxes, 24, od)):
                raise AssertionError(f"first launch {xx.dtype}: crops differ from the "
                                     f"per-crop launches")
            errs.append(err)
    print(json.dumps({"max_abs_err": max(errs), "cases": len(errs)}), flush=True)
    return 0


def start_first_launch() -> Background:
    """``first_launch_main`` in a child process under a time limit, started
    before the build so that its start-up overlaps it."""
    return children([sys.executable, str(Path(__file__).resolve()), "--first-launch"],
                    env=_child_env(), timeout=FIRST_LAUNCH_TIMEOUT)


def phase_first_launch(started: Background) -> dict:
    """The first launches' child: a ragged kernel that hangs the card fails
    this phase by name."""
    r = started.result()[0]
    if r.returncode != 0:
        why = (f"killed after {FIRST_LAUNCH_TIMEOUT} s" if started.wall_s >= FIRST_LAUNCH_TIMEOUT
               else f"exit {r.returncode}")
        raise AssertionError(f"first_launch: the ragged forms' first launches ({why}): "
                             f"{r.stderr[-3000:]}")
    return {"phase": "first_launch", **json.loads(r.stdout.strip().splitlines()[-1]),
            "wall_s": started.wall_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank"]:                  # a rank process of phase 24
        return rank_main(*sys.argv[2:4])
    if sys.argv[1:2] == ["--first-launch"]:          # phase 1b's child
        return first_launch_main()
    only = sys.argv[2:3] if sys.argv[1:2] == ["--only"] else []
    from crfr_torch.ops import _build
    from crfr_torch.ops import bank_scan as bs
    from crfr_torch.ops import fused_preprocess as fp

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    first_launch = start_first_launch() if only in ([], ["photo"]) else None
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0})

    if only == ["distributed"]:         # phase 24 alone, with the gallery it compares with
        emit(phase_gallery(bs))
        emit({**phase_distributed(GALLERY_REF, start_dist_cli()), "card": smi})
        return 0
    if only == ["photo"]:               # the detector's kernels and phase 17
        emit(phase_first_launch(first_launch))
        photo, ragged = photo_cases(fp, torch.Generator(device="cuda").manual_seed(1))
        emit({"phase": "kernels", "photo_cases": photo, "kernels": ragged, "card": smi})
        emit({**phase_detect(fp)[0], "card": smi})
        return 0
    if only == ["bn"]:                  # the BN kernels, and the train phases that take them
        bn = phase_kernels_bn()
        emit({"phase": "kernels", "cases": len(bn["cases"])})
        train = phase_train(fp)
        emit({**train, "card": smi})
        emit({**phase_sr_train(fp), "card": smi})
        emit({**phase_distill(fp), "card": smi})
        bn["launches"] = train["launches"][BN_NAME]
        emit({"kernels": [bn], "card": smi, "total_s": time.perf_counter() - t_start})
        return 0
    if only == ["bench"]:               # phases 25-26, with the phases bench compares with
        embed, _ = phase_embed(fp)
        emit({**embed, "card": smi})
        int8_embed = phase_int8_embed(fp)
        emit({**int8_embed, "card": smi})
        emit({**phase_bench(fp, embed, int8_embed), "card": smi})
        fit = start_ms1m_fit()
        emit({**phase_ms1m(fit, ms1m_scale_run(fp)), "card": smi})
        return 0
    emit(phase_first_launch(first_launch))
    kernels = phase_kernels(fp) + [phase_kernels_bank(bs), phase_kernels_lows(fp),
                                   phase_kernels_bn()]
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
    cli = start_cli()               # the CLI's children run beside train_eval and recycle
    train_eval = phase_train_eval(fp)
    emit({**train_eval, "card": smi})
    schedule_soak = start_schedule_soak()       # its children run beside recycle's
    recycle = phase_recycle()
    emit({**recycle, "card": smi})
    emit(phase_cli(cli))
    emit({**phase_schedule_soak(schedule_soak), "card": smi})
    emit(phase_debug())             # before the soak's profiler sessions (see phase_debug)
    soak = phase_soak(fp)
    emit({**soak, "card": smi})
    emit({**phase_roofline(embed), "card": smi})
    torch.cuda.empty_cache()
    sr_train = phase_sr_train(fp)
    emit({**sr_train, "card": smi})
    sr_extract = phase_sr_extract(fp)
    emit({**sr_extract, "card": smi})
    distill = phase_distill(fp)
    emit({**distill, "card": smi})
    sr_cli = start_sr_cli()         # its children run beside distill_cli's
    emit(phase_distill_cli())
    emit(phase_sr_cli(sr_cli))
    int8_embed = phase_int8_embed(fp)
    emit({**int8_embed, "card": smi})
    bench = phase_bench(fp, embed, int8_embed)
    emit({**bench, "card": smi})
    fit = start_ms1m_fit()          # its child runs beside ms1m_scale and int8_cli
    scale = ms1m_scale_run(fp)
    int8_cli = phase_int8_cli(fp, bs)
    emit(int8_cli)
    ms1m = phase_ms1m(fit, scale)
    emit({**ms1m, "card": smi})
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
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        export, ex_state = phase_export(fp, tmp)
        emit({**export, "card": smi})
        serve_artifact, served = phase_serve_artifact(fp, bs, ex_state, tmp)
        emit({**serve_artifact, "card": smi})
        emit(phase_serve_cli(ex_state, served, tmp))
    del ex_state, served
    torch.cuda.empty_cache()
    dist_cli = start_dist_cli()     # phase 24's CLI ranks run beside eval_cli
    eval_cli = phase_eval_cli(fp, bs)
    emit(eval_cli)
    distributed = phase_distributed(GALLERY_REF, dist_cli)
    emit({**distributed, "card": smi})
    # launches on each kernel's own main path: embed for the int form of the
    # preprocessing kernel, the gallery scan for bank_tilemax, a train step
    # for the form with a low per image, an SR train step for the resize
    paths = {"embed": embed["launches"], "gallery": gallery["launches"],
             "serve": serve["launches"], "train": train["launches"],
             **({"train_eval": train_eval["launches"]} if train_eval["run"] else {}),
             "soak": soak["launches"],
             "sr_train": sr_train["launches"], "sr_extract": sr_extract["launches"],
             **{f"distill_{p}": v["launches"] for p, v in distill["paths"].items()},
             "int8_embed": int8_embed["launches"], "bench": bench["bf16"]["launches"],
             "bench_int8": bench["int8"]["launches"], "ms1m_scale": ms1m["launches"],
             **({"int8_cli_match": int8_cli["launches"]} if int8_cli["run"] else {}),
             "headline": headline["launches"], "detect": detect["launches"],
             "train_mtcnn": detect["train_launches"], "recognize": recognize["launches"],
             "mobilefacenet": mobilefacenet["launches"], "export": export["launches"],
             "export_int8": export["int8"]["launches"],
             "export_hallucinated": export["hallucinated"]["launches"],
             "serve_artifact": serve_artifact["launches"],
             **({f"eval_cli_{k}": v for k, v in eval_cli["launches"].items()}
                if eval_cli["run"] else {}),
             # per rank of the two-rank phase: one bank_tilemax a rank, one
             # kernel 1' a rank a step, one kernel 1 a rank a split extract
             **{f"distributed_{k}": v for k, v in distributed["launches"].items()}}
    own = {"bank_tilemax": gallery, LOWS_NAME: train, "fused_resize_normalize": sr_train,
           PYRAMID_NAME: detect, CROP_NAME: detect, BN_NAME: train}
    for k in kernels:
        k["launches"] = own.get(k["name"], embed)["launches"][k["name"]]
        k["launches_by_path"] = {p: v[k["name"]] for p, v in paths.items() if k["name"] in v}
    emit({"kernels": kernels, "card": smi, "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()

"""Sustained training soak (crfr/bench/soak.py) on one CUDA card.

Runs the production train path (packed records → ``train_batches`` →
``ResumableDeviceFeed``, a pinned-host copy on a side stream → ``Trainer``'s
step with one launch of the preprocessing kernel, a low per image), with
in-loop ``.bin`` verification (``make_extract_fn`` degrading to 16 px: one
launch of the int-low kernel a batch) and checkpoints, and splits where
the time goes:

  step-only   the step on a batch already on the card (the ceiling),
              ``bench.throughput.run_train_throughput``
  host-only   the record pipeline's rate (read, flip, batch assembly)
  h2d-only    the pinned host → card copy of a uint8 batch
  fit         the real loop, everything overlapped

so ``fit_over_step`` comes with an attribution: a fit below the step is
the host pipeline or the copy (each measured alone), the evals and
checkpoints inside the window (each timed between two fences:
``eval_s``, ``ckpt_s``, and ``fit_ex_eval_ckpt_*`` without them) or the
loop's own host time: ``host_feed_ms_per_step`` is what the loop's thread
spends in the feed (which assembles the batch after next on that thread),
and on the card ten steps of the fit loop and ten of the step alone, each
run untraced and then traced (``xprof_check._profile``), give the
device's busy ms a step and its idle share of each (busy over the
untraced wall time, and over the traced one, which the profiler's own
host cost lengthens). It also
watches what only a long run shows: per-step drift, loss divergence, host
RSS growth, and the card's peak memory.

    python -m crfr_torch.bench.soak [--steps 2200] [--batch 256] [--device cuda] ...

Prints one JSON line with crfr's keys; ``jit_cache_entries`` is null (no
step is traced or compiled), and ``h2d_imgs_per_sec`` and
``peak_cuda_bytes`` are null on the CPU, which has no copy and no card.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch


def _build_pack(path: str, n_classes: int, per_class: int, size: int,
                seed: int = 0, fmt: str = "raw") -> None:
    """``fmt='raw'`` stores decoded uint8 pixels (no host decode in the hot
    loop); ``fmt='jpeg'`` stores JPEG bytes, so the host-pipeline rate
    includes a real decode per image and the two runs measure its cost."""
    from crfr_torch.data.records import write_pack
    from crfr_torch.data.synthetic import SyntheticFaces

    data = SyntheticFaces(num_classes=n_classes, image_size=size, seed=seed)
    rng = np.random.default_rng(seed + 1)

    def _enc(im: np.ndarray):
        if fmt == "raw":
            return im
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="JPEG", quality=92)
        return buf.getvalue()

    def records():
        for c in range(n_classes):
            imgs, _ = data._of_labels(rng, np.full(per_class, c))
            for im in imgs:
                yield c, _enc(im.astype(np.uint8))

    write_pack(path, records(), fmt=fmt)


def _build_eval_bin(path: str, n_classes: int, size: int, n_pairs: int = 600,
                    seed: int = 7) -> None:
    from crfr_torch.data.bins import save_bin
    from crfr_torch.data.synthetic import SyntheticFaces

    data = SyntheticFaces(num_classes=n_classes, image_size=size, seed=seed)
    i1, i2, issame = data.eval_pairs(np.random.default_rng(seed), n_pairs)
    save_bin(path, i1, i2, issame)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2200)
    ap.add_argument("--warm-steps", type=int, default=100,
                    help="steps excluded from the steady-state window")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--backbone", default="ir_50")
    ap.add_argument("--image-size", type=int, default=112)
    ap.add_argument("--classes", type=int, default=200)
    ap.add_argument("--per-class", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--fmt", default="raw", choices=("raw", "jpeg"),
                    help="record payload: decoded pixels or JPEG (a host decode an image)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run_soak(args: argparse.Namespace) -> dict:
    from crfr_torch.bench.throughput import _fence, run_train_throughput
    from crfr_torch.bench.xprof_check import _card
    from crfr_torch.configs import get_config
    from crfr_torch.data.bins import evaluate_bin
    from crfr_torch.data.pipeline import PipelineCfg, train_batches
    from crfr_torch.data.records import open_source
    from crfr_torch.device import resolve_device
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.feed import ResumableDeviceFeed
    from crfr_torch.train.loop import Trainer
    from crfr_torch.utils.logging import MetricsWriter

    dev = resolve_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="crfr_torch_soak_")
    os.makedirs(work, exist_ok=True)
    pack = os.path.join(work, f"train_{args.fmt}.crfrpack")
    ebin = os.path.join(work, "pairs.bin")
    t0 = time.perf_counter()
    if not os.path.exists(pack):
        _build_pack(pack, args.classes, args.per_class, args.image_size, fmt=args.fmt)
    if not os.path.exists(ebin):
        _build_eval_bin(ebin, args.classes, args.image_size)
    t_fixture = time.perf_counter() - t0
    print(f"# fixtures built in {t_fixture:.0f}s ({args.classes}x{args.per_class} imgs)",
          file=sys.stderr, flush=True)

    cfg = get_config("casia_arcface", [
        f"data.image_size={args.image_size}", f"data.num_classes={args.classes}",
        f"model.backbone={args.backbone}", f"model.input_size={args.image_size}",
        f"train.batch_size={args.batch}", "train.warmup_steps=100",
        f"train.checkpoint_dir={work}/ckpt", "train.log_every=100000000"])
    metrics = MetricsWriter(os.path.join(work, "soak_metrics.jsonl"), stdout=False)
    tr = Trainer(cfg, steps_per_epoch=1000, metrics=metrics, device=dev)
    ck = Checkpointer(cfg.train.checkpoint_dir, keep=2)
    source = open_source(pack)

    # ---- host-pipeline-only rate (read, flip, batch assembly) ----
    probe = train_batches(source, PipelineCfg(batch_size=args.batch, seed=9))
    next(probe)                                     # pipeline warmup
    t0 = time.perf_counter()
    for _ in range(20):
        next(probe)
    host_ips = 20 * args.batch / (time.perf_counter() - t0)
    probe.close()

    # ---- pinned host → card copy of a uint8 batch (none on the CPU) ----
    h2d_ips = None
    if dev.type == "cuda":
        imgs_np = np.random.default_rng(0).integers(
            0, 256, (args.batch, args.image_size, args.image_size, 3)).astype(np.uint8)
        pinned = torch.from_numpy(imgs_np).pin_memory()
        pinned.to(dev, non_blocking=True)
        _fence(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            pinned.to(dev, non_blocking=True)
        _fence(dev)
        h2d_ips = 20 * args.batch / (time.perf_counter() - t0)

    # ---- the soak: the real loop with eval and checkpoints ----
    feed = ResumableDeviceFeed(train_batches(source, PipelineCfg(
        batch_size=args.batch, seed=cfg.train.seed, random_flip=True)), dev)
    eval_fn = make_extract_fn(tr.backbone_apply, state_fn=tr.embed_state, degrade_to=16,
                              resize_mode=cfg.data.resize_mode,
                              flip_fusion=cfg.eval.flip_fusion, image_size=args.image_size,
                              device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    evals, losses, compile_s = [], [], 0.0
    ckpt_s = eval_s = paused_s = 0.0                # paused_s: inside the steady window
    t_start = t_mark = time.perf_counter()
    mark_step = 0
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    m = {}
    feed_s = 0.0                                    # the loop's thread inside the feed
    for i in range(args.steps):
        t_feed = time.perf_counter()
        di, dl = next(feed)
        if i > args.warm_steps:
            feed_s += time.perf_counter() - t_feed
        m = tr.train_step(di, dl)
        step = tr.host_step
        if i == 0:
            _fence(dev)
            compile_s = time.perf_counter() - t_start
            t_mark, mark_step = time.perf_counter(), i + 1
        if i == args.warm_steps:                    # the steady window starts
            _fence(dev)
            t_mark, mark_step = time.perf_counter(), i + 1
        if step % args.ckpt_every == 0 or step % args.eval_every == 0:
            _fence(dev)                             # time the pause inside the window
            t_pause = time.perf_counter()
            if step % args.ckpt_every == 0:
                ck.save(step, tr.state, cfg.to_json())
                ckpt_s += time.perf_counter() - t_pause
            if step % args.eval_every == 0:
                t_eval = time.perf_counter()
                res = evaluate_bin(ebin, eval_fn, 256, args.image_size, 5, device=dev)
                evals.append(round(res.accuracy_mean, 4))
                metrics.write(step, eval_accuracy=res.accuracy_mean)
                _fence(dev)
                eval_s += time.perf_counter() - t_eval
            if i > args.warm_steps:
                paused_s += time.perf_counter() - t_pause
        if step % 500 == 0:
            losses.append(round(float(m["loss"]), 3))
    _fence(dev)
    dt = time.perf_counter() - t_mark
    fit_ips = (args.steps - mark_step) * args.batch / dt
    fit_ex_ips = (args.steps - mark_step) * args.batch / (dt - paused_s)
    final_loss = float(m["loss"])
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    traced = {}
    if dev.type == "cuda":
        # the device's idle share of the fit loop against the step alone
        # (one batch already on the card), each over 10 traced steps
        from crfr_torch.bench.xprof_check import _TRAIN_GROUPS, _profile

        fit_r = _profile(lambda: tr.train_step(*next(feed)), 10, dev, 4, _TRAIN_GROUPS)
        x, y = next(feed)
        step_r = _profile(lambda: tr.train_step(x, y), 10, dev, 4, _TRAIN_GROUPS)
        # the profiler's own host cost slows a host-paced loop, so the idle
        # share is also taken against the untraced window's wall time
        traced = {"fit_wall_ms_per_step": fit_r["wall_ms"],
                  "fit_device_busy_ms_per_step": fit_r["device_busy_ms"],
                  "fit_idle_share": 1.0 - fit_r["device_busy_ms"] / fit_r["wall_ms"],
                  "fit_idle_share_traced": fit_r["idle_share_traced"],
                  "step_wall_ms_per_step": step_r["wall_ms"],
                  "step_device_busy_ms_per_step": step_r["device_busy_ms"],
                  "step_idle_share": 1.0 - step_r["device_busy_ms"] / step_r["wall_ms"],
                  "step_idle_share_traced": step_r["idle_share_traced"]}
    feed.close()
    ck.close()
    metrics.close()
    del tr, feed

    # ---- step-only ceiling: the step on a batch already on the device ----
    step_res = run_train_throughput(batch=args.batch, steps=10, repeats=3,
                                    backbone=args.backbone, num_classes=args.classes,
                                    image_size=args.image_size, device=dev)
    serial = (1.0 / (1.0 / host_ips + 1.0 / h2d_ips)) if h2d_ips else host_ips
    return {
        "metric": "soak_fit_imgs_per_sec",
        "steps": args.steps,
        "batch": args.batch,
        "fmt": args.fmt,
        "backbone": args.backbone,
        "device": str(dev),
        "card": _card() if dev.type == "cuda" else "cpu",
        "fit_imgs_per_sec": round(fit_ips, 1),
        "step_only_imgs_per_sec": round(step_res.imgs_per_sec, 1),
        "fit_over_step": round(fit_ips / step_res.imgs_per_sec, 4),
        "fit_ex_eval_ckpt_imgs_per_sec": round(fit_ex_ips, 1),
        "fit_ex_eval_ckpt_over_step": round(fit_ex_ips / step_res.imgs_per_sec, 4),
        "eval_s": round(eval_s, 3),
        "ckpt_s": round(ckpt_s, 3),
        "host_feed_ms_per_step": round(1e3 * feed_s / max(args.steps - mark_step, 1), 3),
        **traced,
        "host_pipeline_imgs_per_sec": round(host_ips, 1),
        "h2d_imgs_per_sec": None if h2d_ips is None else round(h2d_ips, 1),
        "serial_host_bound_imgs_per_sec": round(serial, 1),
        "compile_s": round(compile_s, 2),
        "step_only_first_step_s": round(step_res.first_step_seconds, 2),
        "losses_every_500": losses,
        "final_loss": round(final_loss, 3),
        "eval_accuracy": evals,
        "jit_cache_entries": None,
        "max_rss_growth_mb": round((rss1 - rss0) / 1024, 1),
        "peak_cuda_bytes": peak,
        "step_only_peak_cuda_bytes": step_res.peak_bytes if dev.type == "cuda" else None,
        "fixtures_s": round(t_fixture, 1),
        "workdir": work,
    }


def main(argv=None) -> int:
    print(json.dumps(run_soak(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

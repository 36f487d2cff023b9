"""A FIT run at MS1M's class count through the production path
(scripts/ms1m_fit.py).

    python -m crfr_torch.bench.ms1m_fit [--workdir DIR] [--classes 85742]
        [--steps 200] [--batch 256] [--image-size 112] [--backbone ir_50]
        [--hard 1.0] [--seed 0] [--analyze-only] [--device cuda|cpu]

``bench.ms1m_scale`` times the step at C=85,742 on one repeated batch:
memorisation by design. This runs ``--steps`` steps at the same C on
unique data through what a user runs: a ``.crfrpack`` of
``steps × batch`` hard renders (``data.render.RenderedIdentities``, each
image seen once) → the record pipeline → ``train.feed`` → the train step,
driven by ``python -m crfr_torch train`` in a child process. It reports:

- the steady wall step against the device-resident step at the same shape
  and config (``run_train_throughput`` on the card, measured before the
  run and kept in ``<workdir>/device_step.json`` for ``--analyze-only``);
  their difference is the feed's overhead. On the CPU nothing is measured
  and both keys are null;
- the loss over unique data (any descent is optimisation, not
  memorisation), by quarter of the run;
- the metrics stream's continuity (a row every 10 steps, no gap).

The pack is cached in the workdir under its size; a build writes a
temporary file and renames it, so a killed build leaves no truncated pack.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE_STEP_FILE = "device_step.json"


def build_pack(workdir: str, *, n_imgs: int, classes: int, image_size: int,
               hard: float, seed: int) -> str:
    """``n_imgs`` hard renders with labels drawn over ``classes`` → the path
    of the cached ``.crfrpack`` (``crfr``'s bytes)."""
    from crfr_torch.data.records import write_pack
    from crfr_torch.data.render import RenderedIdentities

    os.makedirs(workdir, exist_ok=True)
    pack = os.path.join(workdir, f"ms1m_fit_c{classes}_n{n_imgs}.crfrpack")
    if os.path.exists(pack):
        return pack
    faces = RenderedIdentities(classes, image_size, seed=seed, hard=hard)
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, classes, n_imgs)

    def records():
        for i, c in enumerate(labels):
            yield int(c), faces.render(int(c), rng).astype(np.uint8)
            if i % 5000 == 4999:
                print(f"# rendered {i + 1}/{n_imgs}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    write_pack(pack + ".tmp", records(), fmt="raw")
    os.replace(pack + ".tmp", pack)
    print(f"# pack: {n_imgs} hard renders over C={classes} in "
          f"{time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)
    return pack


def train_overrides(pack: str, ckdir: str, *, steps: int, classes: int, image_size: int,
                    backbone: str, batch: int, seed: int) -> list[str]:
    """The ``train`` flags and key=value overrides of the run (``crfr``'s)."""
    return [
        "--preset", "casia_arcface",
        "--max-steps", str(steps),
        "--steps-per-epoch", str(steps),
        f"data.train_records={pack}",
        f"data.image_size={image_size}",
        f"data.num_classes={classes}",
        "loss.ce_impl=streaming",
        f"model.backbone={backbone}",
        f"model.input_size={image_size}",
        f"train.batch_size={batch}",
        "train.lr=0.1", "train.warmup_steps=50",
        "train.schedule=step", "train.lr_drop_epochs=[]",
        "train.epochs=1",
        f"train.checkpoint_dir={ckdir}",
        "train.eval_every_steps=1000000000",
        "train.checkpoint_every_steps=1000000000",
        "train.keep_checkpoints=1",
        "train.log_every=10",
        f"train.seed={seed}",
    ]


def measure_device_step(workdir: str, overrides: list[str], device: str,
                        steps: int = 10) -> None:
    """The device-resident step of the run's config on the card (its batch
    already on the device, no feed), written to ``<workdir>/device_step.json``;
    nothing on the CPU, where no device number exists."""
    path = os.path.join(workdir, DEVICE_STEP_FILE)
    if os.path.exists(path):
        os.remove(path)
    if device == "cpu":
        return
    from crfr_torch.bench.throughput import run_train_throughput
    from crfr_torch.configs import get_config

    kv = [o for o in overrides if "=" in o and not o.startswith("data.train_records=")]
    r = run_train_throughput(steps=steps, device=device, cfg=get_config("casia_arcface", kv))
    rec = {"device_step_ms": r.ms_per_step, "device": r.device, "steps": steps,
           "windows_imgs_per_sec": r.imgs_per_sec_windows, "peak_bytes": r.peak_bytes}
    with open(path, "w") as f:
        json.dump(rec, f)


def analyze(metrics_path: str, *, classes: int, backbone: str, batch: int, steps: int,
            device_step: dict | None) -> dict:
    """``crfr``'s summary of the run's ``metrics.jsonl``, with the step
    reference of ``measure_device_step`` (or null)."""
    rows = []
    with open(metrics_path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    loss = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    ips = [(r["step"], r["imgs_per_sec"]) for r in rows if "imgs_per_sec" in r]
    logged = [s for s, _ in loss]
    gaps = [(a, b) for a, b in zip(logged, logged[1:]) if b != a + 10]
    half = len(ips) // 2
    steady_ips = float(np.median([v for _, v in ips[half:]])) if ips else 0.0
    wall_ms = 1e3 * batch / steady_ips if steady_ips else None

    def win(lo, hi):
        vals = [v for s, v in loss if lo <= s < hi]
        return round(float(np.mean(vals)), 3) if vals else None

    q = steps // 4
    ref = device_step["device_step_ms"] if device_step else None
    return {
        "metric": "ms1m_fit",
        "classes": classes, "backbone": backbone,
        "batch": batch, "steps": steps,
        "unique_imgs": steps * batch, "epochs_of_data": 1.0,
        "steady_imgs_per_sec": round(steady_ips, 1),
        "steady_wall_step_ms": round(wall_ms, 1) if wall_ms else None,
        # the device-resident step of the same shape, measured on the card
        "device_step_ms_ref": round(ref, 2) if ref is not None else None,
        "device_step_device": device_step["device"] if device_step else None,
        "feed_overhead_ms": (round(wall_ms - ref, 1)
                             if wall_ms and ref is not None else None),
        "loss_first": loss[0][1] if loss else None,
        "loss_quarters": [win(i * q, (i + 1) * q) for i in range(4)],
        "continuity_gaps": gaps,
        "final_step": logged[-1] if logged else 0,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m crfr_torch.bench.ms1m_fit")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "crfr_ms1m_fit"))
    ap.add_argument("--classes", type=int, default=85742)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=112)
    ap.add_argument("--backbone", default="ir_50")
    ap.add_argument("--hard", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--analyze-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ckdir = os.path.join(args.workdir, "ckpt")
    if not args.analyze_only:
        from crfr_torch.device import resolve_device

        resolve_device(args.device)
        pack = build_pack(args.workdir, n_imgs=args.steps * args.batch, classes=args.classes,
                          image_size=args.image_size, hard=args.hard, seed=args.seed)
        ov = train_overrides(pack, ckdir, steps=args.steps, classes=args.classes,
                             image_size=args.image_size, backbone=args.backbone,
                             batch=args.batch, seed=args.seed)
        measure_device_step(args.workdir, ov, args.device)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            filter(None, [pkg_root, os.environ.get("PYTHONPATH")]))}
        env.pop("CRFR_RECYCLE_GEN", None)
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, "-m", "crfr_torch", "train", *ov,
                             "--device", args.device], env=env).returncode
        if rc != 0:
            print(json.dumps({"error": f"training rc={rc}"}))
            return rc
        print(f"# training wall {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)

    ref = None
    ref_path = os.path.join(args.workdir, DEVICE_STEP_FILE)
    if os.path.exists(ref_path):
        with open(ref_path) as f:
            ref = json.load(f)
    out = analyze(os.path.join(ckdir, "metrics.jsonl"), classes=args.classes,
                  backbone=args.backbone, batch=args.batch, steps=args.steps,
                  device_step=ref)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

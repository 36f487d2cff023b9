"""Multi-epoch schedule soak (crfr/bench/schedule_soak.py) on one CUDA card.

The plain soak (``bench/soak.py``) shows the loop's numbers and stability,
but its synthetic set is separable, so the loss saturates long before the
LR schedule matters. This harness runs the schedule on a task that does
not saturate:

  - images packed from the hard renderer (``data/render.py``: identity in
    geometry and fine texture; pose, illumination, background, occlusion,
    blur, JPEG and noise per sample) as raw records, so the host's decode
    does not throttle the run;
  - several epochs through the production entry point (``python -m
    crfr_torch train``: records → ``train_batches`` → ``ResumableDeviceFeed``
    → the step), with a linear warmup and two step-drops of the LR whose
    boundaries cross epoch boundaries;
  - the process killed and resumed mid-schedule by ``--recycle-every-steps``
    (checkpoint → exec a fresh process → bitwise resume; ``metrics.jsonl``
    appends across the generations into one stream);
  - ``.bin`` verification on held-out identities every half epoch
    (``--eval-bin``, BN in eval mode: the trajectory watches the drift);
  - an analysis afterwards: the LR trajectory (warmup and the drop factors
    read from the log), the loss around each drop, the eval trajectory, the
    BN running statistics' relative change between consecutive kept
    checkpoints (→ 0 as they settle), and the stream's continuity across
    the recycles.

    python -m crfr_torch.bench.schedule_soak [--workdir D] [--smoke] [--device cuda]

Prints one JSON summary line; the fixtures and the run are cached and
checkpointed under ``--workdir``, so a second call resumes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


# ---------------------------------------------------------------------------
# Fixtures: hard-renderer pack + held-out-identity eval pairs
# ---------------------------------------------------------------------------

def build_fixtures(workdir: str, *, ids: int, train_ids: int, per_id: int,
                   image_size: int, n_pairs: int, seed: int = 0,
                   hard: float = 1.0) -> tuple[str, str]:
    """Render (cached) the packed train set and the eval ``.bin``.

    Train records cover identities [0, train_ids), ``per_id`` renders each,
    grouped by class (the pipeline reshuffles every epoch). Eval pairs come
    from the held-out range [train_ids, ids), genuine and impostor
    interleaved (``RenderedIdentities.eval_pairs``): verification on people
    the model never saw, as LFW's protocol."""
    import numpy as np

    from crfr_torch.data.bins import save_bin
    from crfr_torch.data.records import write_pack
    from crfr_torch.data.render import RenderedIdentities

    os.makedirs(workdir, exist_ok=True)
    # the hardness is in the rendered pixels, so in the cache's name
    tag = f"_h{hard:g}" if hard else ""
    pack = os.path.join(workdir, f"train_hard{tag}.crfrpack")
    ebin = os.path.join(workdir, f"pairs_heldout{tag}.bin")
    faces = None
    if not os.path.exists(pack):
        faces = RenderedIdentities(ids, image_size, seed=seed, hard=hard)
        rng = np.random.default_rng(seed + 1)

        def records():
            for c in range(train_ids):
                for im in faces.sample_for_ids(rng, np.full(per_id, c)):
                    yield c, im.astype(np.uint8)

        t0 = time.perf_counter()
        # write, then rename: a killed build leaves no truncated pack behind
        write_pack(pack + ".tmp", records(), fmt="raw")
        os.replace(pack + ".tmp", pack)
        print(f"# pack: {train_ids}x{per_id} hard renders in "
              f"{time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)
    if not os.path.exists(ebin):
        faces = faces or RenderedIdentities(ids, image_size, seed=seed, hard=hard)
        i1, i2, issame = faces.eval_pairs(np.random.default_rng(seed + 2), n_pairs,
                                          id_range=(train_ids, ids))
        save_bin(ebin, i1.astype(np.uint8), i2.astype(np.uint8), issame)
    return pack, ebin


# ---------------------------------------------------------------------------
# The run: the production CLI trainer, recycled mid-schedule
# ---------------------------------------------------------------------------

def run_training(workdir: str, pack: str, ebin: str, *, backbone: str,
                 image_size: int, num_classes: int, batch: int,
                 steps_per_epoch: int, epochs: int, lr: float,
                 warmup_steps: int, drop_epochs: tuple[int, ...],
                 recycle_every: int, eval_every: int, ckpt_every: int,
                 keep: int, seed: int = 0, log_every: int = 25,
                 device: str = "cuda") -> int:
    """Run ``python -m crfr_torch train`` (the production entry point) in a
    child process; ``--recycle-every-steps`` makes it checkpoint and exec a
    fresh generation mid-run while ``metrics.jsonl`` stays one stream."""
    ckdir = os.path.join(workdir, "ckpt")
    max_steps = epochs * steps_per_epoch
    cmd = [
        sys.executable, "-m", "crfr_torch", "train",
        "--preset", "casia_arcface",
        "--device", device,
        "--max-steps", str(max_steps),
        "--steps-per-epoch", str(steps_per_epoch),
        "--eval-bin", ebin,
        "--resume",                      # idempotent: a fresh directory starts at 0
        f"data.train_records={pack}",
        f"data.image_size={image_size}",
        f"data.num_classes={num_classes}",
        f"model.backbone={backbone}",
        f"model.input_size={image_size}",
        f"train.batch_size={batch}",
        f"train.lr={lr}",
        "train.schedule=step",
        f"train.warmup_steps={warmup_steps}",
        f"train.lr_drop_epochs={list(drop_epochs)}",
        f"train.epochs={epochs}",
        f"train.checkpoint_dir={ckdir}",
        f"train.eval_every_steps={eval_every}",
        f"train.checkpoint_every_steps={ckpt_every}",
        f"train.keep_checkpoints={keep}",
        f"train.log_every={log_every}",
        f"train.seed={seed}",
    ]
    if recycle_every:
        cmd += ["--recycle-every-steps", str(recycle_every)]
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [pkg_root, os.environ.get("PYTHONPATH")]))}
    env.pop("CRFR_RECYCLE_GEN", None)
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, env=env, stdout=subprocess.DEVNULL).returncode
    print(f"# training rc={rc} in {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)
    return rc


# ---------------------------------------------------------------------------
# Post-hoc analysis of the metrics stream + checkpoints
# ---------------------------------------------------------------------------

def _read_jsonl(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _window_mean(rows: list[tuple[int, float]], lo: int, hi: int) -> float | None:
    vals = [v for s, v in rows if lo <= s < hi]
    return sum(vals) / len(vals) if vals else None


def bn_drift(ckdir: str) -> list[dict]:
    """Relative L2 change of the BN running statistics (every
    ``running_mean`` and ``running_var`` of the model) between consecutive
    kept checkpoints: the eval-mode drift watch."""
    import numpy as np
    import torch

    from crfr_torch.train.checkpoints import Checkpointer

    if not os.path.isdir(ckdir):
        return []
    ck = Checkpointer(ckdir)
    out = []
    prev = prev_step = None
    for s in ck.steps():
        model = ck.restore(step=s)["model"]
        keys = sorted(k for k in model if k.endswith(("running_mean", "running_var")))
        flat = (torch.cat([model[k].float().reshape(-1) for k in keys]).numpy()
                if keys else np.zeros(1))
        if prev is not None:
            num = float(np.linalg.norm(flat - prev))
            den = float(np.linalg.norm(prev)) or 1.0
            out.append({"from_step": prev_step, "to_step": s, "rel_l2": round(num / den, 5)})
        prev, prev_step = flat, s
    return out


def analyze(workdir: str, *, steps_per_epoch: int, epochs: int, lr: float,
            warmup_steps: int, drop_epochs: tuple[int, ...],
            drop_factor: float = 0.1, window: int = 50) -> dict:
    ckdir = os.path.join(workdir, "ckpt")
    rows = _read_jsonl(os.path.join(ckdir, "metrics.jsonl"))
    loss = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    lrs = [(r["step"], r["lr"]) for r in rows if "lr" in r]
    evals = [(r["step"], r["eval_accuracy"]) for r in rows if "eval_accuracy" in r]
    recycles = _read_jsonl(os.path.join(ckdir, "recycles.jsonl"))
    max_steps = epochs * steps_per_epoch

    # continuity: one increasing stream, no gap wider than the log cadence
    steps = [s for s, _ in loss]
    gaps = [(a, b) for a, b in zip(steps, steps[1:]) if not a < b <= a + 100]

    # warmup: the first logged lr below the peak, and the peak == cfg lr
    # (the logged lr is a float; a relative tolerance)
    def _near(a, b):
        return abs(a - b) <= 1e-5 * max(abs(a), abs(b))

    warm_ok = bool(lrs) and lrs[0][1] < lr * 0.999 and any(
        _near(v, lr) for s, v in lrs if s <= warmup_steps + 100)
    # drops: the logged lr after each boundary == lr * factor^k
    drop_checks = []
    for k, e in enumerate(drop_epochs, start=1):
        boundary = e * steps_per_epoch
        want = lr * (drop_factor ** k)
        got = next((v for s, v in lrs if s >= boundary), None)
        before = _window_mean(loss, boundary - window, boundary)
        after = _window_mean(loss, boundary, boundary + window)
        drop_checks.append({
            "epoch": e, "step": boundary, "lr_want": want, "lr_got": got,
            "lr_ok": got is not None and _near(got, want),
            "loss_before": None if before is None else round(before, 4),
            "loss_after": None if after is None else round(after, 4),
        })
    return {
        "steps_logged": len(loss),
        "final_step": steps[-1] if steps else 0,
        "expected_final_step": max_steps,
        "continuity_gaps": gaps,
        "warmup_ok": warm_ok,
        "drops": drop_checks,
        "loss_per_epoch": [
            {"epoch": e + 1,
             "mean_loss": round(_window_mean(
                 loss, e * steps_per_epoch, (e + 1) * steps_per_epoch) or float("nan"), 4)}
            for e in range(epochs)],
        "eval_trajectory": [{"step": s, "acc": round(v, 4)} for s, v in evals],
        "recycles": [{"step": r.get("step"), "gen": r.get("gen"),
                      "max_rss_mb": r.get("max_rss_mb")} for r in recycles],
        "bn_drift": bn_drift(ckdir),
    }


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "crfr_torch_schedule_soak"))
    ap.add_argument("--ids", type=int, default=500)
    ap.add_argument("--train-ids", type=int, default=450)
    ap.add_argument("--per-id", type=int, default=112)
    ap.add_argument("--image-size", type=int, default=112)
    ap.add_argument("--backbone", default="ir_50")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--warmup-steps", type=int, default=150)
    ap.add_argument("--drop-epochs", default="3,4")
    ap.add_argument("--recycle-every", type=int, default=450)
    ap.add_argument("--n-pairs", type=int, default=500)
    ap.add_argument("--hard", type=float, default=1.0,
                    help="the renderer's HR nuisance intensity (occlusion, blur, JPEG, pose; "
                         "0 = the easy regime where held-out eval saturates)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--analyze-only", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny everything: proves the harness, not the schedule")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.ids, args.train_ids, args.per_id = 24, 16, 24
        args.image_size, args.backbone, args.batch = 64, "ir_18", 32
        args.epochs, args.warmup_steps = 4, 8
        args.drop_epochs, args.recycle_every = "2,3", 20
        args.n_pairs = 32

    drops = tuple(int(x) for x in args.drop_epochs.split(",") if x)
    n_train = args.train_ids * args.per_id
    spe = n_train // args.batch
    eval_every = max(spe // 2, 1)
    ckpt_every = max(spe // 2, 1)
    keep = 2 * args.epochs + 2

    t0 = time.perf_counter()
    if not args.analyze_only:
        pack, ebin = build_fixtures(
            args.workdir, ids=args.ids, train_ids=args.train_ids, per_id=args.per_id,
            image_size=args.image_size, n_pairs=args.n_pairs, seed=args.seed,
            hard=args.hard)
        rc = run_training(
            args.workdir, pack, ebin, backbone=args.backbone, image_size=args.image_size,
            num_classes=args.train_ids, batch=args.batch, steps_per_epoch=spe,
            epochs=args.epochs, lr=args.lr, warmup_steps=args.warmup_steps,
            drop_epochs=drops, recycle_every=args.recycle_every, eval_every=eval_every,
            ckpt_every=ckpt_every, keep=keep, seed=args.seed,
            log_every=1 if args.smoke else 25, device=args.device)
        if rc != 0:
            print(json.dumps({"error": f"training rc={rc}"}), flush=True)
            return rc

    out = {"metric": "schedule_realism", "n_train_imgs": n_train, "steps_per_epoch": spe,
           "epochs": args.epochs, "batch": args.batch, "backbone": args.backbone,
           "warmup_steps": args.warmup_steps, "drop_epochs": list(drops), "hard": args.hard,
           "device": args.device,
           **analyze(args.workdir, steps_per_epoch=spe, epochs=args.epochs, lr=args.lr,
                     warmup_steps=args.warmup_steps, drop_epochs=drops),
           "wall_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The training and gallery commands on N cards against one card.

    python -m crfr_torch.bench.multicard [--cards 4] [--steps 20]
        [--device cuda|cpu] [key=value ...]

1. ``python -m crfr_torch train --preset casia_arcface mesh.data=2
   mesh.model=N/2`` as N processes under torchrun (NCCL on cards, gloo
   with ``--device cpu``), then the same preset in one process on one
   device, ``--steps`` steps each on synthetic batches (each rank draws its
   own slab of the global batch, so the two runs see different images):
   the loss of every step of both, and ms a step over the second half of
   the steps from the metrics' wall clock.
2. ``python -m crfr_torch match --probe-npy`` against an int8 ``.npz`` bank
   of ``--bank-rows`` seeded unit rows with 256 probes planted, as N
   processes (the rows sharded N ways, kernel 3 once a rank) and as one:
   the top-k labels of both must be equal, and the planted row first.

Prints one JSON line with the device's name and count and both runs'
numbers; key=value overrides go to both ``train`` runs. Writes under a
temporary directory in ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def _run(argv: list[str], timeout: float) -> str:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])}
    r = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(argv[:6])} ...: exit {r.returncode}\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout


def _torchrun(n: int) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}"]


def _train_run(prefix: list[str], ckpt: str, steps: int, device: str, overrides: list[str],
               timeout: float) -> dict:
    t0 = time.perf_counter()
    _run([*prefix, "-m", "crfr_torch", "train", "--preset", "casia_arcface", "--device",
          device, f"train.checkpoint_dir={ckpt}", "train.log_every=1",
          f"train.checkpoint_every_steps={steps}", "--max-steps", str(steps), *overrides],
         timeout)
    wall = time.perf_counter() - t0
    rows = [json.loads(ln) for ln in Path(ckpt, "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if "loss" in r]
    half = len(rows) // 2
    ms = (rows[-1]["t"] - rows[half - 1]["t"]) / (len(rows) - half) * 1e3
    return {"losses": [r["loss"] for r in rows], "ms_per_step_second_half": ms,
            "wall_s": wall, "steps": len(rows)}


def _match_run(prefix: list[str], bank: str, probes: str, device: str,
               timeout: float) -> np.ndarray:
    out = _run([*prefix, "-m", "crfr_torch", "match", "--device", device, "--gallery-npy",
                bank, "--probe-npy", probes, "--k", "10"], timeout)
    last = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    return np.asarray([m["labels"] for m in json.loads(last)["matches"]])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="crfr_torch.bench.multicard")
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--bank-rows", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=900)
    args, overrides = ap.parse_known_args(argv)
    import torch

    from crfr_torch.eval.bank import quantize_bank, save_bank

    n = args.cards
    if n % 2:
        raise ValueError("--cards must be even: the mesh is (2, cards / 2)")
    mesh = [f"mesh.data=2", f"mesh.model={n // 2}"]
    if args.device == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} cards wanted, {torch.cuda.device_count()} visible")
        device = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    else:
        device = {"name": "cpu", "count": n}
    Path(ROOT, "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=Path(ROOT, "build")) as tmp:
        many = _train_run(_torchrun(n), f"{tmp}/many", args.steps, args.device,
                          [*mesh, *overrides], args.timeout)
        one = _train_run([sys.executable], f"{tmp}/one", args.steps, args.device, overrides,
                         args.timeout)

        rng = np.random.default_rng(0)
        rows = rng.normal(size=(args.bank_rows, 512)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        planted = rng.choice(args.bank_rows, 256, replace=False)
        probes = rows[planted] + rng.normal(0, 0.02, (256, 512)).astype(np.float32)
        save_bank(f"{tmp}/bank.npz", quantize_bank(rows, np.arange(args.bank_rows)))
        np.save(f"{tmp}/probes.npy", probes)
        del rows
        t0 = time.perf_counter()
        got = _match_run(_torchrun(n), f"{tmp}/bank.npz", f"{tmp}/probes.npy", args.device,
                         args.timeout)
        many_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = _match_run([sys.executable], f"{tmp}/bank.npz", f"{tmp}/probes.npy",
                          args.device, args.timeout)
        one_s = time.perf_counter() - t0
    match = {"rows": args.bank_rows, "probes": 256, "k": 10,
             "labels_equal": bool(np.array_equal(got, want)),
             "top1_planted": int((got[:, 0] == planted).sum()),
             "wall_s_many": many_s, "wall_s_one": one_s}
    print(json.dumps({"device": device, "cards": n, "mesh": [2, n // 2],
                      "train_many": many, "train_one": one, "match": match}), flush=True)
    return 0 if match["labels_equal"] and match["top1_planted"] == 256 else 1


if __name__ == "__main__":
    sys.exit(main())

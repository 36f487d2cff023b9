"""Kernel 1′ (the preprocessing form with a low per image) and the steps
that run it, in turns in two checkouts on one CUDA card.

    python -m crfr_torch.bench.lows_ab --parent DIR [--order parent,change,change,parent]

``DIR`` is another checkout of the repo (say, the parent commit unpacked
with ``git archive`` under ``build/``); this checkout is ``change``. Each
turn is a process of its own, run in its checkout with that checkout on
``PYTHONPATH``: ``chip_smoke.py``'s ``phase_kernels_lows`` there (the
kernel against its plain version, float64 and the int form, each case
timed behind a spin; uint8 → bf16 and f32 → f32 at B=512, lows 8–112,
pil), then ``casia_arcface`` train steps and bicubic KD steps at B=512 on
one device-resident uint8 batch: three warm steps, one step with the
launch counters read around it, and three windows of ten steps
(``chip_smoke._windows``). One JSON line a part and turn, each with its tag
and the card's name and power limit. Compare the two sides only within one
run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _steps(cs, fp, tag: str, part: str, step, b: int) -> None:
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    cs._zero_counts(fp)
    step()
    torch.cuda.synchronize()
    launches = cs._counts(fp)
    windows = cs._windows(step, b, steps=10, repeats=3)
    ips = len(windows) * b / sum(b / w for w in windows)
    print(json.dumps({"tag": tag, "card": _card(), part: {
        "launches": launches, "imgs_per_s_windows": windows, "ms_per_step": 1e3 * b / ips}}),
        flush=True)


def turn(tag: str) -> None:
    """One side's measurements, in the checkout this process runs in."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from crfr_torch.configs import get_config
    from crfr_torch.ops import fused_preprocess as fp
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer

    k = cs.phase_kernels_lows(fp)
    cases = [{key: c.get(key) for key in ("in", "out", "mode", "ms", "plain_ms", "library_ms",
                                          "bound_ms", "max_abs_err", "cold_ms", "ms_by_rows")}
             | {"plan": {key: c["plan"].get(key)
                         for key in ("registers", "spill_bytes", "smem_bytes", "ctas",
                                     "ctas_per_sm", "smem_budget", "rows_by_low")}}
             for c in k["cases"] if c.get("ms") is not None]
    print(json.dumps({"tag": tag, "card": _card(), "kernel": {
        "launches_a_call": k.get("launches_a_call"), "cases": cases}}), flush=True)

    b = cs.TRAIN_B
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randint(0, 256, (b, cs.S, cs.S, 3), generator=g, device="cuda", dtype=torch.uint8)
    cfg = get_config("casia_arcface", ["train.warmup_steps=0"])
    y = torch.randint(0, cfg.data.num_classes, (b,), generator=g, device="cuda")
    tr = Trainer(cfg, device="cuda")
    _steps(cs, fp, tag, "train", lambda: tr.train_step(x, y), b)
    del tr
    torch.cuda.empty_cache()
    cfg = get_config("casia_arcface", ["train.warmup_steps=0", "loss.distill_weight=1.0"])
    st = DistillTrainer(cfg, teacher_from_trainer(Trainer(cfg, device="cuda")), device="cuda")
    _steps(cs, fp, tag, "distill_bicubic", lambda: st.train_step(x, y), b)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other checkout")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.turn)
        return
    if not args.parent:
        ap.error("--parent is required")
    for tag in args.order.split(","):
        root = str(REPO if tag == "change" else Path(args.parent).resolve())
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", tag], cwd=root,
                       env={**os.environ, "PYTHONPATH": root}, check=True, timeout=900)


if __name__ == "__main__":
    main()

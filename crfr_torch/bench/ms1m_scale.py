"""The one-card train step at MS1M's class count (scripts/ms1m_scale.py).

    python -m crfr_torch.bench.ms1m_scale [--batch 256] [--classes 85742]
        [--control-classes 1000] [--steps 30] [--backbone ir_50] [--device cuda|cpu]

The step of BASELINE config 5's class count, C=85,742, on one card:
IR-50 at 112², batch 256, the streaming CE (``ce_impl`` auto picks it
above 32,768 classes), measured with the batch already on the device
(``bench.throughput.run_train_throughput``: the step alone, no host
feed). A control run at ``--control-classes`` gives the head's marginal
cost. Then a fresh trainer (``ce_impl="streaming"``, lr 0.1, warmup 5,
seed 0) takes the first step's loss and ``--steps`` more steps on the one
repeated batch: memorisation, so the loss should fall toward 0.

Prints one JSON line with ``crfr``'s keys, but for the two that mean
nothing here (XLA's compiled-memory ``hbm_*`` and ``jit_cache_entries``):
in their place ``peak_allocated_gb``, the peak of
``torch.cuda.max_memory_allocated`` over the C=85,742 steps (null on the
CPU), and the device's name.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _measure(batch: int, classes: int, backbone: str, steps: int, device) -> dict:
    from crfr_torch.bench.throughput import run_train_throughput

    r = run_train_throughput(batch=batch, steps=steps, backbone=backbone, num_classes=classes,
                             device=device)
    return {"classes": classes,
            "steady_step_ms": round(r.ms_per_step, 2),
            "imgs_per_sec": round(r.imgs_per_sec, 1),
            "compile_s": round(r.first_step_seconds, 1),
            "peak_bytes": r.peak_bytes}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m crfr_torch.bench.ms1m_scale")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--classes", type=int, default=85742)
    ap.add_argument("--control-classes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--backbone", default="ir_50")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from crfr_torch.configs import Config, DataCfg, LossCfg, ModelCfg, TrainCfg
    from crfr_torch.device import resolve_device
    from crfr_torch.train.loop import Trainer

    dev = resolve_device(args.device)
    big = _measure(args.batch, args.classes, args.backbone, args.steps, dev)
    ctrl = _measure(args.batch, args.control_classes, args.backbone, args.steps, dev)
    peak = big.pop("peak_bytes")
    ctrl.pop("peak_bytes")

    # the loss on one repeated batch, from a fresh trainer at the big C
    cfg = Config(
        name="ms1m-scale",
        data=DataCfg(image_size=112, num_classes=args.classes),
        model=ModelCfg(backbone=args.backbone, input_size=112),
        loss=LossCfg(ce_impl="streaming"),
        train=TrainCfg(batch_size=args.batch, lr=0.1, warmup_steps=5, log_every=10 ** 9,
                       seed=0),
    )
    tr = Trainer(cfg, steps_per_epoch=1000, device=dev)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (args.batch, 112, 112, 3))
                            .astype(np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, args.classes, args.batch)).to(dev)
    loss0 = float(tr.train_step(imgs, labels)["loss"])
    for _ in range(args.steps):
        m = tr.train_step(imgs, labels)
    loss = float(m["loss"])

    out = {
        "backbone": args.backbone, "batch": args.batch,
        "ce_impl": "streaming(auto)",
        "ms1m": big, "control": ctrl,
        "head_marginal_ms": round(big["steady_step_ms"] - ctrl["steady_step_ms"], 2),
        "loss_first": round(loss0, 3),
        # one repeated batch: memorisation, expected to fall toward 0
        "loss_after_steps": round(loss, 4),
        "ln_C": round(float(np.log(args.classes)), 3),
        "peak_allocated_gb": round(peak / 2 ** 30, 2) if dev.type == "cuda" else None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

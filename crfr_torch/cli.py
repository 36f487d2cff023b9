"""Command line of crfr_torch (crfr/cli.py). Subcommands so far:

    python -m crfr_torch train --preset casia_arcface [key=value ...]
        [--max-steps N] [--steps-per-epoch N] [--resume] [--workers N]
        [--train-records PATH.crfrpack] [--tensorboard DIR] [--device cuda|cpu]

``train`` writes JSONL metrics and checkpoints under ``train.checkpoint_dir``
(``data_state.json`` beside them when it reads records), resumes from the
latest checkpoint with ``--resume``, and prints ``{"final_step": N}``. It
trains on the CUDA device unless ``--device cpu`` is given. Without
``data.train_records`` it draws ``SyntheticFaces`` batches, batch k from
the generator seeded (seed, k), so a resumed run continues the same
stream.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _split_overrides(extra: list[str]) -> tuple[list[str], list[str]]:
    kv = [a for a in extra if "=" in a and not a.startswith("-")]
    return kv, [a for a in extra if a not in kv]


def _synthetic_batches(cfg, start: int, stop: int):
    import numpy as np

    from crfr_torch.data.synthetic import SyntheticFaces

    synth = SyntheticFaces(num_classes=cfg.data.num_classes, image_size=cfg.data.image_size)
    for step in range(start, stop):
        yield synth.sample(np.random.default_rng([cfg.train.seed, step]), cfg.train.batch_size)


def cmd_train(args, overrides: list[str]) -> int:
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.feed import ResumableDeviceFeed, device_feed
    from crfr_torch.train.loop import Trainer
    from crfr_torch.utils.logging import MetricsWriter

    if args.eval_bin:
        raise NotImplementedError("--eval-bin needs data/bins.py, which is not ported yet "
                                  "(ROADMAP.md item 13)")
    if args.recycle_every_steps:
        raise NotImplementedError("--recycle-every-steps is not ported yet (ROADMAP.md item 13)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("training in more than one process is not ported yet "
                                  "(ROADMAP.md item 13)")
    cfg = get_config(args.preset, overrides)
    if args.train_records:
        cfg = cfg.override(**{"data.train_records": args.train_records})
    metrics = MetricsWriter(os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl"),
                            tensorboard_dir=args.tensorboard or None)
    tr = Trainer(cfg, steps_per_epoch=args.steps_per_epoch, metrics=metrics, device=args.device)
    ck = Checkpointer(cfg.train.checkpoint_dir, keep=cfg.train.keep_checkpoints)
    if args.resume and ck.latest_step() is not None:
        tr.state = ck.restore(tr.state)
        print(f"resumed from step {tr.host_step}", file=sys.stderr)
    start = tr.host_step

    data_state_path = os.path.join(cfg.train.checkpoint_dir, "data_state.json")
    if cfg.data.train_records:
        from crfr_torch.data.pipeline import PipelineCfg, train_batches
        from crfr_torch.data.records import open_source

        data_state = None
        if args.resume and start and os.path.exists(data_state_path):
            with open(data_state_path) as f:
                saved = json.load(f)
            if saved.get("step") == start:          # exact-match resume only
                data_state = saved["state"]
        batches = train_batches(open_source(cfg.data.train_records), PipelineCfg(
            batch_size=cfg.train.batch_size, seed=cfg.train.seed,
            random_flip=cfg.data.random_flip, num_workers=args.workers),
            start_step=start, state=data_state)
        feed = ResumableDeviceFeed(batches, tr.device)
    else:
        feed = device_feed(_synthetic_batches(cfg, start, args.max_steps or start + 1000),
                           tr.device)

    def save(step: int, force: bool = False) -> None:
        ck.save(step, tr.state, cfg.to_json(), force=force)
        if cfg.data.train_records:
            with open(data_state_path, "w") as f:
                json.dump({"step": step, "state": feed.state}, f)

    t0, n_img = time.time(), 0
    for imgs, labels in feed:
        if args.max_steps and tr.host_step >= args.max_steps:
            break
        m = tr.train_step(imgs, labels)
        n_img += len(labels)
        step = tr.host_step
        if step % cfg.train.log_every == 0:
            metrics.write(step, imgs_per_sec=n_img / (time.time() - t0),
                          lr=tr.schedule(step), **{k: float(v) for k, v in m.items()})
        if step % cfg.train.checkpoint_every_steps == 0:
            save(step)
    step = tr.host_step
    if ck.latest_step() != step:
        save(step, force=True)
    if cfg.data.train_records:
        feed.close()
    ck.close()
    metrics.close()
    print(json.dumps({"final_step": step}), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="crfr_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="ArcFace training on one device")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop at this global step (0: 1000 synthetic steps, or the records "
                        "without end)")
    p.add_argument("--steps-per-epoch", type=int, default=1000)
    p.add_argument("--workers", type=int, default=0, help="record reader threads")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--train-records", default="",
                   help=".crfrpack of (label, image) records (data.train_records)")
    p.add_argument("--eval-bin", default="", help="not ported yet")
    p.add_argument("--tensorboard", default="",
                   help="also mirror metrics to TensorBoard event files")
    p.add_argument("--recycle-every-steps", type=int, default=0, help="not ported yet")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_train)

    args, extra = ap.parse_known_args(argv)
    overrides, unknown = _split_overrides(extra)
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args.fn(args, overrides)


if __name__ == "__main__":
    raise SystemExit(main())

"""Command line of crfr_torch (crfr/cli.py). Subcommands so far:

    python -m crfr_torch train --preset casia_arcface [key=value ...]
        [--max-steps N] [--steps-per-epoch N] [--resume] [--workers N]
        [--train-records PATH.crfrpack] [--tensorboard DIR] [--device cuda|cpu]

    python -m crfr_torch train-sr --preset casia_arcface [key=value ...]
        [--scale 8] [--max-steps N] [--resume] [--teacher-ckpt DIR]
        [--perceptual W] [--bicubic-skip 1|0] [--lr-g LR] [--lr-d LR]
        [--schedule constant|cosine] [--warmup-steps N] [--n-d-steps N]
        [--r1-gamma G] [--train-records PATH.crfrpack] [--tensorboard DIR]
        [--device cuda|cpu]

``train`` writes JSONL metrics and checkpoints under ``train.checkpoint_dir``
(``data_state.json`` beside them when it reads records), resumes from the
latest checkpoint with ``--resume``, and prints ``{"final_step": N}``. It
trains on the CUDA device unless ``--device cpu`` is given. Without
``data.train_records`` it draws ``SyntheticFaces`` batches, batch k from
the generator seeded (seed, k), so a resumed run continues the same
stream.

``train-sr`` trains the hallucinator (``train.sr_loop.SRTrainer``) on the
same feed, labels ignored (records resume by skipping the batches already
taken), with checkpoints under ``<checkpoint_dir>/sr`` and metrics in
``<checkpoint_dir>/sr_metrics.jsonl``, and prints ``{"g_loss", "d_loss",
"steps"}``. ``--teacher-ckpt`` restores a ``train`` checkpoint as the
frozen teacher of the identity term; ``--perceptual`` needs it.
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


def cmd_train_sr(args, overrides: list[str]) -> int:
    from crfr_torch.configs import Config, get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.distill_loop import teacher_from_trainer
    from crfr_torch.train.feed import device_feed
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import SRTrainer, perceptual_from_trainer
    from crfr_torch.utils.logging import MetricsWriter

    if args.perceptual > 0 and not args.teacher_ckpt:
        raise ValueError("--perceptual requires --teacher-ckpt")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("training in more than one process is not ported yet "
                                  "(ROADMAP.md item 13)")
    cfg = get_config(args.preset, overrides)
    if args.train_records:
        cfg = cfg.override(**{"data.train_records": args.train_records})
    teacher_fn = perceptual_fn = None
    if args.teacher_ckpt:
        tck = Checkpointer(args.teacher_ckpt, keep=1)
        tcfg = tck.restore_config()
        teacher = Trainer(Config.from_dict(tcfg) if tcfg else cfg, device=args.device)
        teacher.state = tck.restore(teacher.state)
        teacher_fn = teacher_from_trainer(teacher)
        if args.perceptual > 0:
            cfg = cfg.override(**{"loss.sr_perceptual_weight": args.perceptual})
            perceptual_fn = perceptual_from_trainer(teacher)
        del teacher
    metrics = MetricsWriter(os.path.join(cfg.train.checkpoint_dir, "sr_metrics.jsonl"),
                            tensorboard_dir=args.tensorboard or None)
    tr = SRTrainer(cfg, scale=args.scale, metrics=metrics, teacher_fn=teacher_fn,
                   perceptual_fn=perceptual_fn, bicubic_skip=bool(args.bicubic_skip),
                   lr_g=args.lr_g, lr_d=args.lr_d, schedule=args.schedule,
                   warmup_steps=args.warmup_steps, total_steps=args.max_steps or 100_000,
                   n_d_steps=args.n_d_steps, r1_gamma=args.r1_gamma, device=args.device)
    ck = Checkpointer(os.path.join(cfg.train.checkpoint_dir, "sr"),
                      keep=cfg.train.keep_checkpoints)
    if args.resume and ck.latest_step() is not None:
        tr.restore_from(ck)
        print(f"resumed SR from step {tr.step}", file=sys.stderr)
    start = tr.step
    stop = args.max_steps or start + 1000
    if cfg.data.train_records:
        from crfr_torch.data.pipeline import PipelineCfg, train_batches
        from crfr_torch.data.records import open_source

        batches = train_batches(open_source(cfg.data.train_records), PipelineCfg(
            batch_size=cfg.train.batch_size, seed=cfg.train.seed,
            random_flip=cfg.data.random_flip), start_step=start)
    else:
        batches = _synthetic_batches(cfg, start, stop)
    m = {}
    try:
        for imgs, _ in device_feed(batches, tr.device):
            if tr.step >= stop:
                break
            m = tr.train_step(imgs)
            if tr.step % cfg.train.checkpoint_every_steps == 0:
                ck.save(tr.step, tr.state_dict(), cfg.to_json())
    finally:
        if cfg.data.train_records:
            batches.close()
    if tr.step and ck.latest_step() != tr.step:
        ck.save(tr.step, tr.state_dict(), cfg.to_json(), force=True)
    metrics.close()
    print(json.dumps({"g_loss": float(m.get("g_loss", float("nan"))),
                      "d_loss": float(m.get("d_loss", float("nan"))),
                      "steps": tr.step}), flush=True)
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

    p = sub.add_parser("train-sr", help="hallucinator (SR GAN) training on one device")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--scale", type=int, default=8)
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop at this global step (0: 1000 steps from the start)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--teacher-ckpt", default="",
                   help="recognition checkpoint (of train) for the SR identity loss")
    p.add_argument("--perceptual", type=float, default=0.0,
                   help="weight of the recognition-feature perceptual loss "
                        "(teacher stage features; needs --teacher-ckpt)")
    p.add_argument("--bicubic-skip", type=int, default=1,
                   help="train G with the fixed bicubic-up skip connection "
                        "(G == bicubic at init)")
    p.add_argument("--lr-g", type=float, default=1e-4)
    p.add_argument("--lr-d", type=float, default=1e-4)
    p.add_argument("--schedule", default="constant", choices=("constant", "cosine"),
                   help="Adam LR schedule over --max-steps (G and D)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--n-d-steps", type=int, default=1,
                   help="discriminator updates per generator update")
    p.add_argument("--r1-gamma", type=float, default=0.0,
                   help="R1 gradient-penalty weight on the D step (0 = off)")
    p.add_argument("--train-records", default="",
                   help=".crfrpack of (label, image) records (data.train_records)")
    p.add_argument("--tensorboard", default="",
                   help="also mirror metrics to TensorBoard event files")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_train_sr)

    args, extra = ap.parse_known_args(argv)
    overrides, unknown = _split_overrides(extra)
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args.fn(args, overrides)


if __name__ == "__main__":
    raise SystemExit(main())

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

    python -m crfr_torch train-distill --teacher-ckpt DIR --preset casia_arcface
        [key=value ...] [--kd-weight W] [--max-steps N] [--resume]
        [--sr-ckpt DIR [--sr-scale 8] [--sr-bicubic-skip 1|0]
         [--sr-finetune [--sr-lr LR] [--sr-pixel-weight W]]]
        [--tensorboard DIR] [--device cuda|cpu]

    python -m crfr_torch headline [--out DIR] [--probe-sizes 16,8] [--seeds N]
        [--device cuda|cpu] [field=value ...]

    python -m crfr_torch extract --ckpt DIR --list FILE --out PATH [--root DIR]
        [--degrade N] [--int8] [--quantize-bank] [--preset P] [key=value ...]
        [--device cuda|cpu]

    python -m crfr_torch match --gallery-npy BANK.npy|BANK.npz
        (--probe-npy P.npy | --ckpt DIR --list FILE [--root DIR] [--int8]
         [--degrade N] [--sr-ckpt DIR [--sr-scale 8] [--sr-bicubic-skip 1|0]])
        [--gallery-labels-npy L.npy] [--k 5] [--approx] [--approx-recall R]
        [--preset P] [key=value ...] [--device cuda|cpu]

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

``train-distill`` trains a student with residual KD
(``train.distill_loop.DistillTrainer``) against the frozen teacher of
``--teacher-ckpt`` (restored with its own config), on the same feed
(``data.train_records`` or synthetic batches), with
checkpoints under ``<checkpoint_dir>/student`` and metrics in
``<checkpoint_dir>/distill_metrics.jsonl``, and prints the last step's
losses and ``"steps"``. ``--sr-ckpt`` feeds the student hallucinated faces
from a frozen G; with ``--sr-finetune`` G trains jointly and checkpoints
with the student.

``headline`` runs the paper's composed experiment
(``experiments.headline``) and prints its results and the ordering per
probe size; ``HeadlineCfg`` fields are key=value overrides. Its int8 row
(``int8_eval``, on by default) re-runs verification and rank-1 with each
system's backbone quantized (``models.quant``).

``extract`` embeds the images of a list file (``path`` or ``path label``
per line) with a ``train`` checkpoint, restored with its own config
(key=value overrides win over it), with flip-TTA, and writes a float
``.npy`` (labels beside it as ``<out>_labels.npy`` when the list has them)
or, with ``--quantize-bank``, an int8 ``.npz`` bank (``eval.bank``).
``--int8`` embeds through the int8 backbone, calibrated on up to two
batches of the run's own images through the same degrade front end.
``match`` scores probes (embeddings of ``--probe-npy``, or the images of
``--list`` embedded as ``extract`` does, ``--int8`` and ``--sr-ckpt``
included) against a float ``.npy`` gallery or an int8 ``.npz`` bank and
prints the top-k labels and scores per probe; ``--approx`` and
``--approx-recall`` are accepted and the selection stays exact. Both print
``crfr``'s JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
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


def _restore_teacher(ckpt_dir: str, cfg, device):
    """A recognition ``Trainer`` restored from a ``train`` checkpoint, with
    the checkpoint's own config (``cfg`` where it has none)."""
    from crfr_torch.configs import Config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    tck = Checkpointer(ckpt_dir, keep=1)
    tcfg = tck.restore_config()
    teacher = Trainer(Config.from_dict(tcfg) if tcfg else cfg, device=device)
    teacher.state = tck.restore(teacher.state)
    return teacher


def _run_steps(tr, cfg, ck, max_steps: int, step_fn) -> dict:
    """Feed ``step_fn(images, labels)`` from ``tr.step`` to ``max_steps``
    (1000 steps from the start when 0): records from the start step on, or
    synthetic batch k from (seed, k); a checkpoint every
    ``checkpoint_every_steps`` and at the end. Returns the last metrics."""
    from crfr_torch.train.feed import device_feed

    start = tr.step
    stop = max_steps or start + 1000
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
        for imgs, labels in device_feed(batches, tr.device):
            if tr.step >= stop:
                break
            m = step_fn(imgs, labels)
            if tr.step % cfg.train.checkpoint_every_steps == 0:
                ck.save(tr.step, tr.state_dict(), cfg.to_json())
    finally:
        if cfg.data.train_records:
            batches.close()
    if tr.step and ck.latest_step() != tr.step:
        ck.save(tr.step, tr.state_dict(), cfg.to_json(), force=True)
    return m


def cmd_train_sr(args, overrides: list[str]) -> int:
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.distill_loop import teacher_from_trainer
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
        teacher = _restore_teacher(args.teacher_ckpt, cfg, args.device)
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
    m = _run_steps(tr, cfg, ck, args.max_steps, lambda imgs, _: tr.train_step(imgs))
    metrics.close()
    print(json.dumps({"g_loss": float(m.get("g_loss", float("nan"))),
                      "d_loss": float(m.get("d_loss", float("nan"))),
                      "steps": tr.step}), flush=True)
    return 0


def cmd_train_distill(args, overrides: list[str]) -> int:
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.sr_loop import SRTrainer, load_sr_apply
    from crfr_torch.utils.logging import MetricsWriter

    if args.eval_bin:
        raise NotImplementedError("--eval-bin needs data/bins.py, which is not ported yet "
                                  "(ROADMAP.md item 13)")
    if args.sr_finetune and not args.sr_ckpt:
        raise ValueError("--sr-finetune requires --sr-ckpt")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("training in more than one process is not ported yet "
                                  "(ROADMAP.md item 13)")
    cfg = get_config(args.preset, overrides)
    if cfg.loss.distill_weight <= 0:
        cfg = cfg.override(**{"loss.distill_weight": args.kd_weight})
    teacher = _restore_teacher(args.teacher_ckpt, cfg, args.device)
    sr_fn = sr_module = None
    if args.sr_finetune:            # G trains with the student and checkpoints with it
        sr_tr = SRTrainer(cfg, scale=args.sr_scale, bicubic_skip=bool(args.sr_bicubic_skip),
                          device=args.device)
        sr_tr.restore_from(Checkpointer(args.sr_ckpt, keep=1))
        sr_module = sr_tr._serve_module(ema=True)
        del sr_tr
    elif args.sr_ckpt:
        sr_fn = load_sr_apply(args.sr_ckpt, cfg, scale=args.sr_scale,
                              bicubic_skip=bool(args.sr_bicubic_skip), device=args.device)
    metrics = MetricsWriter(os.path.join(cfg.train.checkpoint_dir, "distill_metrics.jsonl"),
                            tensorboard_dir=args.tensorboard or None)
    st = DistillTrainer(cfg, teacher_from_trainer(teacher), metrics=metrics, sr_fn=sr_fn,
                        sr_scale=args.sr_scale, sr_module=sr_module, sr_lr=args.sr_lr,
                        sr_pixel_weight=args.sr_pixel_weight, device=args.device)
    del teacher, sr_module
    sck = Checkpointer(os.path.join(cfg.train.checkpoint_dir, "student"),
                       keep=cfg.train.keep_checkpoints)
    if args.resume and sck.latest_step() is not None:
        st.load_state_dict(sck.restore(st.state_dict()))
        print(f"resumed student from step {st.step}", file=sys.stderr)
    m = _run_steps(st, cfg, sck, args.max_steps, st.train_step)
    metrics.close()
    print(json.dumps({k: float(v) for k, v in m.items()} | {"steps": st.step}), flush=True)
    return 0


def cmd_headline(args, overrides: list[str]) -> int:
    import dataclasses

    from crfr_torch.experiments.headline import (HeadlineCfg, ordering_holds, run_headline,
                                                  run_headline_seeds)

    defaults = HeadlineCfg()
    kv = {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        if not hasattr(defaults, k):
            valid = [f.name for f in dataclasses.fields(HeadlineCfg)]
            raise KeyError(f"unknown headline field {k!r}; valid: {valid}")
        d = getattr(defaults, k)
        if isinstance(d, bool):              # bool("0") is True: parse it
            kv[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(d, tuple):
            kv[k] = tuple(int(x) for x in v.split(","))
        else:
            kv[k] = type(d)(v)
    kv.setdefault("probe_sizes", tuple(int(s) for s in args.probe_sizes.split(",") if s))
    h = dataclasses.replace(defaults, out_dir=args.out, **kv)
    if args.seeds > 1:
        out = run_headline_seeds(h, args.seeds, device=args.device)
        print(json.dumps({"aggregate": out["aggregate"], "total_s": out["total_s"]}),
              flush=True)
        return 0
    table = run_headline(h, device=args.device)
    print(json.dumps({"results": table["results"], "stages": table["stages"],
                      "total_s": table["total_s"],
                      "ordering": {str(p): ordering_holds(table, p) for p in h.probe_sizes},
                      "ordering_rank1": {str(p): ordering_holds(table, p, "rank1")
                                         for p in h.probe_sizes}}), flush=True)
    return 0


def _embed_fn_from_ckpt(args, overrides: list[str]):
    """A ``Trainer`` restored from ``--ckpt``, built from the checkpoint's
    config with the CLI's key=value overrides winning over it (the preset's
    config when the checkpoint has none)."""
    from crfr_torch.configs import Config, get_config, parse_overrides
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    ck = Checkpointer(args.ckpt, keep=1)
    cfg_dict = ck.restore_config()
    if cfg_dict is not None:
        cfg = Config.from_dict(cfg_dict)
        kv = parse_overrides(overrides)
        if kv:
            cfg = cfg.override(**kv)
    else:
        cfg = get_config(args.preset, overrides)
    tr = Trainer(cfg, device=args.device)
    tr.state = ck.restore(tr.state)
    return tr, cfg


def _backbone_apply(tr, cfg, args, sample_paths=(), degrade_to: int | None = None):
    """The float backbone (default) or, with ``--int8``, its int8 twin
    (``models.quant``), as normalized pixels → embeddings. The int8 one is
    calibrated on up to two batches of the run's own images through the
    front end the caller embeds with (the plain bicubic down-up operator to
    ``degrade_to``, then normalization), or on one batch of seeded noise
    when there are no images; it computes in the trainer's compute dtype.

    As in ``crfr``, the calibration batches are ``embed_batches``' own, so
    a last batch that is not full brings its zero padding with it
    (ROADMAP.md §3 records what that does to the scales)."""
    if not args.int8:
        return lambda x: tr.backbone_apply(tr.model.backbone, x)
    import numpy as np

    from crfr_torch.models.quant import calibration_batch, quantize_backbone

    size = cfg.model.input_size

    def prep(raw):
        return calibration_batch(raw, degrade_to, cfg.data.resize_mode, tr.device)

    calib = []
    if sample_paths:
        from crfr_torch.data.pipeline import embed_batches

        n = min(len(sample_paths), 2 * cfg.eval.batch_size)
        for imgs, _ in embed_batches(list(sample_paths)[:n], cfg.eval.batch_size, size):
            calib.append(prep(imgs))
            if len(calib) >= 2:
                break
    else:
        calib = [prep(np.random.default_rng(0).integers(0, 256, (32, size, size, 3)))]
    q = quantize_backbone(tr.model.backbone, calib, compute_dtype=tr.compute_dtype)
    return lambda x: q(x).float()


def _sr_apply_if_requested(args, cfg):
    """``--sr-ckpt DIR`` → the frozen hallucinator's plug, or None."""
    if not args.sr_ckpt:
        return None
    from crfr_torch.train.sr_loop import load_sr_apply

    return load_sr_apply(args.sr_ckpt, cfg, scale=args.sr_scale,
                         bicubic_skip=bool(args.sr_bicubic_skip), device=args.device)


def _load_gallery(path: str, labels_path: str = ""):
    """A float ``.npy`` gallery or an int8 ``.npz`` bank (``extract
    --quantize-bank``) → (gallery, labels): labels from ``labels_path``,
    else the bank's own, else the row index."""
    import numpy as np

    if path.endswith(".npz"):
        from crfr_torch.eval.bank import load_bank

        bank = load_bank(path)
        return bank, np.load(labels_path) if labels_path else bank.labels
    g = np.load(path)
    return g, np.load(labels_path) if labels_path else np.arange(len(g))


def _approx_flag(args):
    """--approx-recall R (0 < R < 1) → R; else --approx as a bool."""
    return float(args.approx_recall) if args.approx_recall else bool(args.approx)


def cmd_extract(args, overrides: list[str]) -> int:
    import numpy as np

    from crfr_torch.eval.extract import extract_embeddings, make_extract_fn

    tr, cfg = _embed_fn_from_ckpt(args, overrides)
    paths, labels = [], []
    with open(args.list) as f:
        for ln in f:
            parts = ln.split()
            if not parts:
                continue
            paths.append(os.path.join(args.root, parts[0]))
            labels.append(int(parts[1]) if len(parts) > 1 else -1)
    degrade = args.degrade or None
    fn = make_extract_fn(_backbone_apply(tr, cfg, args, paths, degrade), degrade_to=degrade,
                         resize_mode=cfg.data.resize_mode, flip_fusion=cfg.eval.flip_fusion,
                         image_size=cfg.model.input_size, device=tr.device)
    embs = extract_embeddings(paths, fn, cfg.eval.batch_size, cfg.model.input_size)
    dim = int(embs.shape[1]) if len(embs) else 0
    labelled = any(lab >= 0 for lab in labels)
    if args.quantize_bank:
        from crfr_torch.eval.bank import quantize_bank, save_bank

        out = args.out if args.out.endswith(".npz") else args.out + ".npz"
        save_bank(out, quantize_bank(embs, np.asarray(labels) if labelled else None))
        print(json.dumps({"out": out, "count": len(paths), "dim": dim,
                          "quantized_bank": True}), flush=True)
        return 0
    np.save(args.out, embs)
    if labelled:
        np.save(args.out.replace(".npy", "") + "_labels.npy", np.asarray(labels))
    print(json.dumps({"out": args.out, "count": len(paths), "dim": dim}), flush=True)
    return 0


def cmd_match(args, overrides: list[str]) -> int:
    import numpy as np

    from crfr_torch.eval.identification import topk_matches

    g, glab = _load_gallery(args.gallery_npy, args.gallery_labels_npy)
    if args.probe_npy:
        from crfr_torch.configs import get_config

        p = np.load(args.probe_npy)
        cfg = get_config(args.preset, overrides)
    else:
        if not (args.ckpt and args.list):
            raise ValueError("match needs --probe-npy, or --ckpt and a --list of probe images")
        from crfr_torch.eval.extract import extract_embeddings, make_extract_fn

        tr, cfg = _embed_fn_from_ckpt(args, overrides)
        with open(args.list) as f:
            paths = [os.path.join(args.root, ln.split()[0]) for ln in f if ln.split()]
        sr_apply = _sr_apply_if_requested(args, cfg)
        degrade = args.degrade or cfg.data.eval_degrade_size
        if sr_apply is not None and not degrade:
            degrade = cfg.model.input_size // args.sr_scale
        fn = make_extract_fn(_backbone_apply(tr, cfg, args, paths, degrade or None),
                             degrade_to=degrade or None, sr_apply=sr_apply,
                             resize_mode=cfg.data.resize_mode, flip_fusion=cfg.eval.flip_fusion,
                             image_size=cfg.model.input_size, device=tr.device)
        p = extract_embeddings(paths, fn, cfg.eval.batch_size, cfg.model.input_size)
    scores, labels = topk_matches(p, g, glab, k=args.k, block=cfg.eval.gallery_block,
                                  approx=_approx_flag(args), device=args.device)
    out = [{"labels": labels[i].tolist(), "scores": [round(float(v), 4) for v in scores[i]]}
           for i in range(len(labels))]
    print(json.dumps({"matches": out, "k": args.k, "gallery": len(g)}), flush=True)
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

    p = sub.add_parser("train-distill", help="a student with residual KD on one device")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--teacher-ckpt", required=True,
                   help="recognition checkpoint (of train), restored with its own config")
    p.add_argument("--kd-weight", type=float, default=1.0,
                   help="loss.distill_weight when the preset's is 0")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop at this global step (0: 1000 steps from the start)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--sr-ckpt", default="",
                   help="hallucinator checkpoint (of train-sr): the student consumes G(lr)")
    p.add_argument("--sr-scale", type=int, default=8)
    p.add_argument("--sr-bicubic-skip", type=int, default=1,
                   help="the G of --sr-ckpt was trained with the bicubic skip (1) or not (0)")
    p.add_argument("--sr-finetune", action="store_true",
                   help="fine-tune G jointly with the student (needs --sr-ckpt); G's state "
                        "checkpoints with the student")
    p.add_argument("--sr-lr", type=float, default=1e-5)
    p.add_argument("--sr-pixel-weight", type=float, default=0.3,
                   help="weight of the pixel anchor of joint G fine-tuning")
    p.add_argument("--eval-bin", default="", help="not ported yet")
    p.add_argument("--tensorboard", default="",
                   help="also mirror metrics to TensorBoard event files")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_train_distill)

    p = sub.add_parser("headline", help="the paper's composed experiment")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "crfr_headline"),
                   help="stage checkpoints and headline.json land here")
    p.add_argument("--seeds", type=int, default=1,
                   help=">1: that many replicates (seed, seed+1000, ...) aggregated into "
                        "headline_seeds.json")
    p.add_argument("--probe-sizes", default="16,8",
                   help="comma-separated LR probe sizes (each divides the image size)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_headline)

    p = sub.add_parser("extract", help="embed a list of images into .npy or an int8 .npz bank")
    p.add_argument("--ckpt", required=True, help="checkpoint directory (of train)")
    p.add_argument("--list", required=True, help="one 'path [label]' per line")
    p.add_argument("--out", required=True)
    p.add_argument("--root", default="")
    p.add_argument("--degrade", type=int, default=0,
                   help="bicubic down to this size and back up before embedding (0: none)")
    p.add_argument("--int8", action="store_true",
                   help="embed through the int8 backbone (models/quant.py), calibrated on "
                        "this run's images")
    p.add_argument("--quantize-bank", action="store_true",
                   help="write an int8 .npz embedding bank (eval/bank.py) in place of a "
                        "float .npy")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("match", help="top-k identities of probes against a gallery")
    p.add_argument("--gallery-npy", required=True,
                   help="gallery: float .npy or int8 .npz (of extract [--quantize-bank])")
    p.add_argument("--gallery-labels-npy", default="",
                   help="gallery labels .npy (default: the bank's, else the row index)")
    p.add_argument("--probe-npy", default="", help="probe embeddings .npy (no --ckpt)")
    p.add_argument("--ckpt", default="", help="embed the probe images of --list instead")
    p.add_argument("--list", default="", help="probe image list file")
    p.add_argument("--root", default="")
    p.add_argument("--degrade", type=int, default=0,
                   help="probe degradation size (0: the config's eval_degrade_size)")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--int8", action="store_true",
                   help="embed the probes through the int8 backbone")
    p.add_argument("--approx", action="store_true",
                   help="accepted; the selection stays exact (eval/identification.py)")
    p.add_argument("--approx-recall", type=float, default=0.0,
                   help="accepted, implies --approx; the selection stays exact")
    p.add_argument("--sr-ckpt", default="",
                   help="route probe images through this hallucinator (of train-sr)")
    p.add_argument("--sr-scale", type=int, default=8)
    p.add_argument("--sr-bicubic-skip", type=int, default=1,
                   help="the G of --sr-ckpt was trained with the bicubic skip (1) or not (0)")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_match)

    args, extra = ap.parse_known_args(argv)
    overrides, unknown = _split_overrides(extra)
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args.fn(args, overrides)


if __name__ == "__main__":
    raise SystemExit(main())

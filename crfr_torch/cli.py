"""Command line of crfr_torch (crfr/cli.py). Subcommands:

    python -m crfr_torch train --preset casia_arcface [key=value ...]
        [--max-steps N] [--steps-per-epoch N] [--resume] [--workers N]
        [--train-records PATH.crfrpack] [--eval-bin SET.bin]
        [--recycle-every-steps N] [--tensorboard DIR] [--device cuda|cpu]

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
        [--eval-bin SET.bin] [--tensorboard DIR] [--device cuda|cpu]

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

    python -m crfr_torch eval-verification --ckpt DIR --pairs pairs.txt --lfw-root R
        [--degrade N] [--degrade-side first|second|both] [--sr-ckpt DIR ...]
    python -m crfr_torch eval-scface --ckpt DIR --gallery G --probes P [--distance 1|2|3]
    python -m crfr_torch eval-openset (--ckpt DIR --gallery-list L --mated-list L
        --unmated-list L [--root R] [--degrade N] | --probe-npy P --probe-labels-npy L
        --gallery-npy G [--gallery-labels-npy L] --mated-npy M) [--max-rank 20]
    python -m crfr_torch eval-bin --ckpt DIR --bin lfw.bin [--degrade N]
    python -m crfr_torch eval-ijbc (--ckpt DIR [--meta M --pairs P] [--probe-meta M
        --gallery-g1 G1 --gallery-g2 G2] [--root R] | --probe-tpl-npy ...)
    python -m crfr_torch import-torch --torch-ckpt backbone.pth --out DIR
    python -m crfr_torch export --ckpt DIR --out model.crfrt [--batch 256] [--degrade N]
        [--flip-tta] [--int8] [--sr-ckpt DIR ...]
    python -m crfr_torch pack (--root TREE | --from-rec train.rec [--idx I])
        --out records.crfrpack [--size 112]
    python -m crfr_torch serve-http --artifact model.crfrt [--gallery-npz BANK.npz]
        [--mutable-gallery [--gallery-slab N]] [--host H] [--port 8321] [--window-ms 2]
    python -m crfr_torch bench [--batch 256] [--steps 30] [--int8] [--device cuda|cpu]

Each command but ``pack``, ``serve-http`` and ``bench`` takes ``--device
cuda|cpu``, ``--preset P`` and key=value overrides; ``bench`` takes
``--device``.

More than one device: one process per device, launched by ``torchrun
--nproc-per-node N -m crfr_torch ...`` or with the ``CRFR_COORDINATOR``,
``CRFR_NUM_PROCESSES`` and ``CRFR_PROCESS_ID`` environment
(``parallel.multihost``; NCCL between cards, gloo on the CPU). ``train``,
``train-distill`` and ``train-sr`` then train on the (``mesh.data``,
``mesh.model``) mesh, whose size must be the number of processes: each
process draws its own slab of ``batch_size / N`` rows (records: its
contiguous shard of them, ``data_state_{rank}.json`` its resume state;
synthetic: the generator of (seed + rank, k)), rank 0 alone writes the
metrics and the checkpoints, and an in-loop eval runs whole on every rank
on its own copy of the weights. ``--recycle-every-steps`` runs in one
process only. The eval and ``match`` commands split their batches and
shard their galleries over the processes.

``train`` writes JSONL metrics and checkpoints under ``train.checkpoint_dir``
(``data_state.json`` beside them when it reads records), resumes from the
latest checkpoint with ``--resume``, and prints ``{"final_step": N}``. It
trains on the CUDA device unless ``--device cpu`` is given. Without
``data.train_records`` it draws ``SyntheticFaces`` batches, batch k from
the generator seeded (seed, k), so a resumed run continues the same
stream. ``--eval-bin`` verifies an insightface ``.bin`` set every
``train.eval_every_steps`` with the live weights (degraded to
``data.eval_degrade_size`` when set, flip-TTA) and writes
``eval_accuracy``/``eval_eer`` to the metrics, after the checkpoint of that
step. ``--recycle-every-steps N`` checkpoints and replaces the process with
``python -m crfr_torch <the same argv> --resume`` every N steps, appending a
record to ``<checkpoint_dir>/recycles.jsonl``; the generations continue one
run and one metrics stream.

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
with the student. ``--eval-bin`` verifies a ``.bin`` set with the
student's embedding plus its residual every ``train.eval_every_steps``.

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

The ``eval-*`` commands run ``crfr``'s protocols and print its JSON lines:
``eval-verification`` (LFW pairs; only the probe side of each pair is
degraded, or hallucinated with ``--sr-ckpt``), ``eval-scface`` (rank-1 and
CMC), ``eval-openset`` (rank-1, CMC, TPIR@FPIR; from images or from
embeddings), ``eval-bin`` (an insightface ``.bin``) and ``eval-ijbc``
(1:1 TAR@FAR, 1:N over two galleries, or 1:N from pooled templates).
``import-torch`` writes a face.evoLVe state dict into a ``train``
checkpoint. ``export`` writes a serving artifact (``serve.export_embed``)
on ``--device``, which ``serve-http --artifact`` serves on that device,
printing ``{"serving": URL, ...}`` first. ``pack`` writes ``.crfrpack``
records from an identity folder tree or an MXNet ``.rec``; it writes no
ArrayRecord. ``bench`` times the embed pipeline of
``bench.throughput.run_throughput`` (IR-50 bf16, or its int8 twin with
``--int8``, seeded weights, random uint8 112² images degraded to 16 px)
and prints ``crfr``'s line ``{"imgs_per_sec", "per_batch_ms", "int8"}``.
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


def _synthetic_batches(cfg, start: int, stop: int, world=None):
    """Synthetic batch k from the generator seeded (seed, k); with ``world``
    = (rank, ranks) of a multi-process run, this rank's slab of
    batch_size / ranks rows from (seed + rank, k), ``crfr``'s convention of
    distinct per-process draws."""
    import numpy as np

    from crfr_torch.data.synthetic import SyntheticFaces

    rank, n = world or (0, 1)
    synth = SyntheticFaces(num_classes=cfg.data.num_classes, image_size=cfg.data.image_size)
    for step in range(start, stop):
        yield synth.sample(np.random.default_rng([cfg.train.seed + rank, step]),
                           _local_batch(cfg, n))


def _distributed(device) -> tuple[int, int]:
    """Start the process group when the environment describes a
    multi-process launch (``parallel.multihost``); → (rank, world)."""
    from crfr_torch.parallel.multihost import (maybe_initialize_distributed, process_count,
                                               process_index)

    maybe_initialize_distributed(device)
    return process_index(), process_count()


def _rank0_metrics(path: str, args, rank: int):
    """The JSONL (and TensorBoard) metrics writer on rank 0, a silent one on
    the others: every rank appending one file would interleave copies of
    each row."""
    from crfr_torch.utils.logging import MetricsWriter

    if rank != 0:
        return MetricsWriter(stdout=False)
    return MetricsWriter(path, tensorboard_dir=getattr(args, "tensorboard", "") or None)


def _local_batch(cfg, world: int) -> int:
    if cfg.train.batch_size % world:
        raise ValueError(f"batch_size {cfg.train.batch_size} must divide over {world} processes")
    return cfg.train.batch_size // world


def _record_source(cfg, rank: int, world: int):
    """The records of ``data.train_records``, this rank's contiguous shard of
    them (``process_shard``) in a multi-process run."""
    from crfr_torch.data.records import SubsetSource, open_source
    from crfr_torch.parallel.multihost import process_shard

    source = open_source(cfg.data.train_records)
    if world > 1:
        lo, hi = process_shard(len(source))
        source = SubsetSource(source, lo, hi)
        print(f"rank {rank}/{world}: records [{lo}, {hi}), local batch "
              f"{_local_batch(cfg, world)}", file=sys.stderr)
    return source


def _recycle_exec(args, cfg, step: int, device) -> None:
    """Replace this training process with a fresh one resuming at ``step``
    (crfr/cli.py's ``_recycle_exec``): a long run bounds the host memory a
    process can retain by restarting itself every N steps. Appends
    ``{"step", "gen", "max_rss_mb"}`` (and ``"max_cuda_mb"``, the card's
    peak of allocated memory, when training on CUDA) to
    ``<checkpoint_dir>/recycles.jsonl``, then ``os.execv``'s
    ``python -m crfr_torch <argv> --resume``; never returns."""
    import resource

    import torch

    gen = int(os.environ.get("CRFR_RECYCLE_GEN", "0")) + 1
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    rec = {"step": step, "gen": gen, "max_rss_mb": round(rss_mb, 1)}
    if device.type == "cuda":
        rec["max_cuda_mb"] = round(torch.cuda.max_memory_allocated(device) / 2**20, 1)
    with open(os.path.join(cfg.train.checkpoint_dir, "recycles.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    argv = list(args._argv)
    if "--resume" not in argv:
        argv.append("--resume")
    os.environ["CRFR_RECYCLE_GEN"] = str(gen)
    print(f"recycling process at step {step} (gen {gen}, max RSS {rss_mb:.0f} MB)",
          file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, [sys.executable, "-m", "crfr_torch", *argv])


def _bin_eval(args, cfg, metrics, embed_fn, device):
    """``eval(step)``: verification on ``--eval-bin`` through ``embed_fn``
    (raw uint8 batch → embeddings), written as ``eval_accuracy`` and
    ``eval_eer`` at ``step``; None without ``--eval-bin``."""
    if not args.eval_bin:
        return None
    from crfr_torch.data.bins import evaluate_bin

    def run(step: int) -> None:
        res = evaluate_bin(args.eval_bin, embed_fn, cfg.eval.batch_size, cfg.model.input_size,
                           cfg.eval.n_folds, device=device)
        metrics.write(step, eval_accuracy=res.accuracy_mean, eval_eer=res.eer)

    return run


def cmd_train(args, overrides: list[str]) -> int:
    from crfr_torch.configs import get_config
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.parallel.mesh import local_snapshot
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.feed import ResumableDeviceFeed, device_feed
    from crfr_torch.train.loop import Trainer

    cfg = get_config(args.preset, overrides)
    if args.train_records:
        cfg = cfg.override(**{"data.train_records": args.train_records})
    rank, world = _distributed(args.device)
    if args.recycle_every_steps and world > 1:
        raise ValueError("--recycle-every-steps restarts one process; it does not run "
                         f"in a run of {world} processes")
    metrics = _rank0_metrics(os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl"), args,
                             rank)
    tr = Trainer(cfg, steps_per_epoch=args.steps_per_epoch, metrics=metrics, device=args.device)
    ck = Checkpointer(cfg.train.checkpoint_dir, keep=cfg.train.keep_checkpoints)
    if args.resume and ck.latest_step() is not None:
        tr.state = ck.restore(tr.state)
        print(f"resumed from step {tr.host_step}", file=sys.stderr)
    start = tr.host_step
    local_bs = _local_batch(cfg, world)

    # each rank's pipeline walks its own record shard, so its resume state is
    # its own file (a shared name would be last-writer-wins)
    data_state_path = os.path.join(cfg.train.checkpoint_dir, "data_state.json" if world == 1
                                   else f"data_state_{rank}.json")
    if cfg.data.train_records:
        from crfr_torch.data.pipeline import PipelineCfg, train_batches

        data_state = None
        if args.resume and start and os.path.exists(data_state_path):
            with open(data_state_path) as f:
                saved = json.load(f)
            if saved.get("step") == start:          # exact-match resume only
                data_state = saved["state"]
        batches = train_batches(_record_source(cfg, rank, world), PipelineCfg(
            batch_size=local_bs, seed=cfg.train.seed,
            random_flip=cfg.data.random_flip, num_workers=args.workers),
            start_step=start, state=data_state)
        feed = ResumableDeviceFeed(batches, tr.device, mesh=tr.mesh, local=True)
    else:
        feed = device_feed(_synthetic_batches(cfg, start, args.max_steps or start + 1000,
                                              (rank, world)), tr.device, mesh=tr.mesh,
                           local=True)

    def save(step: int, force: bool = False) -> None:
        ck.save(step, tr.state, cfg.to_json(), force=force)
        if cfg.data.train_records:
            with open(data_state_path, "w") as f:
                json.dump({"step": step, "state": feed.state}, f)

    # the eval function is built once; state_fn hands it the live weights. In
    # a multi-process run every rank evaluates the whole set on its own copy
    # of the replicated backbone, taken once per trained step, with no
    # collective: a rank that skipped it would wait alone in the next step
    state_fn = tr.embed_state
    if world > 1:
        snap: dict = {}

        def state_fn():
            if snap.get("step") != tr.host_step:
                snap.update(step=tr.host_step, bb=local_snapshot(tr.embed_state()))
            return snap["bb"]
    in_loop_eval = _bin_eval(args, cfg, metrics, make_extract_fn(
        tr.backbone_apply, state_fn=state_fn, degrade_to=cfg.data.eval_degrade_size,
        resize_mode=cfg.data.resize_mode, flip_fusion=cfg.eval.flip_fusion,
        image_size=cfg.model.input_size, device=tr.device), tr.device)

    t0, n_img = time.time(), 0
    # the stop is tested after a step, not before the next draw: a batch drawn
    # and not trained would move the saved pipeline state past the last step
    for imgs, labels in ([] if args.max_steps and start >= args.max_steps else feed):
        m = tr.train_step(imgs, labels, local=True)
        n_img += len(labels) * world
        step = tr.host_step
        if step % cfg.train.log_every == 0:
            metrics.write(step, imgs_per_sec=n_img / (time.time() - t0),
                          lr=tr.schedule(step), **{k: float(v) for k, v in m.items()})
        if step % cfg.train.checkpoint_every_steps == 0:
            save(step)
        if in_loop_eval is not None and step % cfg.train.eval_every_steps == 0:
            in_loop_eval(step)
        if (args.recycle_every_steps and step - start >= args.recycle_every_steps
                and not (args.max_steps and step >= args.max_steps)):
            # checkpoint, close, and replace this process with one resuming
            # here: resume is bitwise and metrics.jsonl appends, so the
            # generations make one run and one stream
            save(step, force=True)
            feed.close()
            ck.close()
            metrics.close()
            _recycle_exec(args, cfg, step, tr.device)
        if args.max_steps and step >= args.max_steps:
            break
    step = tr.host_step
    if ck.latest_step() != step:
        save(step, force=True)
    feed.close()
    ck.close()
    metrics.close()
    print(json.dumps({"final_step": step}), flush=True)
    return 0


def _restore_teacher(ckpt_dir: str, cfg, device):
    """A recognition ``Trainer`` restored from a ``train`` checkpoint, with
    the checkpoint's own config (``cfg`` where it has none), laid out on
    ``cfg``'s mesh (only its backbone is read)."""
    from crfr_torch.configs import Config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    tck = Checkpointer(ckpt_dir, keep=1)
    tcfg = tck.restore_config()
    tcfg = Config.from_dict(tcfg) if tcfg else cfg
    teacher = Trainer(tcfg.override(**{"mesh.data": cfg.mesh.data, "mesh.model": cfg.mesh.model}),
                      device=device)
    teacher.state = tck.restore(teacher.state)
    return teacher


def _run_steps(tr, cfg, ck, max_steps: int, step_fn, evaluate=None, world=(0, 1)) -> dict:
    """Feed ``step_fn(images, labels)`` from ``tr.step`` to ``max_steps``
    (1000 steps from the start when 0): records from the start step on, or
    synthetic batch k from (seed, k); a checkpoint every
    ``checkpoint_every_steps`` and at the end, and ``evaluate(step)`` (when
    given) every ``eval_every_steps`` after the checkpoint. In a run of
    ``world`` = (rank, ranks) processes each rank feeds its own slab
    (``_synthetic_batches``, ``_record_source``). Returns the last
    metrics."""
    from crfr_torch.train.feed import device_feed

    rank, n = world
    start = tr.step
    stop = max_steps or start + 1000
    if cfg.data.train_records:
        from crfr_torch.data.pipeline import PipelineCfg, train_batches

        batches = train_batches(_record_source(cfg, rank, n), PipelineCfg(
            batch_size=_local_batch(cfg, n), seed=cfg.train.seed,
            random_flip=cfg.data.random_flip), start_step=start)
    else:
        batches = _synthetic_batches(cfg, start, stop, world)
    m = {}
    try:
        for imgs, labels in device_feed(batches, tr.device, mesh=getattr(tr, "mesh", None),
                                        local=True):
            if tr.step >= stop:
                break
            m = step_fn(imgs, labels)
            if tr.step % cfg.train.checkpoint_every_steps == 0:
                ck.save(tr.step, tr.state_dict(), cfg.to_json())
            if evaluate is not None and tr.step % cfg.train.eval_every_steps == 0:
                evaluate(tr.step)
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

    if args.perceptual > 0 and not args.teacher_ckpt:
        raise ValueError("--perceptual requires --teacher-ckpt")
    cfg = get_config(args.preset, overrides)
    rank, world = _distributed(args.device)
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
    metrics = _rank0_metrics(os.path.join(cfg.train.checkpoint_dir, "sr_metrics.jsonl"),
                             args, rank)
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
    m = _run_steps(tr, cfg, ck, args.max_steps, lambda imgs, _: tr.train_step(imgs, local=True),
                   world=(rank, world))
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

    if args.sr_finetune and not args.sr_ckpt:
        raise ValueError("--sr-finetune requires --sr-ckpt")
    cfg = get_config(args.preset, overrides)
    rank, world = _distributed(args.device)
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
    metrics = _rank0_metrics(os.path.join(cfg.train.checkpoint_dir, "distill_metrics.jsonl"),
                             args, rank)
    st = DistillTrainer(cfg, teacher_from_trainer(teacher), metrics=metrics, sr_fn=sr_fn,
                        sr_scale=args.sr_scale, sr_module=sr_module, sr_lr=args.sr_lr,
                        sr_pixel_weight=args.sr_pixel_weight, device=args.device)
    del teacher, sr_module
    sck = Checkpointer(os.path.join(cfg.train.checkpoint_dir, "student"),
                       keep=cfg.train.keep_checkpoints)
    if args.resume and sck.latest_step() is not None:
        st.load_state_dict(sck.restore(st.state_dict()))
        print(f"resumed student from step {st.step}", file=sys.stderr)
    # the student's embedding with its residual, on the live weights (in a
    # multi-process run each rank's own copy, taken once per trained step)
    evaluate = _bin_eval(args, cfg, metrics, st.student_embed_fn(
        with_residual=True, local_snapshot=world > 1), st.device)
    m = _run_steps(st, cfg, sck, args.max_steps,
                   lambda imgs, labels: st.train_step(imgs, labels, local=True), evaluate,
                   (rank, world))
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
    _, world = _distributed(args.device)
    if world > 1 and cfg.mesh.data * cfg.mesh.model != world:
        # a multi-process eval shards batches and galleries over every rank
        cfg = cfg.override(**{"mesh.data": world, "mesh.model": 1})
    tr = Trainer(cfg, device=args.device)
    tr.state = ck.restore(tr.state)
    return tr, cfg


def _topk_mesh(device="cuda"):
    """The mesh of a gallery top-k with no model loaded: every rank of a
    multi-process launch; None for one process."""
    from crfr_torch.parallel.mesh import make_mesh

    _, world = _distributed(device)
    return make_mesh(None, "cuda" if device == "cuda" else "cpu") if world > 1 else None


def _quantized_backbone(tr, cfg, sample_paths=(), degrade_to: int | None = None):
    """The trainer's backbone as its int8 twin (``models.quant``), calibrated
    on up to two batches of the run's own images through the front end the
    caller embeds with (the plain bicubic down-up operator to
    ``degrade_to``, then normalization), or on one batch of seeded noise
    when there are no images; it computes in the trainer's compute dtype.

    As in ``crfr``, the calibration batches are ``embed_batches``' own, so
    a last batch that is not full brings its zero padding with it
    (ROADMAP.md §3 records what that does to the scales)."""
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
    return quantize_backbone(tr.model.backbone, calib, compute_dtype=tr.compute_dtype)


def _backbone_apply(tr, cfg, args, sample_paths=(), degrade_to: int | None = None):
    """The float backbone (default) or, with ``--int8``, its int8 twin
    (``_quantized_backbone``), as normalized pixels → embeddings."""
    if not getattr(args, "int8", False):
        return lambda x: tr.backbone_apply(tr.model.backbone, x)
    q = _quantized_backbone(tr, cfg, sample_paths, degrade_to)
    return lambda x: q(x).float()


def _sr_apply_if_requested(args, cfg):
    """``--sr-ckpt DIR`` → the frozen hallucinator's plug, or None."""
    if not args.sr_ckpt:
        return None
    from crfr_torch.train.sr_loop import load_sr_apply

    return load_sr_apply(args.sr_ckpt, cfg, scale=args.sr_scale,
                         bicubic_skip=bool(args.sr_bicubic_skip), device=args.device)


def _lr_degrade(args, cfg, sr_apply) -> int | None:
    """The probe side's size: ``--degrade``, else the config's
    ``eval_degrade_size``, else G's input size with ``--sr-ckpt``; None for
    none."""
    degrade = args.degrade or cfg.data.eval_degrade_size
    if sr_apply is not None and not degrade:
        degrade = cfg.model.input_size // args.sr_scale
    return degrade or None


def _extract_kw(tr, cfg) -> dict:
    return dict(resize_mode=cfg.data.resize_mode, flip_fusion=cfg.eval.flip_fusion,
                image_size=cfg.model.input_size, device=tr.device, mesh=tr.mesh)


def _embed_paths(paths, fn, cfg):
    from crfr_torch.eval.extract import extract_embeddings

    return extract_embeddings(paths, fn, cfg.eval.batch_size, cfg.model.input_size)


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

    from crfr_torch.eval.extract import make_extract_fn

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
                         **_extract_kw(tr, cfg))
    embs = _embed_paths(paths, fn, cfg)
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
        mesh = _topk_mesh(args.device)
    else:
        if not (args.ckpt and args.list):
            raise ValueError("match needs --probe-npy, or --ckpt and a --list of probe images")
        from crfr_torch.eval.extract import make_extract_fn

        tr, cfg = _embed_fn_from_ckpt(args, overrides)
        with open(args.list) as f:
            paths = [os.path.join(args.root, ln.split()[0]) for ln in f if ln.split()]
        sr_apply = _sr_apply_if_requested(args, cfg)
        degrade = _lr_degrade(args, cfg, sr_apply)
        fn = make_extract_fn(_backbone_apply(tr, cfg, args, paths, degrade), degrade_to=degrade,
                             sr_apply=sr_apply, **_extract_kw(tr, cfg))
        p = _embed_paths(paths, fn, cfg)
        mesh = tr.mesh
    scores, labels = topk_matches(p, g, glab, k=args.k, block=cfg.eval.gallery_block,
                                  mesh=mesh, approx=_approx_flag(args), device=args.device)
    out = [{"labels": labels[i].tolist(), "scores": [round(float(v), 4) for v in scores[i]]}
           for i in range(len(labels))]
    print(json.dumps({"matches": out, "k": args.k, "gallery": len(g)}), flush=True)
    return 0


def _verification_json(res) -> dict:
    return {"accuracy": res.accuracy_mean, "std": res.accuracy_std, "eer": res.eer,
            "tar_at_far": res.tar_at_far}


def cmd_eval_verification(args, overrides: list[str]) -> int:
    from crfr_torch.data.datasets import parse_lfw_pairs
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.eval.verification import evaluate_verification

    tr, cfg = _embed_fn_from_ckpt(args, overrides)
    proto = parse_lfw_pairs(args.pairs, args.lfw_root)
    sr_apply = _sr_apply_if_requested(args, cfg)
    degrade = _lr_degrade(args, cfg, sr_apply)
    backbone = _backbone_apply(tr, cfg, args)
    fn_hr = make_extract_fn(backbone, **_extract_kw(tr, cfg))
    # the LR side: bicubic down and up, or down and G up with --sr-ckpt
    fn_lr = make_extract_fn(backbone, degrade_to=degrade, sr_apply=sr_apply,
                            **_extract_kw(tr, cfg))
    # cross-resolution: only the probe side of each pair is degraded
    # (--degrade-side second); 'both' gives the symmetric LR protocol
    side = args.degrade_side if degrade else "none"
    e1 = _embed_paths(proto.path1, fn_lr if side in ("first", "both") else fn_hr, cfg)
    e2 = _embed_paths(proto.path2, fn_lr if side in ("second", "both") else fn_hr, cfg)
    res = evaluate_verification(e1, e2, proto.issame, proto.n_folds, cfg.eval.far_targets,
                                device=tr.device)
    print(json.dumps(_verification_json(res)), flush=True)
    return 0


def cmd_eval_scface(args, overrides: list[str]) -> int:
    from crfr_torch.data.datasets import scface_split
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.eval.identification import closed_set_identification

    tr, cfg = _embed_fn_from_ckpt(args, overrides)
    split = scface_split(args.gallery, args.probes, args.distance)
    backbone = _backbone_apply(tr, cfg, args)
    fn = make_extract_fn(backbone, **_extract_kw(tr, cfg))
    sr_apply = _sr_apply_if_requested(args, cfg)
    # with --sr-ckpt the probes go down to G's input size, then G up
    fn_p = fn if sr_apply is None else make_extract_fn(
        backbone, degrade_to=cfg.model.input_size // args.sr_scale, sr_apply=sr_apply,
        **_extract_kw(tr, cfg))
    g = _embed_paths(split.gallery_paths, fn, cfg)
    p = _embed_paths(split.probe_paths, fn_p, cfg)
    res = closed_set_identification(p, g, split.probe_labels, split.gallery_labels,
                                    block=cfg.eval.gallery_block, mesh=tr.mesh,
                                    device=tr.device)
    print(json.dumps({"rank1": res.rank1, "cmc": res.cmc.tolist()}), flush=True)
    return 0


def _need(args, *names: str, mode: str) -> None:
    missing = [n for n in names if not getattr(args, n)]
    if missing:
        raise ValueError(f"{mode} needs " + " ".join("--" + n.replace("_", "-")
                                                    for n in missing))


def cmd_eval_openset(args, overrides: list[str]) -> int:
    """Open-set identification (TinyFace / QMUL-SurvFace): CMC and
    TPIR@FPIR over the gallery, from image lists embedded with ``--ckpt``
    (probes optionally degraded or hallucinated) or from precomputed
    embeddings (``--probe-npy``), which need no model."""
    import numpy as np

    from crfr_torch.eval.identification import open_set_identification

    if args.probe_npy:
        _need(args, "gallery_npy", "probe_labels_npy", "mated_npy", mode="--probe-npy mode")
        if not (args.gallery_labels_npy or args.gallery_npy.endswith(".npz")):
            raise ValueError("--probe-npy mode needs --gallery-labels-npy (or a .npz bank)")
        from crfr_torch.configs import get_config

        g, glab = _load_gallery(args.gallery_npy, args.gallery_labels_npy)
        p = np.load(args.probe_npy)
        plab = np.load(args.probe_labels_npy)
        mated = np.load(args.mated_npy).astype(bool)
        cfg = get_config(args.preset, overrides)
        device, mesh = args.device, _topk_mesh(args.device)
    else:
        from crfr_torch.data.datasets import open_set_split
        from crfr_torch.eval.extract import make_extract_fn

        _need(args, "ckpt", "gallery_list", "mated_list", "unmated_list",
              mode="image-list mode (or use --probe-npy)")
        tr, cfg = _embed_fn_from_ckpt(args, overrides)
        split = open_set_split(args.gallery_list, args.mated_list, args.unmated_list, args.root)
        backbone = _backbone_apply(tr, cfg, args)
        fn_g = make_extract_fn(backbone, **_extract_kw(tr, cfg))
        sr_apply = _sr_apply_if_requested(args, cfg)
        degrade = _lr_degrade(args, cfg, sr_apply)
        # the probes (the native-LR side) may be degraded or hallucinated;
        # the HR gallery never is
        fn_p = (make_extract_fn(backbone, degrade_to=degrade, sr_apply=sr_apply,
                                **_extract_kw(tr, cfg)) if degrade else fn_g)
        g = _embed_paths(split.gallery_paths, fn_g, cfg)
        p = _embed_paths(split.probe_paths, fn_p, cfg)
        glab, plab, mated = split.gallery_labels, split.probe_labels, split.probe_mated
        device, mesh = tr.device, tr.mesh
    res = open_set_identification(p, g, plab, glab, mated, cfg.eval.fpir_targets,
                                  max_rank=args.max_rank, block=cfg.eval.gallery_block,
                                  mesh=mesh, approx=_approx_flag(args), device=device)
    print(json.dumps({"rank1": res.rank1, "cmc": res.cmc.tolist(),
                      "tpir_at_fpir": res.tpir_at_fpir}), flush=True)
    return 0


def cmd_eval_bin(args, overrides: list[str]) -> int:
    """An insightface ``.bin`` verification set (lfw.bin, cfp_fp.bin, agedb_30.bin)."""
    from crfr_torch.data.bins import evaluate_bin
    from crfr_torch.eval.extract import make_extract_fn

    tr, cfg = _embed_fn_from_ckpt(args, overrides)
    sr_apply = _sr_apply_if_requested(args, cfg)
    fn = make_extract_fn(_backbone_apply(tr, cfg, args),
                         degrade_to=_lr_degrade(args, cfg, sr_apply), sr_apply=sr_apply,
                         **_extract_kw(tr, cfg))
    res = evaluate_bin(args.bin, fn, cfg.eval.batch_size, cfg.model.input_size,
                       cfg.eval.n_folds, cfg.eval.far_targets, device=tr.device)
    print(json.dumps(_verification_json(res)), flush=True)
    return 0


def _read_ijbc_meta(path: str, root: str):
    """'path template_id media_id subject_id' per line (shorter lines are
    skipped) → (paths, template ids, media ids, subject ids)."""
    import numpy as np

    paths, tids, mids, sids = [], [], [], []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) < 4:
                continue
            paths.append(os.path.join(root, parts[0]))
            tids.append(int(parts[1]))
            mids.append(int(parts[2]))
            sids.append(int(parts[3]))
    return paths, np.asarray(tids), np.asarray(mids), np.asarray(sids)


def _ijbc_1n_json(avg, r1, r2) -> dict:
    import numpy as np

    return {"rank1": avg.rank1, "cmc": np.asarray(avg.cmc).tolist(),
            "tpir_at_fpir": avg.tpir_at_fpir, "rank1_g1": r1.rank1, "rank1_g2": r2.rank1}


def cmd_eval_ijbc(args, overrides: list[str]) -> int:
    """IJB-C: 1:1 (``--meta`` and ``--pairs`` of 't1 t2 label' lines) and/or
    1:N (``--probe-meta``, ``--gallery-g1``, ``--gallery-g2``, meta lists
    'path template_id media_id subject_id'; averaged over the two gallery
    splits), or 1:N from pooled template embeddings (``--probe-tpl-npy``),
    which needs no model."""
    import numpy as np

    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.eval.ijbc import ijbc_11, ijbc_1n_two_gallery, pool_meta

    if args.probe_tpl_npy:
        from crfr_torch.configs import get_config

        cfg = get_config(args.preset, overrides)
        res = ijbc_1n_two_gallery(
            np.load(args.probe_tpl_npy), np.load(args.probe_subjects_npy),
            np.load(args.g1_tpl_npy), np.load(args.g1_subjects_npy),
            np.load(args.g2_tpl_npy), np.load(args.g2_subjects_npy),
            fpir_targets=cfg.eval.fpir_targets, block=cfg.eval.gallery_block,
            mesh=_topk_mesh(args.device), approx=_approx_flag(args), device=args.device)
        print(json.dumps(_ijbc_1n_json(*res)), flush=True)
        return 0

    if not args.ckpt:
        raise ValueError("eval-ijbc needs --ckpt (or the --probe-tpl-npy mode)")
    tr, cfg = _embed_fn_from_ckpt(args, overrides)
    fn = make_extract_fn(_backbone_apply(tr, cfg, args), **_extract_kw(tr, cfg))
    out: dict = {}

    def pooled(meta_path):
        paths, tids, mids, sids = _read_ijbc_meta(meta_path, args.root)
        return pool_meta(_embed_paths(paths, fn, cfg), tids, mids, sids, device=tr.device)

    if args.meta and args.pairs:
        paths, tids, mids, _ = _read_ijbc_meta(args.meta, args.root)
        t1, t2, lab = [], [], []
        with open(args.pairs) as f:
            for ln in f:
                parts = ln.split()
                if len(parts) == 3:
                    t1.append(int(parts[0]))
                    t2.append(int(parts[1]))
                    lab.append(int(parts[2]))
        res = ijbc_11(_embed_paths(paths, fn, cfg), tids, mids, np.asarray(t1),
                      np.asarray(t2), np.asarray(lab), device=tr.device)
        out["tar_at_far"] = res.tar_at_far
    if args.probe_meta and args.gallery_g1 and args.gallery_g2:
        p_emb, p_subj, _ = pooled(args.probe_meta)
        g1_emb, g1_subj, _ = pooled(args.gallery_g1)
        g2_emb, g2_subj, _ = pooled(args.gallery_g2)
        out.update(_ijbc_1n_json(*ijbc_1n_two_gallery(
            p_emb, p_subj, g1_emb, g1_subj, g2_emb, g2_subj,
            fpir_targets=cfg.eval.fpir_targets, block=cfg.eval.gallery_block,
            mesh=tr.mesh, approx=_approx_flag(args), device=tr.device)))
    if not out:
        print("eval-ijbc: nothing to do: pass --meta and --pairs (1:1) and/or "
              "--probe-meta, --gallery-g1 and --gallery-g2 (1:N)", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


def cmd_import_torch(args, overrides: list[str]) -> int:
    """A face.evoLVe state dict → a ``train`` checkpoint (step 0) that every
    eval, ``export`` and ``train --resume`` command restores."""
    import torch

    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.torch_import import load_face_evolve_state_dict

    cfg = get_config(args.preset, overrides)
    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    tr = Trainer(cfg, device=args.device)
    load_face_evolve_state_dict(tr.model.backbone, sd)
    ck = Checkpointer(args.out, keep=1)
    ck.save(0, tr.state, cfg.to_json(), force=True)
    ck.close()
    print(json.dumps({"out": args.out, "keys": len(sd)}), flush=True)
    return 0


def cmd_export(args, overrides: list[str]) -> int:
    """A checkpoint → a serving artifact (``serve.export_embed``) on the
    trainer's device: optional degrade, hallucinator, flip-TTA and int8."""
    from crfr_torch.serve import export_embed

    tr, cfg = _embed_fn_from_ckpt(args, overrides)
    sr_apply = _sr_apply_if_requested(args, cfg)
    degrade = _lr_degrade(args, cfg, sr_apply)
    # --int8 calibrates on seeded noise through the same front end, as crfr's export does
    quantized = _quantized_backbone(tr, cfg, degrade_to=degrade) if args.int8 else None
    meta = export_embed(tr, args.out, batch=args.batch, degrade_to=degrade,
                        flip_tta=args.flip_tta, sr_apply=sr_apply, backbone_apply=quantized,
                        quantized=bool(args.int8))
    print(json.dumps(meta | {"out": args.out}), flush=True)
    return 0


def cmd_pack(args, overrides: list[str]) -> int:
    from crfr_torch.data.records import pack_image_folder

    if not args.out.endswith(".crfrpack"):
        raise ValueError(f"{args.out}: crfr_torch writes .crfrpack records only; ArrayRecord "
                         "files need the array_record package, which the port does not use")
    if args.from_rec:
        from crfr_torch.data.mxrec import convert_rec

        n, c = convert_rec(args.from_rec, args.out, idx_path=args.idx or None)
    elif args.root:
        n, c = pack_image_folder(args.root, args.out, size=args.size)
    else:
        raise ValueError("pack needs --root (an identity folder tree) or --from-rec")
    print(json.dumps({"images": n, "identities": c, "out": args.out}), flush=True)
    return 0


def cmd_serve_http(args, overrides: list[str]) -> int:
    """The HTTP daemon (``serve_http.serve_artifact``) on an artifact of
    ``export``, on the artifact's device, until interrupted."""
    from crfr_torch.serve_http import serve_artifact

    srv = serve_artifact(args.artifact, gallery_npz=args.gallery_npz, host=args.host,
                         port=args.port, window_ms=args.window_ms,
                         mutable=args.mutable_gallery, slab=args.gallery_slab)
    host, port = srv.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}", "artifact": args.artifact,
                      "gallery": bool(args.gallery_npz), "mutable": args.mutable_gallery}),
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.service.close()
        srv.server_close()
    return 0


def cmd_bench(args, overrides: list[str]) -> int:
    """Embed throughput of ``bench.throughput.run_throughput``, as
    ``crfr``'s ``bench`` prints it."""
    from crfr_torch.bench.throughput import run_throughput

    res = run_throughput(batch=args.batch, steps=args.steps, int8=bool(args.int8),
                         device=args.device)
    print(json.dumps({"imgs_per_sec": res.imgs_per_sec, "per_batch_ms": res.per_batch_ms,
                      "int8": bool(args.int8)}), flush=True)
    return 0


def _add_sr_args(p, help_ckpt: str) -> None:
    """The frozen-hallucinator flags of every consumer of --sr-ckpt."""
    p.add_argument("--sr-ckpt", default="", help=help_ckpt)
    p.add_argument("--sr-scale", type=int, default=8)
    p.add_argument("--sr-bicubic-skip", type=int, default=1,
                   help="the G of --sr-ckpt was trained with the bicubic skip (1) or not (0)")


def _add_approx_args(p) -> None:
    p.add_argument("--approx", action="store_true",
                   help="accepted; the selection stays exact (eval/identification.py)")
    p.add_argument("--approx-recall", type=float, default=0.0,
                   help="accepted, implies --approx; the selection stays exact")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="crfr_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="ArcFace training (one process per device)")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop at this global step (0: 1000 synthetic steps, or the records "
                        "without end)")
    p.add_argument("--steps-per-epoch", type=int, default=1000)
    p.add_argument("--workers", type=int, default=0, help="record reader threads")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--train-records", default="",
                   help=".crfrpack of (label, image) records (data.train_records)")
    p.add_argument("--eval-bin", default="",
                   help="an insightface .bin verified every train.eval_every_steps")
    p.add_argument("--tensorboard", default="",
                   help="also mirror metrics to TensorBoard event files")
    p.add_argument("--recycle-every-steps", type=int, default=0,
                   help="checkpoint and restart the process (--resume) every N steps")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("train-sr", help="hallucinator (SR GAN) training (one process per device)")
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

    p = sub.add_parser("train-distill", help="a student with residual KD (one process per device)")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--teacher-ckpt", required=True,
                   help="recognition checkpoint (of train), restored with its own config")
    p.add_argument("--kd-weight", type=float, default=1.0,
                   help="loss.distill_weight when the preset's is 0")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop at this global step (0: 1000 steps from the start)")
    p.add_argument("--resume", action="store_true")
    _add_sr_args(p, "hallucinator checkpoint (of train-sr): the student consumes G(lr)")
    p.add_argument("--sr-finetune", action="store_true",
                   help="fine-tune G jointly with the student (needs --sr-ckpt); G's state "
                        "checkpoints with the student")
    p.add_argument("--sr-lr", type=float, default=1e-5)
    p.add_argument("--sr-pixel-weight", type=float, default=0.3,
                   help="weight of the pixel anchor of joint G fine-tuning")
    p.add_argument("--eval-bin", default="",
                   help="an insightface .bin verified every train.eval_every_steps")
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
    _add_approx_args(p)
    _add_sr_args(p, "route probe images through this hallucinator (of train-sr)")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_match)

    p = sub.add_parser("eval-verification", help="LFW-style 1:1 verification of a pairs list")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--pairs", required=True, help="LFW pairs.txt")
    p.add_argument("--lfw-root", required=True)
    p.add_argument("--preset", default="lfw_ir50_16px")
    p.add_argument("--degrade", type=int, default=0,
                   help="probe degradation size (0: the config's eval_degrade_size)")
    p.add_argument("--degrade-side", default="second", choices=("first", "second", "both"))
    _add_sr_args(p, "route the degraded side through this hallucinator (of train-sr)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_eval_verification)

    p = sub.add_parser("eval-scface", help="SCface closed-set identification")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--gallery", required=True, help="directory of <id>_frontal.* mugshots")
    p.add_argument("--probes", required=True, help="directory of <id>_cam<k>_<d>.* shots")
    p.add_argument("--distance", type=int, default=1, choices=(1, 2, 3))
    p.add_argument("--preset", default="scface")
    _add_sr_args(p, "route the probes through this hallucinator (of train-sr)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_eval_scface)

    p = sub.add_parser("eval-openset", help="open-set identification (TinyFace, SurvFace)")
    p.add_argument("--ckpt", default="", help="recognition checkpoint (image-list mode)")
    p.add_argument("--gallery-list", default="")
    p.add_argument("--mated-list", default="")
    p.add_argument("--unmated-list", default="")
    p.add_argument("--root", default="")
    p.add_argument("--degrade", type=int, default=0,
                   help="probe degradation size (0: the config's eval_degrade_size)")
    p.add_argument("--max-rank", type=int, default=20, help="CMC depth")
    _add_sr_args(p, "route the probes through this hallucinator (of train-sr)")
    p.add_argument("--probe-npy", default="",
                   help="precomputed probe embeddings .npy (no --ckpt)")
    p.add_argument("--probe-labels-npy", default="")
    p.add_argument("--gallery-npy", default="", help="float .npy or int8 .npz gallery")
    p.add_argument("--gallery-labels-npy", default="")
    p.add_argument("--mated-npy", default="", help="bool .npy: the probe is enrolled")
    _add_approx_args(p)
    p.add_argument("--preset", default="tinyface_survface")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_eval_openset)

    p = sub.add_parser("eval-bin", help="verification on an insightface .bin set")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--bin", required=True)
    p.add_argument("--degrade", type=int, default=0,
                   help="degradation size (0: the config's eval_degrade_size)")
    p.add_argument("--preset", default="lfw_ir50_16px")
    _add_sr_args(p, "route the degraded images through this hallucinator (of train-sr)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_eval_bin)

    p = sub.add_parser("eval-ijbc", help="IJB-C 1:1 and 1:N")
    p.add_argument("--ckpt", default="", help="recognition checkpoint (meta mode)")
    p.add_argument("--meta", default="", help="1:1 image meta list")
    p.add_argument("--pairs", default="", help="1:1 't1 t2 label' lines")
    p.add_argument("--probe-meta", default="", help="1:N probe meta list")
    p.add_argument("--gallery-g1", default="", help="1:N gallery split 1")
    p.add_argument("--gallery-g2", default="", help="1:N gallery split 2")
    p.add_argument("--root", default="")
    p.add_argument("--probe-tpl-npy", default="",
                   help="precomputed pooled probe templates .npy (1:N, no --ckpt)")
    p.add_argument("--probe-subjects-npy", default="")
    p.add_argument("--g1-tpl-npy", default="")
    p.add_argument("--g1-subjects-npy", default="")
    p.add_argument("--g2-tpl-npy", default="")
    p.add_argument("--g2-subjects-npy", default="")
    p.add_argument("--preset", default="ms1m_ijbc")
    _add_approx_args(p)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_eval_ijbc)

    p = sub.add_parser("import-torch", help="a face.evoLVe state dict into a checkpoint")
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--out", required=True, help="checkpoint directory to write")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_import_torch)

    p = sub.add_parser("export", help="a checkpoint into a serving artifact")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=256, help="the artifact's static batch")
    p.add_argument("--degrade", type=int, default=0,
                   help="degradation size (0: the config's eval_degrade_size)")
    p.add_argument("--flip-tta", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="export the int8 backbone, calibrated on seeded noise")
    _add_sr_args(p, "put this hallucinator (of train-sr) in front of the backbone")
    p.add_argument("--preset", default="casia_arcface")
    p.add_argument("--device", default="cuda",
                   help="the artifact's device: cuda (default) or cpu")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("pack", help="an image folder tree or an MXNet .rec into .crfrpack")
    p.add_argument("--root", default="", help="identity folder tree to pack")
    p.add_argument("--out", required=True, help="a .crfrpack path")
    p.add_argument("--size", type=int, default=112)
    p.add_argument("--from-rec", default="",
                   help="convert an MXNet .rec (insightface layout)")
    p.add_argument("--idx", default="", help=".idx path (default: beside --from-rec)")
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("serve-http", help="the HTTP daemon on a serving artifact")
    p.add_argument("--artifact", required=True, help="a serving artifact of export")
    p.add_argument("--gallery-npz", default="",
                   help="int8 bank (extract --quantize-bank) for /match")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--window-ms", type=float, default=2.0, help="request-coalescing window")
    p.add_argument("--mutable-gallery", action="store_true",
                   help="serve the bank as a ServingBank: /enroll, /remove, /gallery")
    p.add_argument("--gallery-slab", type=int, default=0,
                   help="capacity rounding slab of --mutable-gallery "
                        "(default ServingBank.SLAB=65536)")
    p.set_defaults(fn=cmd_serve_http)

    p = sub.add_parser("bench", help="embed throughput (crfr's bench line)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--int8", action="store_true",
                   help="bench the int8 PTQ embed path instead of bf16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_bench)

    args, extra = ap.parse_known_args(argv)
    args._argv = list(sys.argv[1:] if argv is None else argv)     # for --recycle-every-steps
    overrides, unknown = _split_overrides(extra)
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    try:
        return args.fn(args, overrides)
    finally:
        # a rank that ends, by an exception or not, leaves the group, so the
        # others fail in their next collective and the job ends
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())

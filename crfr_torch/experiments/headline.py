"""The paper's headline experiment as one reproducible run
(crfr/experiments/headline.py).

  1. render identities (``data.render``): disjoint train / eval /
     distractor splits from one seeded renderer, on the host;
  2. HR teacher: an ArcFace ``Trainer`` on full-resolution faces (the
     preprocessing kernel at low = image size, one launch a step);
  3. per probe size, the prior-aided SR GAN: ``SRTrainer`` with the frozen
     teacher's identity and perceptual terms, its prior estimator
     supervised by the renderer's landmarks, a cosine schedule and R1;
  4. the KD student through the frozen hallucinator:
     ``DistillTrainer(sr_fn=G)``;
  5. the baseline student: the same ``DistillTrainer`` on bicubic probes;
  6. cross-resolution eval of three systems at each probe size, all matched
     against the same teacher-embedded HR gallery:
       teacher_lr    the teacher on bicubic-upsampled probes,
       student_bic   the KD student on bicubic probes (s + r),
       student_sr    the KD student on hallucinated probes (s + r; kernel
                     2's ↓ and G's eval forward per probe batch).
     Protocols: cross-resolution verification (LR probe against HR
     reference), closed-set identification (rank-1, CMC-5), open-set
     identification with unenrolled distractors (TPIR at FPIR 0.1), and a
     paired bootstrap of the ordering gaps.

The paper's claim: student_sr > student_bic > teacher_lr (``ordering_holds``).
Every stage checkpoints under ``out_dir``, and the table goes to
``out_dir/headline.json``:

    python -m crfr_torch headline --out DIR

The int8 row (``int8_eval``, on by default as in the reference) re-runs
verification and rank-1 with each system's backbone quantized
(``models.quant``, calibrated on the first two eval batches of the training
faces through the plain down-up operator at the probe size); the residual
branch and G stay float, and so does the teacher's HR gallery.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from crfr_torch.configs import Config, DataCfg, EvalCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr_torch.device import resolve_device


@dataclass(frozen=True)
class HeadlineCfg:
    # data
    ids_train: int = 96
    ids_eval: int = 64
    ids_distract: int = 64
    samples_per_id: int = 48
    image_size: int = 112
    hard: float = 0.0             # the renderer's HR-nuisance intensity
    seed: int = 0
    # model and training
    backbone: str = "ir_18"
    compute_dtype: str = "bfloat16"
    batch_size: int = 64
    teacher_steps: int = 1200
    sr_steps: int = 800
    distill_steps: int = 800
    lr_teacher: float = 0.1
    lr_student: float = 0.05
    # the KD weight on the raw-feature L2: teacher embeddings carry ‖t‖ ≈ 20,
    # so λ = 0.05 starts the KD term near 1.5× the CE
    kd_weight: float = 0.05
    grad_clip: float = 5.0
    probe_sizes: tuple[int, ...] = (16, 8)
    # eval
    n_pairs: int = 512            # per polarity (1024 verification pairs)
    probes_per_id: int = 12
    enroll_frac: float = 0.5      # the share of eval ids enrolled for open set
    eval_batch: int = 64
    # paired bootstrap over pairs and probes: every system resampled with
    # the same indices, so the gap CIs are CIs of per-item differences
    bootstrap: int = 2000         # resamples; 0 turns it off
    # the int8 row: verification and rank-1 again with each system's
    # backbone conv-quantized (models/quant.py)
    int8_eval: bool = True
    # plumbing
    out_dir: str = "/tmp/crfr_headline"
    mesh_data: int = 1
    log_every: int = 200


def _cfg(h: HeadlineCfg, *, num_classes: int, degrade: int | None,
         lr: float, steps: int, distill: float = 0.0,
         name: str = "headline") -> Config:
    """One Config per stage; degrade=None → HR-only training."""
    d = degrade if degrade is not None else h.image_size
    return Config(
        name=name,
        mesh=MeshCfg(data=h.mesh_data, model=1),
        data=DataCfg(image_size=h.image_size, num_classes=num_classes,
                     degrade_min=d, degrade_max=d,
                     per_sample_degrade=False, random_flip=True),
        model=ModelCfg(backbone=h.backbone, compute_dtype=h.compute_dtype,
                       dropout=0.0, input_size=h.image_size),
        loss=LossCfg(scale=32.0, margin=0.3, distill_weight=distill,
                     sr_adv_weight=1e-3, sr_identity_weight=1e-2,
                     sr_prior_weight=1.0, sr_perceptual_weight=1e-2),
        train=TrainCfg(batch_size=h.batch_size, lr=lr,
                       warmup_steps=max(steps // 10, 1), schedule="step",
                       lr_drop_epochs=(), weight_decay=5e-4,
                       grad_clip_norm=h.grad_clip,
                       seed=h.seed, log_every=h.log_every,
                       eval_every_steps=10 ** 9,
                       checkpoint_every_steps=10 ** 9,
                       checkpoint_dir=os.path.join(h.out_dir, name)),
        eval=EvalCfg(n_folds=8),
    )


def _epoch_feed(imgs: np.ndarray, labels: np.ndarray, batch: int,
                steps: int, seed: int, lms: np.ndarray | None = None):
    """Shuffled epochs over a fixed rendered set, exactly ``steps`` batches
    (epochs wrap; the remainder of an epoch is dropped). With ``lms`` the
    per-sample landmarks ride along as a third element."""
    rng = np.random.default_rng(seed)
    n = (len(imgs) // batch) * batch
    done = 0
    while done < steps:
        perm = rng.permutation(len(imgs))[:n]
        for i in range(0, n, batch):
            if done == steps:
                return
            sel = perm[i:i + batch]
            x = imgs[sel].astype(np.float32)
            yield ((x, labels[sel]) if lms is None
                   else (x, labels[sel], lms[sel]))
            done += 1


def _embed_arrays(fn, imgs: np.ndarray, batch: int) -> np.ndarray:
    """Embed in chunks of ``batch``, the tail padded with zero images (BN in
    eval mode keeps the rows apart, so the padding changes no real row)."""
    out = []
    for i in range(0, len(imgs), batch):
        chunk = imgs[i:i + batch].astype(np.float32)
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:],
                                                    np.float32)])
        out.append(fn(chunk).float().cpu().numpy()[:batch - pad])
    return np.concatenate(out)


def _train_teacher(h: HeadlineCfg, imgs, labels, n_classes, device):
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    cfg = _cfg(h, num_classes=n_classes, degrade=None, lr=h.lr_teacher,
               steps=h.teacher_steps, name="teacher")
    tr = Trainer(cfg, steps_per_epoch=max(len(imgs) // h.batch_size, 1), device=device)
    m = {}
    for x, y in _epoch_feed(imgs, labels, h.batch_size, h.teacher_steps, h.seed + 1):
        m = tr.train_step(x, y)
    Checkpointer(cfg.train.checkpoint_dir, keep=1).save(h.teacher_steps, tr.state,
                                                         cfg.to_json(), force=True)
    return tr, float(m.get("loss", np.nan))


def _train_sr(h: HeadlineCfg, teacher_tr, imgs, probe: int, lms=None, device=None):
    """``lms`` (N, 5, 2): the renderer's landmarks, which supervise the
    prior estimator (heatmaps and parsing maps)."""
    from crfr_torch.train.distill_loop import teacher_from_trainer
    from crfr_torch.train.sr_loop import SRTrainer, perceptual_from_trainer

    scale = h.image_size // probe
    cfg = _cfg(h, num_classes=h.ids_train, degrade=probe, lr=1e-4,
               steps=h.sr_steps, name=f"sr{probe}")
    tr = SRTrainer(cfg, scale=scale,
                   teacher_fn=teacher_from_trainer(teacher_tr),
                   perceptual_fn=perceptual_from_trainer(teacher_tr),
                   schedule="cosine", total_steps=h.sr_steps,
                   warmup_steps=max(h.sr_steps // 20, 1),
                   r1_gamma=1.0, device=device)
    m = {}
    for b in _epoch_feed(imgs, np.zeros(len(imgs), np.int32),
                         h.batch_size, h.sr_steps, h.seed + 2, lms=lms):
        m = tr.train_step(b[0], landmarks=b[2] if lms is not None else None)
    return tr, {k: float(v) for k, v in m.items()}


def _train_student(h: HeadlineCfg, teacher_tr, imgs, labels, n_classes,
                   probe: int, sr_fn=None, device=None):
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer

    scale = h.image_size // probe
    name = f"student{'_sr' if sr_fn is not None else '_bic'}{probe}"
    cfg = _cfg(h, num_classes=n_classes, degrade=probe, lr=h.lr_student,
               steps=h.distill_steps, distill=h.kd_weight, name=name)
    tr = DistillTrainer(cfg, teacher_from_trainer(teacher_tr),
                        steps_per_epoch=max(len(imgs) // h.batch_size, 1),
                        sr_fn=sr_fn, sr_scale=scale, device=device)
    m = {}
    for x, y in _epoch_feed(imgs, labels, h.batch_size, h.distill_steps, h.seed + 3):
        m = tr.train_step(x, y)
    return tr, float(m.get("loss", np.nan))


def _probe_embedders(h: HeadlineCfg, teacher_tr, students: dict, sr_apply, probe: int,
                     device=None):
    """The LR-probe embedding fn of each system, and the teacher's HR
    embedder they share."""
    from crfr_torch.eval.extract import make_extract_fn

    dev = teacher_tr.device if device is None else device
    kw = dict(image_size=h.image_size, flip=False, device=dev)
    hr = make_extract_fn(teacher_tr.backbone_apply, degrade_to=None,
                         state_fn=teacher_tr.embed_state, **kw)
    bic, sr = students["student_bic"], students["student_sr"]
    sys_lr = {
        "teacher_lr": make_extract_fn(teacher_tr.backbone_apply, degrade_to=probe,
                                      state_fn=teacher_tr.embed_state, **kw),
        "student_bic": make_extract_fn(bic.student_apply, degrade_to=probe,
                                       state_fn=lambda: bic.model, **kw),
        "student_sr": make_extract_fn(sr.student_apply, degrade_to=probe,
                                      state_fn=lambda: sr.model, sr_apply=sr_apply, **kw),
    }
    return hr, sys_lr


def _int8_probe_embedders(h: HeadlineCfg, teacher_tr, students: dict, sr_apply, probe: int,
                          calib_raw: np.ndarray, device=None) -> dict:
    """The int8 twins of the three probe embedders: each system's backbone
    quantized (``models.quant``), calibrated on ``calib_raw``'s first two
    eval batches through the plain bicubic down-up operator at ``probe``
    and normalization (absmax calibration does not tell G's upsampling from
    bicubic); the residual branch and G stay float."""
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.models.quant import calibration_batch, quantize_backbone
    from crfr_torch.train.distill_loop import frozen_copy

    dev = teacher_tr.device if device is None else resolve_device(device)
    n = min(len(calib_raw), 2 * h.eval_batch)
    calib = [calibration_batch(calib_raw[i:i + h.eval_batch], probe, "pil", dev)
             for i in range(0, n, h.eval_batch)]
    kw = dict(degrade_to=probe, image_size=h.image_size, flip=False, device=dev)
    t_q = quantize_backbone(teacher_tr.model.backbone, calib,
                            compute_dtype=teacher_tr.compute_dtype)
    out = {"teacher_lr": make_extract_fn(lambda x: t_q(x).float(), **kw)}
    for name in ("student_bic", "student_sr"):
        st = students[name]
        q_bb = quantize_backbone(st.model.backbone, calib, compute_dtype=st.compute_dtype)
        residual = frozen_copy(st.model.residual)

        def apply(x, q_bb=q_bb, residual=residual):
            s = q_bb(x).float()
            return s + residual(s)

        out[name] = make_extract_fn(apply, sr_apply=sr_apply if name == "student_sr" else None,
                                    **kw)
    return out


def _pair_correct(e_lr: np.ndarray, e_hr: np.ndarray, issame: np.ndarray,
                  thresholds: np.ndarray) -> np.ndarray:
    """Per-pair correctness at the mean of the folds' best thresholds: the
    binary vector the bootstrap resamples. Point estimates stay the CV
    protocol's accuracy_mean; the CI is of fixed-threshold accuracy."""
    a = e_lr / np.linalg.norm(e_lr, axis=-1, keepdims=True).clip(1e-12)
    b = e_hr / np.linalg.norm(e_hr, axis=-1, keepdims=True).clip(1e-12)
    dist = 2.0 - 2.0 * (a * b).sum(-1)
    return (dist < float(np.mean(thresholds))) == issame


def _bootstrap_ci(hits: dict[str, dict[str, np.ndarray]], n_boot: int,
                  seed: int) -> dict:
    """Paired bootstrap over items: per system and metric a 95% CI of the
    mean, and CIs of the ordering gaps (student_sr − student_bic,
    student_bic − teacher_lr) on the same resample indices."""
    rng = np.random.default_rng(seed)
    out: dict = {s: {} for s in hits}
    gaps: dict = {}
    metrics = next(iter(hits.values())).keys()
    for metric in metrics:
        vecs = {s: np.asarray(hits[s][metric], np.float64) for s in hits}
        n = len(next(iter(vecs.values())))
        idx = rng.integers(0, n, (n_boot, n))
        means = {s: v[idx].mean(axis=1) for s, v in vecs.items()}
        for s in hits:
            lo, hi = np.percentile(means[s], [2.5, 97.5])
            out[s][metric] = {"mean": float(vecs[s].mean()),
                              "ci95": [round(float(lo), 4),
                                       round(float(hi), 4)]}
        for gname, a, b in (("sr_minus_bic", "student_sr", "student_bic"),
                            ("bic_minus_teacher", "student_bic",
                             "teacher_lr")):
            d = means[a] - means[b]
            lo, hi = np.percentile(d, [2.5, 97.5])
            gaps.setdefault(metric, {})[gname] = {
                "mean": round(float(vecs[a].mean() - vecs[b].mean()), 4),
                "ci95": [round(float(lo), 4), round(float(hi), 4)],
                "significant": bool(lo > 0)}
    return {"systems": out, "gaps": gaps}


def _evaluate_probe(h: HeadlineCfg, renderer, hr_embed, sys_lr,
                    eval_range, distract_range, rng, device=None,
                    sys_lr_int8: dict | None = None, timings: dict | None = None) -> dict:
    """One probe size's table (``crfr``'s schema); ``timings``, when given,
    receives the int8 row's seconds as ``int8_eval_s``."""
    from crfr_torch.eval.identification import (_rank_from_topk, open_set_identification,
                                                topk_matches)
    from crfr_torch.eval.verification import evaluate_verification

    dev = resolve_device("cuda" if device is None else device)
    lo, hi = eval_range
    n_eval = hi - lo

    # verification pairs: member 1 is the LR probe, member 2 the HR
    # reference (embedded by the teacher for every system)
    p1, p2, issame = renderer.eval_pairs(rng, h.n_pairs, id_range=eval_range)
    e_hr = _embed_arrays(hr_embed, p2, h.eval_batch)

    # identification: one HR mugshot per eval id (the teacher's gallery),
    # probes_per_id LR probes per eval id and per distractor id
    gal_ids = np.arange(lo, hi)
    gal_imgs = renderer.sample_for_ids(rng, gal_ids)
    g_emb = _embed_arrays(hr_embed, gal_imgs, h.eval_batch)

    probe_ids = np.repeat(np.arange(lo, hi), h.probes_per_id)
    probe_imgs = renderer.sample_for_ids(rng, probe_ids)

    dlo, dhi = distract_range
    dist_ids = np.repeat(np.arange(dlo, dhi), h.probes_per_id)
    dist_imgs = renderer.sample_for_ids(rng, dist_ids)

    # open set: the first enroll_n eval ids stay in the gallery; probes of
    # the other eval ids and the distractors are unmated
    enroll_n = max(int(n_eval * h.enroll_frac), 1)
    os_gal = g_emb[:enroll_n]
    os_gal_ids = gal_ids[:enroll_n]

    out = {}
    hits: dict[str, dict[str, np.ndarray]] = {}
    for name, lr_embed in sys_lr.items():
        e_lr = _embed_arrays(lr_embed, p1, h.eval_batch)
        ver = evaluate_verification(e_lr, e_hr, issame, n_folds=8, far_targets=(1e-2,),
                                    device=dev)
        pe = _embed_arrays(lr_embed, probe_imgs, h.eval_batch)
        de = _embed_arrays(lr_embed, dist_imgs, h.eval_batch)
        _, top_l = topk_matches(pe, g_emb, gal_ids, k=5, device=dev)
        r1_hits, cmc_hits = _rank_from_topk(top_l, probe_ids, 5)
        os_pe = np.concatenate([pe, de])
        os_ids = np.concatenate([probe_ids, dist_ids])
        mated = np.isin(os_ids, os_gal_ids)
        opn = open_set_identification(os_pe, os_gal, os_ids, os_gal_ids, mated,
                                      fpir_targets=(1e-1,), max_rank=5, device=dev)
        out[name] = {
            "verification_acc": float(ver.accuracy_mean),
            "rank1": float(np.mean(r1_hits)),
            "cmc5": float(cmc_hits[:, -1].mean()),
            "tpir_at_fpir0.1": float(opn.tpir_at_fpir[0.1]),
        }
        hits[name] = {
            "verification_acc": _pair_correct(e_lr, e_hr, issame, ver.best_thresholds),
            "rank1": r1_hits, "cmc5": cmc_hits[:, -1],
        }
    if h.bootstrap > 0:
        out["bootstrap"] = _bootstrap_ci(hits, h.bootstrap, h.seed + 99)
    if sys_lr_int8:
        t_int8 = time.time()
        int8 = {}
        for name, lr_embed in sys_lr_int8.items():
            e_lr = _embed_arrays(lr_embed, p1, h.eval_batch)
            ver = evaluate_verification(e_lr, e_hr, issame, n_folds=8, far_targets=(1e-2,),
                                        device=dev)
            pe = _embed_arrays(lr_embed, probe_imgs, h.eval_batch)
            _, top_l = topk_matches(pe, g_emb, gal_ids, k=5, device=dev)
            r1_hits, _ = _rank_from_topk(top_l, probe_ids, 5)
            int8[name] = {"verification_acc": float(ver.accuracy_mean),
                          "rank1": float(np.mean(r1_hits))}
        out["int8"] = int8
        if timings is not None:
            timings["int8_eval_s"] = round(time.time() - t_int8, 1)
    return out


def run_headline(h: HeadlineCfg, device=None) -> dict:
    """Run every stage on ``device`` (CUDA unless the caller asks for the
    CPU); returns the table, also written to ``out_dir/headline.json``."""
    from crfr_torch.data.render import RenderedIdentities

    dev = resolve_device("cuda" if device is None else device)
    os.makedirs(h.out_dir, exist_ok=True)
    t0 = time.time()
    n_ids = h.ids_train + h.ids_eval + h.ids_distract
    renderer = RenderedIdentities(n_ids, image_size=h.image_size, seed=h.seed, hard=h.hard)
    eval_range = (h.ids_train, h.ids_train + h.ids_eval)
    distract_range = (h.ids_train + h.ids_eval, n_ids)

    # stage 1: the fixed training set (uint8 in host memory) and the
    # landmarks that supervise the SR prior estimator
    rng = np.random.default_rng(h.seed + 10)
    train_ids = np.tile(np.arange(h.ids_train), h.samples_per_id)
    imgs = np.empty((len(train_ids), h.image_size, h.image_size, 3), np.uint8)
    lms = np.empty((len(train_ids), 5, 2), np.float32)
    for i in range(0, len(train_ids), 256):
        chunk, lm = renderer.sample_for_ids(rng, train_ids[i:i + 256], return_landmarks=True)
        imgs[i:i + 256] = chunk.astype(np.uint8)
        lms[i:i + 256] = lm
    labels = train_ids.astype(np.int32)
    stages = {"render_s": round(time.time() - t0, 1), "n_train_imgs": len(imgs)}

    # stage 2: the HR teacher
    t1 = time.time()
    teacher_tr, t_loss = _train_teacher(h, imgs, labels, h.ids_train, dev)
    stages["teacher"] = {"loss": t_loss, "s": round(time.time() - t1, 1)}

    results = {}
    for probe in h.probe_sizes:
        # stage 3: the prior-aided SR GAN at this probe size
        t1 = time.time()
        sr_tr, sr_m = _train_sr(h, teacher_tr, imgs, probe, lms=lms, device=dev)
        sr_m["s"] = round(time.time() - t1, 1)
        stages[f"sr{probe}"] = sr_m
        sr_apply = sr_tr.sr_apply(ema=True)
        del sr_tr

        # stages 4 and 5: the KD students on hallucinated and bicubic input
        t1 = time.time()
        st_sr, l_sr = _train_student(h, teacher_tr, imgs, labels, h.ids_train, probe,
                                     sr_fn=sr_apply, device=dev)
        st_bic, l_bic = _train_student(h, teacher_tr, imgs, labels, h.ids_train, probe,
                                       sr_fn=None, device=dev)
        stages[f"students{probe}"] = {"loss_sr": l_sr, "loss_bic": l_bic,
                                      "s": round(time.time() - t1, 1)}

        # stage 6: cross-resolution eval with paired bootstrap CIs, and the
        # int8 twins when int8_eval is on
        t1 = time.time()
        students = {"student_sr": st_sr, "student_bic": st_bic}
        hr_embed, sys_lr = _probe_embedders(h, teacher_tr, students, sr_apply, probe, dev)
        int8_t, sys_int8 = {}, None
        if h.int8_eval:
            t2 = time.time()
            sys_int8 = _int8_probe_embedders(h, teacher_tr, students, sr_apply, probe,
                                             imgs[:2 * h.eval_batch], dev)
            int8_t["quantize_s"] = round(time.time() - t2, 1)
        results[str(probe)] = _evaluate_probe(
            h, renderer, hr_embed, sys_lr, eval_range, distract_range,
            np.random.default_rng(h.seed + 20 + probe), dev, sys_lr_int8=sys_int8,
            timings=int8_t)
        results[str(probe)]["eval_s"] = round(time.time() - t1, 1)
        if int8_t:
            stages[f"int8_{probe}"] = int8_t
        del students, st_sr, st_bic, sys_lr, sys_int8
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    table = {"cfg": dataclasses.asdict(h), "stages": stages,
             "results": results, "total_s": round(time.time() - t0, 1)}
    with open(os.path.join(h.out_dir, "headline.json"), "w") as f:
        json.dump(table, f, indent=1)
    return table


def run_headline_seeds(h: HeadlineCfg, n_seeds: int, device=None) -> dict:
    """Seed replicates of the whole experiment: replicate k re-renders,
    re-trains and re-evaluates with ``seed + 1000·k`` under
    ``out_dir/seed{k}``. Aggregates mean ± std per (probe, system, metric)
    and the per-seed ordering verdicts into ``out_dir/headline_seeds.json``."""
    t0 = time.time()
    tables = []
    for k in range(n_seeds):
        hk = dataclasses.replace(h, seed=h.seed + 1000 * k,
                                 out_dir=os.path.join(h.out_dir, f"seed{k}"))
        tables.append(run_headline(hk, device))
    systems = ("teacher_lr", "student_bic", "student_sr")
    metrics = ("verification_acc", "rank1", "cmc5", "tpir_at_fpir0.1")
    agg: dict = {}
    for probe in h.probe_sizes:
        p = str(probe)
        agg[p] = {}
        for sysname in systems:
            agg[p][sysname] = {}
            for metric in metrics:
                vals = [t["results"][p][sysname][metric] for t in tables]
                agg[p][sysname][metric] = {
                    "mean": round(float(np.mean(vals)), 4),
                    "std": round(float(np.std(vals)), 4),
                    "vals": [round(float(v), 4) for v in vals]}
        agg[p]["ordering_per_seed"] = {
            m: [ordering_holds(t, probe, m) for t in tables]
            for m in ("verification_acc", "rank1")}
    out = {"n_seeds": n_seeds, "cfg": dataclasses.asdict(h),
           "aggregate": agg,
           "per_seed": [t["results"] for t in tables],
           "total_s": round(time.time() - t0, 1)}
    os.makedirs(h.out_dir, exist_ok=True)
    with open(os.path.join(h.out_dir, "headline_seeds.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def ordering_holds(table: dict, probe: int, metric: str = "verification_acc") -> bool:
    """The paper's claim at one probe size: student_sr ≥ student_bic ≥
    teacher_lr with a strict gap end to end."""
    r = table["results"][str(probe)]
    a, b, c = (r["student_sr"][metric], r["student_bic"][metric],
               r["teacher_lr"][metric])
    return a >= b >= c and a > c

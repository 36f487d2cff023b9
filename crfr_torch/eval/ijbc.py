"""IJB-C template-based evaluation: 1:1 verification and 1:N identification
(crfr/eval/ijbc.py).

- A template is a set of stills and frames of one subject. Pooling is
  media-aware: embeddings are averaged within each media first, the media
  means are averaged, and the result is L2-normalized.
- 1:1: cosine similarity over template pairs; TAR@FAR computed exactly from
  the sorted impostor scores (no threshold grid).
- 1:N: probe templates against each of the two gallery splits; closed-set
  rank-k/CMC and open-set TPIR@FPIR through ``eval.identification``, so a
  ``QuantBank`` gallery reaches the int8 scan or the ``bank_tilemax`` kernel.

Pooling is two ``index_add_`` segment sums on the device. Entry points run on
``device``, by default the embeddings' own device when they are a tensor,
else CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from crfr_torch.device import device_of
from crfr_torch.eval.identification import (_as_tensor, closed_set_identification,
                                            open_set_identification)


def _segment_mean(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    total = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    total.index_add_(0, seg, x)
    count = torch.bincount(seg, minlength=n).to(torch.float32)[:, None]
    return total / count.clamp(min=1.0)


def pool_templates(embs, media_seg, template_of_media, n_media: int, n_templates: int,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Media-aware template pooling. ``embs`` (N, D) image embeddings,
    ``media_seg`` (N,) dense media index per image, ``template_of_media``
    (M,) dense template index per media → (T, D) L2-normalized template
    embeddings on the device."""
    dev = device_of(embs, device)
    e = _as_tensor(embs, dev, torch.float32)
    media_mean = _segment_mean(e, _as_tensor(media_seg, dev, torch.int64), n_media)
    tpl = _segment_mean(media_mean, _as_tensor(template_of_media, dev, torch.int64),
                        n_templates)
    return tpl / torch.linalg.vector_norm(tpl, dim=-1, keepdim=True).clamp(min=1e-12)


def make_template_index(template_ids: np.ndarray, media_ids: np.ndarray):
    """Dense-index the (template, media) structure of an image list.
    → (media_seg (N,), template_of_media (M,), template_uids (T,))."""
    pair = np.stack([template_ids, media_ids], axis=1)
    uniq_media, media_seg = np.unique(pair, axis=0, return_inverse=True)
    tpl_uids, template_of_media = np.unique(uniq_media[:, 0], return_inverse=True)
    return (media_seg.astype(np.int32), template_of_media.astype(np.int32), tpl_uids)


def _pair_scores(tpl_embs: torch.Tensor, idx1: torch.Tensor,
                 idx2: torch.Tensor) -> torch.Tensor:
    return (tpl_embs[idx1] * tpl_embs[idx2]).sum(dim=-1)


def tar_at_far_exact(scores: np.ndarray, issame: np.ndarray,
                     far_targets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)) -> dict[float, float]:
    """Exact TAR@FAR from impostor-score quantiles (no grid)."""
    scores = np.asarray(scores)
    issame = np.asarray(issame, bool)
    pos = scores[issame]
    neg = np.sort(scores[~issame])[::-1]
    out = {}
    for tgt in far_targets:
        # accept exactly k = floor(tgt·n) impostors: thr = (k+1)-th largest
        # impostor score, strict '>' acceptance; k ≥ n → thr = −inf
        k = int(np.floor(tgt * len(neg)))
        thr = -np.inf if len(neg) == 0 or k >= len(neg) else neg[k]
        out[float(tgt)] = float((pos > thr).mean()) if len(pos) else 0.0
    return out


@dataclass
class IJBCResult:
    tar_at_far: dict[float, float]               # 1:1
    rank1: float | None = None                   # 1:N closed
    cmc: np.ndarray | None = None
    tpir_at_fpir: dict[float, float] | None = None


def _pool(image_embs, template_ids, media_ids, device):
    media_seg, tpl_of_media, tpl_uids = make_template_index(np.asarray(template_ids),
                                                            np.asarray(media_ids))
    tpl = pool_templates(image_embs, media_seg, tpl_of_media, int(media_seg.max()) + 1,
                         len(tpl_uids), device=device)
    return tpl, tpl_uids


def ijbc_11(image_embs, template_ids, media_ids, pair_t1, pair_t2, pair_label,
            far_targets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1), block: int = 1 << 20,
            device: str | torch.device | None = None) -> IJBCResult:
    """1:1 verification. ``pair_t1``/``pair_t2`` hold original template ids;
    ``pair_label`` (P,) 1 for genuine. Scores in blocks of ``block`` pairs."""
    tpl, tpl_uids = _pool(image_embs, template_ids, media_ids, device)
    lut = {t: i for i, t in enumerate(tpl_uids)}
    i1 = torch.as_tensor([lut[t] for t in np.asarray(pair_t1)], dtype=torch.int64)
    i2 = torch.as_tensor([lut[t] for t in np.asarray(pair_t2)], dtype=torch.int64)
    scores = np.empty(len(i1), np.float32)
    for s in range(0, len(i1), block):
        e = min(s + block, len(i1))
        scores[s:e] = _pair_scores(tpl, i1[s:e].to(tpl.device),
                                   i2[s:e].to(tpl.device)).cpu().numpy()
    return IJBCResult(tar_at_far=tar_at_far_exact(scores, pair_label, far_targets))


def pool_meta(image_embs, template_ids, media_ids, subject_ids,
              device: str | torch.device | None = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pool one meta-list of image embeddings into templates.
    → (tpl_embs (T, D) f32 normalized, tpl_subjects (T,), tpl_uids (T,))."""
    subject_ids = np.asarray(subject_ids)
    tpl, tpl_uids = _pool(image_embs, template_ids, media_ids, device)
    # subject of each template = subject of any of its images (consistent)
    subj_of_tpl = np.empty(len(tpl_uids), subject_ids.dtype)
    lut = {t: i for i, t in enumerate(tpl_uids)}
    for t, s in zip(np.asarray(template_ids), subject_ids):
        subj_of_tpl[lut[t]] = s
    return tpl.cpu().numpy(), subj_of_tpl, tpl_uids


def ijbc_1n_two_gallery(probe_embs, probe_subjects, g1_embs, g1_subjects, g2_embs,
                        g2_subjects, fpir_targets=(1e-2, 1e-1), max_rank: int = 20,
                        mesh=None, block: int = 0, approx: bool = False,
                        device: str | torch.device | None = None
                        ) -> tuple[IJBCResult, IJBCResult, IJBCResult]:
    """Standard IJB-C 1:N: the probes against each of the two disjoint
    gallery splits (G1, G2), and their average. → (avg, g1, g2)."""
    r1 = ijbc_1n(probe_embs, probe_subjects, g1_embs, g1_subjects, fpir_targets,
                 max_rank, mesh=mesh, block=block, approx=approx, device=device)
    r2 = ijbc_1n(probe_embs, probe_subjects, g2_embs, g2_subjects, fpir_targets,
                 max_rank, mesh=mesh, block=block, approx=approx, device=device)
    avg = IJBCResult(
        tar_at_far={},
        rank1=0.5 * (r1.rank1 + r2.rank1),
        cmc=0.5 * (np.asarray(r1.cmc) + np.asarray(r2.cmc)),
        tpir_at_fpir={k: 0.5 * (r1.tpir_at_fpir[k] + r2.tpir_at_fpir[k])
                      for k in r1.tpir_at_fpir})
    return avg, r1, r2


def ijbc_1n(probe_embs, probe_subjects, gallery_embs, gallery_subjects,
            fpir_targets=(1e-2, 1e-1), max_rank: int = 20, mesh=None, block: int = 0,
            approx: bool = False, device: str | torch.device | None = None) -> IJBCResult:
    """1:N from pooled template embeddings. Open-set TPIR@FPIR counts probes
    whose subject is absent from the gallery as unmated."""
    probe_subjects = np.asarray(probe_subjects)
    gallery_subjects = np.asarray(gallery_subjects)
    mated = np.isin(probe_subjects, gallery_subjects)
    mated_rows = (probe_embs[torch.from_numpy(mated).to(probe_embs.device)]
                  if isinstance(probe_embs, torch.Tensor) else np.asarray(probe_embs)[mated])
    closed = closed_set_identification(
        mated_rows, gallery_embs, probe_subjects[mated], gallery_subjects,
        max_rank=max_rank, mesh=mesh, block=block, approx=approx, device=device)
    open_res = open_set_identification(
        probe_embs, gallery_embs, probe_subjects, gallery_subjects, mated,
        fpir_targets=fpir_targets, max_rank=max_rank, mesh=mesh, block=block,
        approx=approx, device=device)
    return IJBCResult(tar_at_far={}, rank1=closed.rank1, cmc=closed.cmc,
                      tpir_at_fpir=open_res.tpir_at_fpir)

"""Verification evaluation: the LFW-style 10-fold protocol as tensor ops on
the device (crfr/eval/verification.py).

- distance d = 2 − 2·cosθ of L2-normalized embeddings (norms clipped at 1e-12);
- contiguous KFold(shuffle=False) folds; 400 thresholds on [0, 4]; per fold,
  the threshold of best train accuracy (the first on ties), accuracy on the
  held-out fold;
- TAR@FAR: the threshold reaching the target FAR on the train folds,
  interpolated on the FAR curve, then TAR and FAR on the test fold at it.

All thresholds × all pairs evaluate as one (T, N) comparison. Results equal
the reference's on the same distances: the thresholds are the same float32
values, the counts are exact, and ``interp`` follows ``jnp.interp`` step by
step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from crfr_torch.device import resolve_device


@dataclass
class VerificationResult:
    accuracy_mean: float
    accuracy_std: float
    best_thresholds: np.ndarray          # (n_folds,) distance thresholds
    tar_at_far: dict[float, float]       # target FAR → measured TAR
    fold_accuracies: np.ndarray
    eer: float = float("nan")            # equal-error rate (global, no folds)


def compute_eer(dist: np.ndarray, issame: np.ndarray) -> float:
    """Equal-error rate: the operating point where FAR == FRR, on the sorted
    genuine/impostor distance distributions (host numpy, as the reference)."""
    dist = np.asarray(dist)
    issame = np.asarray(issame, bool)
    pos = np.sort(dist[issame])          # genuine distances (small = accept)
    neg = np.sort(dist[~issame])
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    vals = np.unique(np.concatenate([pos, neg]))
    # candidate thresholds BETWEEN observed values (accept iff d < t), plus
    # the outer extremes — otherwise separated distributions miss the gap.
    ts = np.concatenate([[vals[0] - 1], (vals[:-1] + vals[1:]) / 2,
                         [vals[-1] + 1]])
    frr = 1.0 - np.searchsorted(pos, ts, "left") / len(pos)
    far = np.searchsorted(neg, ts, "right") / len(neg)  # accepted impostors
    k = np.argmin(np.abs(far - frr))
    return float((far[k] + frr[k]) / 2)


def fuse_flip_features(emb: torch.Tensor, emb_flip: torch.Tensor,
                       mode: str = "sum") -> torch.Tensor:
    """Flip-TTA fusion: 'sum' (insightface convention) or 'concat'."""
    if mode == "sum":
        return emb + emb_flip
    if mode == "concat":
        return torch.cat([emb, emb_flip], dim=-1)
    raise ValueError(f"unknown flip fusion {mode!r}")


def _normalized(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def pair_distances(emb1: torch.Tensor, emb2: torch.Tensor) -> torch.Tensor:
    """d = 2 − 2·cos for each pair; (N,) f32."""
    cos = torch.sum(_normalized(emb1) * _normalized(emb2), dim=-1)
    return 2.0 - 2.0 * cos


def _fold_masks(n: int, n_folds: int) -> np.ndarray:
    """(n_folds, n) boolean — contiguous KFold(shuffle=False) test masks."""
    sizes = np.full(n_folds, n // n_folds)
    sizes[: n % n_folds] += 1
    masks = np.zeros((n_folds, n), dtype=bool)
    start = 0
    for i, s in enumerate(sizes):
        masks[i, start:start + s] = True
        start += s
    return masks


def _thresholds(n: int) -> np.ndarray:
    """``jnp.linspace(0, 4, n)`` as XLA computes it, value for value:
    0·(1−s) + 4·s with s = i · float32(1/(n−1)) (XLA turns the division by
    the constant into a product with its reciprocal); both products with
    0 and 4 are exact, so the sum is."""
    step = np.arange(n - 1, dtype=np.float32) * (np.float32(1) / np.float32(n - 1))
    return np.concatenate([np.float32(4.0) * step, [np.float32(4.0)]]).astype(np.float32)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.interp``: x (R, K), xp and fp (R, T), xp rows
    nondecreasing. Constant beyond both ends; on a zero-width interval
    (|dx| ≤ spacing(eps)) the left value, as jnp.interp returns."""
    n = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, n - 1)
    xp0, xp1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    fp0, fp1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = x - xp0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp0, fp0 + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def _protocol(dist: torch.Tensor, issame: torch.Tensor, fold_masks: torch.Tensor,
              far_targets: torch.Tensor, n_thresholds: int = 400):
    """dist (N,) f32, issame (N,) bool, fold_masks (F, N) bool test masks.
    Returns fold_accs (F,), best_thr (F,), tar (F, K), far_reached (F, K)."""
    dev = dist.device
    thresholds = torch.from_numpy(_thresholds(n_thresholds)).to(dev)
    pred = dist[None, :] < thresholds[:, None]             # (T, N) "same" calls
    same = issame[None, :]
    correct = (pred == same).float()
    test_m = fold_masks.float()                            # (F, N)
    train_m = 1.0 - test_m
    n_test = test_m.sum(dim=1)
    n_train = train_m.sum(dim=1)

    # (F, T) counts are integers below 2^24: exact in f32 in any order
    train_acc = (train_m @ correct.t()) / n_train[:, None]
    best_idx = torch.argmax(train_acc, dim=1)             # first maximum
    best_thr = thresholds[best_idx]
    test_acc = (test_m @ correct.t()) / n_test[:, None]
    fold_acc = torch.gather(test_acc, 1, best_idx[:, None])[:, 0]

    fp_pairs = (pred & ~same).float()
    tp_pairs = (pred & same).float()
    pos = issame.float()
    neg = 1.0 - pos
    far_train = (train_m @ fp_pairs.t()) / (train_m @ neg).clamp(min=1.0)[:, None]
    fp_te = test_m @ fp_pairs.t()
    tp_te = test_m @ tp_pairs.t()
    npos_test = (test_m @ pos).clamp(min=1.0)
    nneg_test = (test_m @ neg).clamp(min=1.0)

    f, k = fold_masks.shape[0], far_targets.shape[0]
    thr_rows = thresholds.expand(f, -1)
    thr = interp(far_targets.expand(f, k), far_train, thr_rows)   # (F, K)
    tar = interp(thr, thr_rows, tp_te) / npos_test[:, None]
    far_reached = interp(thr, thr_rows, fp_te) / nneg_test[:, None]
    return fold_acc, best_thr, tar, far_reached


def evaluate_distances(dist, issame, n_folds: int = 10, far_targets=(1e-3, 1e-2),
                       device: str | torch.device = "cuda") -> VerificationResult:
    """The protocol on precomputed pair distances (N,), on ``device``."""
    dev = resolve_device(device)
    dist = torch.as_tensor(dist, dtype=torch.float32).to(dev)
    issame_t = torch.as_tensor(np.asarray(issame, bool)).to(dev)
    masks = torch.from_numpy(_fold_masks(dist.shape[0], n_folds)).to(dev)
    fa, thr, tar, _ = _protocol(dist, issame_t, masks,
                                torch.tensor(far_targets, dtype=torch.float32, device=dev))
    fa = fa.cpu().numpy()
    tar = tar.cpu().numpy()                                # (F, K)
    return VerificationResult(
        accuracy_mean=float(fa.mean()),
        accuracy_std=float(fa.std()),
        best_thresholds=thr.cpu().numpy(),
        tar_at_far={float(t): float(tar[:, i].mean())
                    for i, t in enumerate(far_targets)},
        fold_accuracies=fa,
        eer=compute_eer(dist.cpu().numpy(), np.asarray(issame, bool)),
    )


def evaluate_verification(emb1, emb2, issame, n_folds: int = 10,
                          far_targets=(1e-3, 1e-2),
                          device: str | torch.device = "cuda") -> VerificationResult:
    """Full verification protocol from pair embeddings (N, D), already
    flip-fused if desired; issame (N,) bool."""
    dev = resolve_device(device)
    dist = pair_distances(torch.as_tensor(emb1).to(dev), torch.as_tensor(emb2).to(dev))
    return evaluate_distances(dist, issame, n_folds, far_targets, dev)

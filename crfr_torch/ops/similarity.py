"""5-point similarity solve for face alignment (crfr/ops/similarity.py).

The least-squares similarity transform (rotation, uniform scale,
translation: 4 degrees of freedom) that maps the detected eye, eye, nose
and mouth-corner landmarks onto the canonical 112×112 template, as MATLAB's
``cp2tform('nonreflective similarity')`` finds it. Centring the points
makes the normal equations diagonal, so the solve is closed-form and exact
in float32 at any landmark magnitude.

Every function takes tensors with any leading batch dimensions, ``(..., N,
2)`` points → ``(..., 2, 3)`` forward matrices, so ``align_matrix_batch`` is
the same code over a (B, 5, 2) batch, on whatever device the landmarks lie.
``allow_reflection=True`` also solves with the x-mirrored source and keeps
the chirality that fits better (MATLAB's ``findSimilarity``), without a
branch. ``umeyama_transform`` is the SVD form (skimage's
``SimilarityTransform.estimate``), kept as an independent formulation.
"""

from __future__ import annotations

import numpy as np
import torch

# Canonical 5-point template for a 112×112 crop (insightface/ArcFace
# convention); the 96×112 variant is the same minus the 8 px x-offset.
REFERENCE_LANDMARKS_112 = np.array(
    [
        [38.2946, 51.6963],   # left eye
        [73.5318, 51.5014],   # right eye
        [56.0252, 71.7366],   # nose tip
        [41.5493, 92.3655],   # left mouth corner
        [70.7299, 92.2041],   # right mouth corner
    ],
    dtype=np.float32,
)

REFERENCE_LANDMARKS_96x112 = REFERENCE_LANDMARKS_112 - np.array([8.0, 0.0], np.float32)


def _as_f32(a, device: torch.device | None = None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _solve_nonreflective(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """LSQ [a, b, tx, ty] with u = a·x − b·y + tx, v = b·x + a·y + ty:
    the forward matrix [[a, −b, tx], [b, a, ty]]."""
    mu_s, mu_d = src.mean(-2), dst.mean(-2)
    ps, pd = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    x, y, u, v = ps[..., 0], ps[..., 1], pd[..., 0], pd[..., 1]
    denom = (x * x + y * y).sum(-1)
    a = (x * u + y * v).sum(-1) / denom
    b = (x * v - y * u).sum(-1) / denom
    m = torch.stack([torch.stack([a, -b], -1), torch.stack([b, a], -1)], -2)
    t = mu_d - (m @ mu_s[..., None])[..., 0]
    return torch.cat([m, t[..., None]], -1)


def _apply(mat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ mat[..., :2].transpose(-1, -2) + mat[..., None, :, 2]


def similarity_transform(src, dst, allow_reflection: bool = False) -> torch.Tensor:
    """Forward (..., 2, 3) similarity matrix mapping ``src`` (..., N, 2) onto
    ``dst`` (N, 2) or (..., N, 2), on ``src``'s device."""
    src = _as_f32(src)
    dst = _as_f32(dst, src.device)
    m1 = _solve_nonreflective(src, dst)
    if not allow_reflection:
        return m1
    mirror = torch.tensor([-1.0, 1.0], device=src.device)
    m2 = _solve_nonreflective(src * mirror, dst)
    # undo the mirroring: compose with diag(-1, 1) on the input side
    m2 = torch.cat([-m2[..., :1], m2[..., 1:]], -1)
    r1 = ((_apply(m1, src) - dst) ** 2).sum((-1, -2))
    r2 = ((_apply(m2, src) - dst) ** 2).sum((-1, -2))
    return torch.where((r1 <= r2)[..., None, None], m1, m2)


def umeyama_transform(src, dst) -> torch.Tensor:
    """Umeyama's similarity estimate (the SVD form). For non-degenerate 2-D
    landmark sets it equals ``similarity_transform``."""
    src = _as_f32(src)
    dst = _as_f32(dst, src.device)
    n = src.shape[-2]
    mu_s, mu_d = src.mean(-2), dst.mean(-2)
    sc, dc = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    cov = dc.transpose(-1, -2) @ sc / n
    u, s, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.stack([torch.ones_like(d), d], -1)
    r = (u * diag[..., None, :]) @ vt
    var_s = (sc ** 2).sum((-1, -2)) / n
    scale = (s * diag).sum(-1) / var_s
    t = mu_d - scale[..., None] * (r @ mu_s[..., None])[..., 0]
    return torch.cat([scale[..., None, None] * r, t[..., None]], -1)


def invert_affine(mat) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices (for inverse-map warping)."""
    mat = _as_f32(mat)
    ainv = torch.linalg.inv(mat[..., :2])
    return torch.cat([ainv, -(ainv @ mat[..., 2:])], -1)


def align_matrix(landmarks, template=None, allow_reflection: bool = False) -> torch.Tensor:
    """Alignment matrix of (..., 5, 2) landmarks onto ``template`` (the
    112×112 one when None)."""
    if template is None:
        template = REFERENCE_LANDMARKS_112
    return similarity_transform(landmarks, template, allow_reflection)


def align_matrix_batch(landmarks, template=None, allow_reflection: bool = False) -> torch.Tensor:
    """(B, 5, 2) landmarks → (B, 2, 3) matrices, one batched solve."""
    landmarks = _as_f32(landmarks)
    if landmarks.ndim != 3:
        raise ValueError(f"expected (B, N, 2) landmarks, got {tuple(landmarks.shape)}")
    return align_matrix(landmarks, template, allow_reflection)

"""Prior targets for the hallucination stage (crfr/ops/heatmaps.py): a
unit-peak Gaussian heatmap per landmark and 11 soft face-parsing maps
(skin, brows, eyes, nose, lips, inner mouth, hair, background) drawn as
soft ellipses in a frame rotated by the eye line and scaled by the eye
distance, from 5-point landmarks.

Plain batched tensor code, on the landmarks' own device: the SR trainer
builds the targets inside its step on the card, from landmarks (B, 5, 2)
in pixel coordinates.
"""

from __future__ import annotations

import torch

# (name, anchor, dx, dy, rx, ry) per parsing channel, in eye-distance units
# in the face-aligned frame; anchors 0..4 are the landmarks (le, re, nose,
# lmouth, rmouth), 5 the mouth's midpoint
_PARSE_SPECS = (
    ("skin",    2, 0.0, -0.25, 1.10, 0.95),
    ("l_brow",  0, 0.0, -0.25, 0.30, 0.10),
    ("r_brow",  1, 0.0, -0.25, 0.30, 0.10),
    ("l_eye",   0, 0.0,  0.00, 0.25, 0.12),
    ("r_eye",   1, 0.0,  0.00, 0.25, 0.12),
    ("nose",    2, 0.0, -0.05, 0.22, 0.35),
    ("u_lip",   5, 0.0, -0.06, 0.50, 0.08),
    ("l_lip",   5, 0.0,  0.10, 0.50, 0.10),
    ("mouth",   5, 0.0,  0.02, 0.42, 0.06),
)
_HAIR_SPEC = (2, 0.0, -1.30, 1.05, 0.50)     # a band above the hairline
PARSING_LABELS = tuple(s[0] for s in _PARSE_SPECS) + ("hair", "background")


def _flat(landmarks: torch.Tensor) -> torch.Tensor:
    return landmarks.reshape((-1,) + tuple(landmarks.shape[-2:])).to(torch.float32)


def landmark_heatmaps(landmarks: torch.Tensor, size: int = 112,
                      sigma: float = 3.0) -> torch.Tensor:
    """landmarks (..., K, 2) in pixel coordinates → (..., size, size, K)."""
    lm = _flat(landmarks)                                        # (N, K, 2)
    grid = torch.arange(size, dtype=torch.float32, device=lm.device)
    dx = grid[None, None, None, :] - lm[:, :, 0, None, None]     # (N, K, 1, S)
    dy = grid[None, None, :, None] - lm[:, :, 1, None, None]     # (N, K, S, 1)
    h = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))  # (N, K, S, S)
    return h.permute(0, 2, 3, 1).reshape(
        tuple(landmarks.shape[:-2]) + (size, size, landmarks.shape[-2]))


def parsing_maps(landmarks: torch.Tensor, size: int = 112,
                 sharpness: float = 8.0) -> torch.Tensor:
    """landmarks (..., 5, 2) → (..., size, size, 11) soft parsing maps in
    [0, 1], channels in ``PARSING_LABELS`` order."""
    if landmarks.shape[-2] != 5:
        raise ValueError(f"parsing maps need 5-point landmarks, got {landmarks.shape[-2]}")
    lm = _flat(landmarks)                                        # (N, 5, 2)
    grid = torch.arange(size, dtype=torch.float32, device=lm.device)
    le, re = lm[:, 0], lm[:, 1]
    ed = torch.linalg.vector_norm(re - le, dim=-1).clamp_min(1e-3)
    ang = torch.atan2(re[:, 1] - le[:, 1], re[:, 0] - le[:, 0])
    c, s = torch.cos(ang), torch.sin(ang)
    anchors = torch.cat([lm, lm[:, 3:5].mean(1, keepdim=True)], dim=1)    # (N, 6, 2)

    specs = [spec[1:] for spec in _PARSE_SPECS] + [_HAIR_SPEC]
    idx = torch.tensor([a for a, *_ in specs], device=lm.device)
    dx, dy, rx, ry = (torch.tensor(col, dtype=torch.float32, device=lm.device)[None, :, None, None]
                      for col in list(zip(*specs))[1:])
    ctr = anchors[:, idx]                                        # (N, E, 2)
    px = grid[None, None, None, :] - ctr[:, :, 0, None, None]    # (N, E, 1, S)
    py = grid[None, None, :, None] - ctr[:, :, 1, None, None]    # (N, E, S, 1)
    c, s, ed = (t[:, None, None, None] for t in (c, s, ed))
    u = (c * px + s * py) / ed - dx
    v = (-s * px + c * py) / ed - dy
    d2 = torch.square(u / rx) + torch.square(v / ry)
    ell = torch.sigmoid(sharpness * (1.0 - d2))                  # (N, E, S, S)
    regions = ell[:, :len(_PARSE_SPECS)]
    hair = ell[:, -1:] * (1.0 - regions[:, :1])                  # gated off the face oval
    fg = torch.cat([regions, hair], dim=1).amax(dim=1, keepdim=True)
    out = torch.cat([regions, hair, 1.0 - fg], dim=1)            # (N, 11, S, S)
    return out.permute(0, 2, 3, 1).reshape(
        tuple(landmarks.shape[:-2]) + (size, size, len(PARSING_LABELS)))


def prior_targets(landmarks: torch.Tensor, size: int = 112, sigma: float = 3.0,
                  sharpness: float = 8.0) -> torch.Tensor:
    """5 landmark heatmaps ++ 11 parsing maps: (..., size, size, 16), every
    channel of the default ``PriorEstimator(n_priors=16)``."""
    return torch.cat([landmark_heatmaps(landmarks, size, sigma),
                      parsing_maps(landmarks, size, sharpness)], dim=-1)


def prior_target_fn(landmarks: torch.Tensor, size: int = 112, sigma: float = 3.0,
                    include_parsing: bool = True):
    """Close over one batch's landmarks → ``prior_target_fn(hr_images)`` for
    ``SRTrainer`` (the images are ignored; the targets come from the
    landmarks)."""
    maps = (prior_targets(landmarks, size, sigma) if include_parsing
            else landmark_heatmaps(landmarks, size, sigma))

    def f(_hr_images):
        return maps

    return f

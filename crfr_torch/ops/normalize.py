"""Pixel normalization: (x − 127.5) / 128, mapping uint8 RGB into ≈[−1, 1]
(the insightface/face.evoLVe convention; crfr/ops/normalize.py)."""

from __future__ import annotations

import torch

MEAN = 127.5
STD = 128.0


def normalize(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return ((x.to(torch.float32) - MEAN) * (1.0 / STD)).to(dtype)


def denormalize(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * STD + MEAN

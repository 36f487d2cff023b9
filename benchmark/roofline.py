"""The yardstick's arithmetic: the model's FLOPs, each kernel's operations and
bytes, and the card's published peaks.

FLOPs are the model's, two per multiply-add, with nothing padded or
recomputed: each convolution is a GEMM of M = B * Ho * Wo rows, K = kh * kw
* Cin and N = Cout, and the embedding layer one of M = B, K = 512 * (S/16)^2,
N = D. A train step counts three such products a layer (forward, input
gradient, weight gradient) and the head's three GEMMs of B x D x C.

A preprocessing call's bound counts the work of the function, whatever
implements it: its input pixels read once, its output written once at the
compute dtype, each image's low read once where there is one per image, and
the bicubic taps of a separable degrade (down the rows, down the columns, up
the columns, up the rows: (S + low) * (taps down + taps up) multiply-adds a
plane) plus the two operations of the normalization an output value. Band
and operator tables are the implementation's and do not count.

Peaks: NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet, dense: bf16 989.4
TFLOP/s, float32 outside the tensor cores 66.9 TFLOP/s, HBM 3.35 TB/s.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference.bicubic import resize_matrix
from benchmark.reference.irse import units

HBM_BW = 3.35e12
PEAK_BF16 = 989.4e12
PEAK_F32 = 66.9e12


def _convs(backbone: str, input_size: int):
    """(h, cin, cout, k, stride) of every convolution, in order."""
    out = [(input_size, 3, 64, 3, 1)]
    h = input_size
    for cin, cout, stride in units(backbone):
        out.append((h, cin, cout, 3, 1))
        out.append((h, cout, cout, 3, stride))
        if cin != cout or stride != 1:
            out.append((h, cin, cout, 1, stride))
        h //= stride
    return out


def forward_flops(backbone: str, batch: int, input_size: int = 112,
                  embedding_dim: int = 512) -> float:
    """The backbone's forward convolutions and embedding GEMM."""
    total = 0.0
    for h, cin, cout, k, stride in _convs(backbone, input_size):
        ho = h // stride
        total += 2.0 * batch * ho * ho * k * k * cin * cout
    feat = input_size // 16
    return total + 2.0 * batch * 512 * feat * feat * embedding_dim


def head_flops(batch: int, embedding_dim: int, classes: int) -> float:
    """The head's forward, input-gradient and weight-gradient GEMMs."""
    return 3 * 2.0 * batch * embedding_dim * classes


def train_flops(backbone: str, batch: int, classes: int, input_size: int = 112,
                embedding_dim: int = 512) -> float:
    return (3 * forward_flops(backbone, batch, input_size, embedding_dim)
            + head_flops(batch, embedding_dim, classes))


@functools.lru_cache(maxsize=None)
def _taps(size: int, low: int, mode: str) -> int:
    return int(np.count_nonzero(resize_matrix(size, low, mode))
               + np.count_nonzero(resize_matrix(low, size, mode)))


def degrade_work(size: int, lows, channels: int = 3, mode: str = "pil", in_bytes: int = 1,
                 out_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of degrading and normalizing a batch of
    (B, size, size, channels) images, each to its own low (``lows``, one
    int per image, read from a (B,) int32 array)."""
    lows = np.asarray(lows).reshape(-1)
    plane = size * size
    ops = channels * sum(2.0 * (size + int(low)) * _taps(size, int(low), mode) + 2.0 * plane
                         for low in lows)
    return ops, float(lows.size * (plane * channels * (in_bytes + out_bytes) + 4))


def degrade_work_int(batch: int, size: int, low: int, channels: int = 3, mode: str = "pil",
                     in_bytes: int = 1, out_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of a batch degraded to one ``low``."""
    plane = size * size
    ops = batch * channels * (2.0 * (size + low) * _taps(size, low, mode) + 2.0 * plane)
    return ops, float(batch * plane * channels * (in_bytes + out_bytes))


def bound_s(ops: float, byts: float, peak: float = PEAK_F32) -> float:
    """The least time: the larger of operations over peak and bytes over HBM."""
    return max(ops / peak, byts / HBM_BW)

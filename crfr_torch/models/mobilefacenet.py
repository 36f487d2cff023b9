"""MobileFaceNet backbone (crfr/models/mobilefacenet.py) in PyTorch: the
lightweight embedding model of the reference family.

Inverted-residual bottlenecks with depthwise 3×3 convolutions (``groups``
= channels), a global depthwise conv over the 7×7 map (GDConv) in place of
pooling, a linear layer without bias to the embedding, BN everywhere. Stage
table (t = expansion, c = out channels, n = repeats, s = stride):

    (2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1), (4, 128, 1, 2), (2, 128, 2, 1)

The module names are ``crfr``'s, so ``models.convert.params_from_jax``
carries its state as it stands (a grouped kernel (3, 3, 1, C) becomes (C,
1, 3, 3) by the same transpose). Layouts and dtypes as
``models.irse.IRBackbone``: NHWC in, NCHW in ``channels_last`` inside,
BN with flax's running statistics in train mode, everything in the compute
dtype but ``out_bn``, which stays float32.
"""

from __future__ import annotations

import torch
from torch import nn

from crfr_torch.models.irse import _BN, BatchNorm1d, BatchNorm2d, PReLU

_STAGES = ((2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1), (4, 128, 1, 2),
           (2, 128, 2, 1))


class ConvBNPReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int, *, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(cout, **_BN)
        self.prelu = PReLU(cout) if act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return self.prelu(x) if self.prelu is not None else x


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, expansion: int, stride: int):
        super().__init__()
        mid = cin * expansion
        self.expand = ConvBNPReLU(cin, mid, 1, 1)
        self.depthwise = ConvBNPReLU(mid, mid, 3, stride, groups=mid)
        self.project = ConvBNPReLU(mid, cout, 1, 1, act=False)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.depthwise(self.expand(x)))
        return x + y if self.residual else y


class MobileFaceNet(nn.Module):
    """(B, S, S, 3) NHWC normalized pixels → (B, embedding_dim) float32
    (512 by default, 128 canonical), not L2-normalized."""

    def __init__(self, embedding_dim: int = 512, input_size: int = 112,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_size % 16 != 0:
            raise ValueError("input_size must be divisible by 16")
        self.stem = ConvBNPReLU(3, 64, 3, 2)
        self.stem_dw = ConvBNPReLU(64, 64, 3, 1, groups=64)
        blocks, cin = [], 64
        for t, c, n, s in _STAGES:
            for i in range(n):
                blocks.append(Bottleneck(cin, c, t, s if i == 0 else 1))
                cin = c
        self.blocks = nn.ModuleList(blocks)
        self.head_conv = ConvBNPReLU(cin, 512, 1, 1)
        feat = input_size // 16
        self.gdconv = nn.Conv2d(512, 512, feat, groups=512, bias=False)
        self.gd_bn = BatchNorm2d(512, **_BN)
        self.out_linear = nn.Linear(512, embedding_dim, bias=False)
        self.out_bn = BatchNorm1d(embedding_dim, **_BN)
        self.set_dtype(dtype)
        self.to(memory_format=torch.channels_last)

    def set_dtype(self, dtype: torch.dtype) -> "MobileFaceNet":
        """Compute in ``dtype``: cast everything but ``out_bn``, which stays
        float32."""
        self.dtype = dtype
        self.to(dtype)
        self.out_bn.float()
        return self

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is accepted for the trainer's call and unused: the
        model has no dropout."""
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = self.stem_dw(self.stem(x))
        for blk in self.blocks:
            x = blk(x)
        x = self.gd_bn(self.gdconv(self.head_conv(x)))
        x = self.out_linear(x.reshape(x.shape[0], -1))
        return self.out_bn(x.to(self.out_bn.weight.dtype))

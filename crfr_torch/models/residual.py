"""The residual branch of residual knowledge distillation (crfr/models/residual.py).

r = R(s) models the teacher−student embedding gap, trained so that s + r ≈ t:
``fc1 (dim → hidden) → PReLU(hidden) → fc2 (hidden → dim)``, then a cast to
float32 and BatchNorm1d. The BN follows flax's convention, as the backbone's
does (``models.irse.BatchNorm1d``): momentum 0.9 on the old running value,
the biased batch variance in the running update. ``train()`` normalises by
the batch and moves the running statistics; ``eval()`` reads them. The
branch runs in float32 even when the backbone computes in bf16, as in the
reference, so call it outside ``torch.autocast``.
"""

from __future__ import annotations

import torch
from torch import nn

from crfr_torch.models.irse import _BN, BatchNorm1d, PReLU, init_weights


class ResidualBranch(nn.Module):
    def __init__(self, dim: int = 512, hidden: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.prelu = PReLU(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.bn = BatchNorm1d(dim, **_BN)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        r = self.fc2(self.prelu(self.fc1(emb)))
        return self.bn(r.to(self.bn.weight.dtype))                     # float32

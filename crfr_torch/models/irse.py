"""IR / IR-SE embedding backbones (crfr/models/irse.py) in PyTorch.

  input : Conv3×3(3→64, s1) → BN → PReLU
  body  : 4 stages of bottleneck_IR(_SE) units, first unit of each stride 2
          unit: BN → Conv3×3(s1) → PReLU → Conv3×3(s_unit) → BN [→ SE]
          shortcut: identity (same ch, s1) or Conv1×1(s)+BN
  output: BN → Dropout → Flatten → Linear(512·(S/16)² → 512) → BN1d

Depth configs: ir_18/34/50/100/152 (+ ``_se`` for squeeze-excite).

Layouts: ``forward`` and ``features`` take and return NHWC, as the reference
does. Inside, the network runs NCHW tensors in ``channels_last`` memory, so
an NHWC input (such as the fused preprocessing kernel's output) enters
without a copy. The flatten before ``out_linear`` is taken over an NHWC view
(H·W·C order, as the reference flattens), so ``out_linear`` keeps the
reference's row order and the weights carry across with a plain transpose
(``crfr_torch.models.convert``). With ``dtype=torch.bfloat16`` everything
but the final BN1d runs in bf16; BN1d stays float32, as in the reference.

Training (``model.train()``) follows flax's BatchNorm: the batch is
normalised by its own biased variance, and the running statistics move as
``new = 0.9·old + 0.1·batch`` with the *biased* batch variance, where
``torch.nn.BatchNorm*`` would take the unbiased one (off by n/(n−1): 8/7
for BN1d at B=8). Dropout draws its mask from the generator passed to
``forward`` (the trainer seeds one per step). ``remat=True`` recomputes each
residual block on the backward pass (``torch.utils.checkpoint``), without
moving the running statistics a second time. For bf16 compute with float32
master weights, build with ``dtype=torch.float32`` and run under
``torch.autocast``, as ``crfr_torch.train.loop`` does.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

_DEPTH_CONFIGS: dict[str, tuple[tuple[int, int], ...]] = {
    "18": ((64, 2), (128, 2), (256, 2), (512, 2)),
    "34": ((64, 3), (128, 4), (256, 6), (512, 3)),
    "50": ((64, 3), (128, 4), (256, 14), (512, 3)),
    "100": ((64, 3), (128, 13), (256, 30), (512, 3)),
    "152": ((64, 3), (128, 8), (256, 36), (512, 3)),
}

# flax BatchNorm momentum 0.9 (weight of the old running value) is torch's 0.1
_BN = dict(eps=1e-5, momentum=0.1)
_remat = threading.local()   # .recomputing: a remat block's backward recomputes its forward


@contextlib.contextmanager
def _recomputing():
    saved = getattr(_remat, "recomputing", False)
    _remat.recomputing = True
    try:
        yield
    finally:
        _remat.recomputing = saved


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


class _FlaxStats:
    """Train-mode BN whose running variance takes the biased batch variance.

    torch's kernel updates ``running_var`` with ``(1−m)·rv + m·var·n/(n−1)``.
    Handing it ``rv·n/(n−1)`` and scaling its result by (n−1)/n gives
    ``(1−m)·rv + m·var``, flax's update: a few operations on C values and
    no extra pass over the activations. (The kernel gets a copy: autograd
    keeps what it was given for the backward pass.)"""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(f"{type(self).__name__}: training needs more than one value "
                             f"per channel, got input of shape {tuple(x.shape)}")
        # a remat block's recomputation runs the same call on copies it drops
        frozen = getattr(_remat, "recomputing", False)
        with torch.no_grad():
            rm = self.running_mean.clone() if frozen else self.running_mean
            rv = self.running_var * (n / (n - 1))
        y = F.batch_norm(x, rm, rv, self.weight, self.bias, True, self.momentum, self.eps)
        if not frozen:
            with torch.no_grad():
                torch.mul(rv, (n - 1) / n, out=self.running_var)
        return y


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


def _dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``Dropout``: keep with probability 1−p and scale by 1/(1−p);
    the mask from ``generator`` (torch's own stream when None)."""
    if p <= 0.0:
        return x
    if generator is None:
        return F.dropout(x, p, True)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class PReLU(nn.PReLU):
    """Per-channel parametric ReLU, init 0.25: one elementwise launch."""

    def __init__(self, channels: int):
        super().__init__(channels, init=0.25)


class SEModule(nn.Module):
    """Squeeze-and-excite: GAP → FC(c/r) → ReLU → FC(c) → sigmoid gate."""

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
        return x * s[:, :, None, None]


class BottleneckIR(nn.Module):
    """BN → Conv3×3 → PReLU → Conv3×3(stride) → BN (+SE), plus shortcut."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, use_se: bool):
        super().__init__()
        self.bn0 = BatchNorm2d(in_ch, **_BN)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1, bias=False)
        self.prelu = PReLU(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(out_ch, **_BN)
        self.se = SEModule(out_ch, 16) if use_se else None
        if in_ch == out_ch and stride == 1:
            self.shortcut_conv = None
            self.shortcut_bn = None
        else:
            # flax "SAME" for 1×1 at stride 2 on even sizes pads nothing
            self.shortcut_conv = nn.Conv2d(in_ch, out_ch, 1, stride, 0, bias=False)
            self.shortcut_bn = BatchNorm2d(out_ch, **_BN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.bn2(self.conv2(self.prelu(self.conv1(self.bn0(x)))))
        if self.se is not None:
            r = self.se(r)
        if self.shortcut_conv is not None:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return r + x


class IRBackbone(nn.Module):
    """IR/IR-SE backbone: (B, S, S, 3) NHWC normalized pixels → (B, D) f32
    embedding (not L2-normalized, as in the reference)."""

    def __init__(self, depth: str = "50", use_se: bool = False,
                 embedding_dim: int = 512, dropout: float = 0.4,
                 input_size: int = 112, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        if depth not in _DEPTH_CONFIGS:
            raise ValueError(f"depth {depth!r} not in {sorted(_DEPTH_CONFIGS)}")
        if input_size % 16 != 0:
            raise ValueError("input_size must be divisible by 16")
        self.dtype = dtype
        self.remat = remat
        self.input_conv = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.input_bn = BatchNorm2d(64, **_BN)
        self.input_prelu = PReLU(64)
        blocks, stage_ends, in_ch = [], [], 64
        for channels, units in _DEPTH_CONFIGS[depth]:
            for u in range(units):
                blocks.append(BottleneckIR(in_ch, channels, 2 if u == 0 else 1, use_se))
                in_ch = channels
            stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)
        self._stage_ends = tuple(stage_ends)
        feat = input_size // 16
        self.out_bn = BatchNorm2d(512, **_BN)
        self.out_dropout = nn.Dropout(dropout)
        self.out_linear = nn.Linear(512 * feat * feat, embedding_dim)
        self.out_feat_bn = BatchNorm1d(embedding_dim, **_BN)
        self.to(dtype)
        self.out_feat_bn.float()
        self.to(memory_format=torch.channels_last)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return self.input_prelu(self.input_bn(self.input_conv(x)))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: dropout's draws in train mode."""
        x = self._stem(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpoint(blk, x, use_reentrant=False, context_fn=_remat_contexts)
            else:
                x = blk(x)
        x = self.out_bn(x)
        if self.training:
            x = _dropout(x, self.out_dropout.p, generator)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # H·W·C order
        x = self.out_linear(x)
        return self.out_feat_bn(x.to(self.out_feat_bn.weight.dtype))   # float32

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Stage-boundary feature maps, finest → coarsest, as NHWC views."""
        x = self._stem(x)
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i + 1 in self._stage_ends:
                feats.append(x.permute(0, 2, 3, 1))
        return feats


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw conv and linear weights from ``generator``: normal with
    variance 1/fan_in (LeCun, as the reference's initialisers scale them);
    linear biases zero. BN and PReLU keep their constant initial values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.normal_(w, 0.0, fan_in ** -0.5, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def build_backbone(name: str = "ir_50", *, embedding_dim: int = 512,
                   dropout: float = 0.4, input_size: int = 112,
                   dtype: torch.dtype = torch.float32,
                   generator: torch.Generator | None = None,
                   remat: bool = False) -> IRBackbone:
    """'ir_50' / 'ir_se_101' → IRBackbone with weights drawn from
    ``generator`` (seed 0 when None), on the CPU, in train mode like any
    fresh module: call ``.to(device).eval()`` for inference."""
    parts = name.lower().split("_")
    if parts[0] == "mobilefacenet":
        raise NotImplementedError("mobilefacenet is not ported yet")
    if parts[0] != "ir":
        raise ValueError(f"unknown backbone {name!r}")
    depth = parts[-1]
    if depth == "101":          # face.evoLVe calls the [3,13,30,3] config 101
        depth = "100"
    model = IRBackbone(depth=depth, use_se="se" in parts,
                       embedding_dim=embedding_dim, dropout=dropout,
                       input_size=input_size, dtype=dtype, remat=remat)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(model, generator)

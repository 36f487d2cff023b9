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

Over more than one device (``set_global_batch``): in ``crfr`` the batch is
sharded over the mesh and flax's BN averages over the whole of it. Here
each BN then all-reduces its per-channel sum and sum of squares over the
process group before normalising (``_GlobalBatchNorm``: the biased
variance E[x²] − E[x]² of the global batch, flax's rule, with n the global
count), and dropout draws its mask for the global batch and keeps this
rank's rows, so N ranks give one rank's step on the same global batch.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from crfr_torch.ops.batch_norm import batch_norm

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


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BN over the global batch of every rank of the default
    process group: forward and backward each all-reduce 2·C float32 sums.
    Saves the input (in its own dtype), the mean and 1/σ for the backward,
    as torch's SyncBatchNorm does, which refuses CPU tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        import torch.distributed as dist

        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        shape = (1, c) + (1,) * (x.ndim - 2)
        xf = x.float()
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims)])
        dist.all_reduce(sums)
        n = (x.numel() // c) * dist.get_world_size()
        mean = sums[:c] / n
        var = (sums[c:] / n - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        scale = (invstd * weight.float()).view(shape)
        y = (xf - mean.view(shape)) * scale + bias.float().view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        ctx.n = n
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        import torch.distributed as dist

        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        shape = (1, c) + (1,) * (x.ndim - 2)
        dyf = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        tot = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(tot)
        dx = (dyf - (tot[:c] / ctx.n).view(shape) - xhat * (tot[c:] / ctx.n).view(shape)) \
            * (invstd * weight.float()).view(shape)
        return dx.to(x.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None


class _FlaxStats:
    """Train-mode BN whose running variance takes the biased batch variance
    (``ops.batch_norm``): a rank-4 input on the card through its
    hand-written kernels, anything else through its plain version (ATen's
    kernel with the running variance rescaled). With ``global_stats`` the
    batch is every rank's (``_GlobalBatchNorm``)."""

    global_stats = False

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
        if self.global_stats:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            if not frozen:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1 - m).add_(var, alpha=m)
            return y
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          self.momentum, self.eps, update=not frozen)


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


def set_global_batch(model: nn.Module, rank: int = 0, world: int = 1) -> nn.Module:
    """Train ``model``'s BNs and dropout on the global batch of ``world``
    ranks of the default process group, of which this rank, ``rank``, holds
    the rows [rank·b, (rank+1)·b); world 1 is the single-device path."""
    for m in model.modules():
        if isinstance(m, _FlaxStats):
            m.global_stats = world > 1
        if isinstance(m, IRBackbone):
            m.batch_shard = (rank, world)
    return model


def _dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
             shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """flax's ``Dropout``: keep with probability 1−p and scale by 1/(1−p);
    the mask from ``generator`` (torch's own stream when None), drawn for
    the global batch of ``shard`` = (rank, world), of which ``x`` is the
    rank's rows."""
    if p <= 0.0:
        return x
    if generator is None:
        return F.dropout(x, p, True)
    rank, world = shard
    b = x.shape[0]
    keep = torch.rand((b * world, *x.shape[1:]), generator=generator,
                      device=x.device)[rank * b:(rank + 1) * b] < 1.0 - p
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
        self.batch_shard = (0, 1)        # (rank, world): see set_global_batch
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
        self.set_dtype(dtype)
        self.to(memory_format=torch.channels_last)

    def set_dtype(self, dtype: torch.dtype) -> "IRBackbone":
        """Compute in ``dtype``: cast everything but the final BN1d, which
        stays float32."""
        self.dtype = dtype
        self.to(dtype)
        self.out_feat_bn.float()
        return self

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
            x = _dropout(x, self.out_dropout.p, generator, self.batch_shard)
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
                   remat: bool = False) -> nn.Module:
    """'ir_50' / 'ir_se_101' → IRBackbone, 'mobilefacenet' → MobileFaceNet
    (which has no dropout or remat), with weights drawn from ``generator``
    (seed 0 when None), on the CPU, in train mode like any fresh module:
    call ``.to(device).eval()`` for inference."""
    parts = name.lower().split("_")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if parts[0] == "mobilefacenet":
        from crfr_torch.models.mobilefacenet import MobileFaceNet

        return init_weights(MobileFaceNet(embedding_dim=embedding_dim, input_size=input_size,
                                          dtype=dtype), generator)
    if parts[0] != "ir":
        raise ValueError(f"unknown backbone {name!r}")
    depth = parts[-1]
    if depth == "101":          # face.evoLVe calls the [3,13,30,3] config 101
        depth = "100"
    model = IRBackbone(depth=depth, use_se="se" in parts,
                       embedding_dim=embedding_dim, dropout=dropout,
                       input_size=input_size, dtype=dtype, remat=remat)
    return init_weights(model, generator)

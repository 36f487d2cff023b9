"""Prior-aided face hallucination networks (crfr/models/sr.py) in PyTorch:
the FSRNet-style SR stage. A coarse upsampler (a fixed bicubic-↑ skip plus
a learned sub-pixel residual), a facial-prior estimator (an hourglass that
predicts landmark heatmaps and parsing maps), a prior-conditioned
generator, and a strided discriminator for the adversarial loss.

Layouts: every public ``forward`` takes and returns NHWC, as the reference
does; inside, the networks run NCHW tensors in ``channels_last`` memory,
as ``models.irse`` does. Module and parameter names follow the reference's
nnx paths (``coarse.body.0.c1.conv``, ``gen.out``, ``fc``), so
``models.convert.params_from_jax`` carries the weights across.

Train and eval mode are the module's own (``.train()``/``.eval()``) in
place of the reference's ``train=`` argument; BN follows flax's running
statistics (``irse.BatchNorm2d``). ``_depth_to_space`` keeps the
reference's channel order, (r, r, C) with the channel fastest, which is
not ``nn.PixelShuffle``'s (C, r, r). Weights come from ``init_weights``
with a ``torch.Generator`` (LeCun normal, biases zero), after which the
correction heads ``CoarseUpsampler.out`` and ``Generator.out`` are set to
zero, so a fresh ``Hallucinator`` equals bicubic upsampling.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from crfr_torch.models.irse import _BN, BatchNorm2d, PReLU, init_weights
from crfr_torch.ops.bicubic import resize_matrix


def _depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C·r²) → (B, H·r, W·r, C), NHWC: the reference's sub-pixel
    order, channel index (i·r + j)·C + c for the output pixel (h·r + i,
    w·r + j)."""
    b, h, w, c = x.shape
    c_out = c // (r * r)
    x = x.reshape(b, h, w, r, r, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, c_out)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW channels_last tensor as its NHWC view (no copy)."""
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW in channels_last memory (no copy for a contiguous input)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=16)
def _up_matrix(s_in: int, s_out: int, mode: str, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first built under inference_mode (extraction):
    # a later call may need it saved for backward
    with torch.inference_mode(False):
        return torch.from_numpy(resize_matrix(s_in, s_out, mode)).to(device)


class ConvBlock(nn.Module):
    """Conv (bias only without BN) → BN → PReLU; BN and PReLU optional."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, norm: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=not norm)
        self.bn = BatchNorm2d(cout, **_BN) if norm else None
        self.prelu = PReLU(cout) if act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.prelu is not None:
            x = self.prelu(x)
        return x


class ResBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.c1 = ConvBlock(ch, ch)
        self.c2 = ConvBlock(ch, ch, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(self.c1(x))


def _factors(scale: int) -> tuple[int, ...]:
    """×2 for every factor of 2 in ``scale``, then the odd rest (14 → 2, 7)."""
    factors = []
    while scale % 2 == 0:
        factors.append(2)
        scale //= 2
    if scale > 1:
        factors.append(scale)
    return tuple(factors)


class CoarseUpsampler(nn.Module):
    """LR → coarse HR: a learned sub-pixel residual on top of the fixed
    bicubic-↑ of the input (``bicubic_skip``), so the output equals bicubic
    upsampling at init. Any integer scale ≥ 2: a ×2 stage for each factor
    of 2, then one odd stage (7 and 14 for the 16 and 8 px probes)."""

    def __init__(self, scale: int, width: int = 64, n_res: int = 3,
                 bicubic_skip: bool = True, resize_mode: str = "pil"):
        super().__init__()
        if scale < 2:
            raise ValueError("scale must be an integer >= 2")
        self.scale = scale
        self.bicubic_skip = bicubic_skip
        self.resize_mode = resize_mode
        self.factors = _factors(scale)
        self.inp = ConvBlock(3, width)
        self.body = nn.ModuleList(ResBlock(width) for _ in range(n_res))
        self.ups = nn.ModuleList(nn.Conv2d(width, width * f * f, 3, 1, 1) for f in self.factors)
        self.out = nn.Conv2d(width, 3, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, s, s, 3) normalized LR → (B, s·r, s·r, 3) as NCHW channels_last."""
        r = self.inp(_nchw(x))
        for blk in self.body:
            r = blk(r)
        for up, f in zip(self.ups, self.factors):
            r = torch.relu(_nchw(_depth_to_space(_nhwc(up(r)), f)))
        r = self.out(r)
        if not self.bicubic_skip:
            return r
        s = x.shape[1]
        w = _up_matrix(s, s * self.scale, self.resize_mode, x.device)
        skip = torch.einsum("oi,bijc,pj->bopc", w, x.to(r.dtype), w)
        return _nchw(skip) + r


class Hourglass(nn.Module):
    """One recursive hourglass: 2×2 max-pool down, nearest ×2 up, skip adds."""

    def __init__(self, depth: int, ch: int):
        super().__init__()
        self.depth = depth
        self.skip = nn.ModuleList(ResBlock(ch) for _ in range(depth))
        self.down = nn.ModuleList(ResBlock(ch) for _ in range(depth))
        self.up = nn.ModuleList(ResBlock(ch) for _ in range(depth))
        self.mid = ResBlock(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for d in range(self.depth):
            skips.append(self.skip[d](x))
            x = self.down[d](F.max_pool2d(x, 2))
        x = self.mid(x)
        for d in reversed(range(self.depth)):
            x = self.up[d](F.interpolate(x, scale_factor=2, mode="nearest")) + skips[d]
        return x


class PriorEstimator(nn.Module):
    """Coarse HR → K prior channels (landmark heatmaps + parsing maps)."""

    def __init__(self, n_priors: int = 16, width: int = 64, hg_depth: int = 3):
        super().__init__()
        self.inp = ConvBlock(3, width)
        self.hg = Hourglass(hg_depth, width)
        self.out = nn.Conv2d(width, n_priors, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW channels_last in and out."""
        return self.out(self.hg(self.inp(x)))


class Generator(nn.Module):
    """concat(coarse, priors) → residual trunk → coarse + correction."""

    def __init__(self, n_priors: int = 16, width: int = 64, n_res: int = 8):
        super().__init__()
        self.inp = ConvBlock(3 + n_priors, width)
        self.body = nn.ModuleList(ResBlock(width) for _ in range(n_res))
        self.out = nn.Conv2d(width, 3, 3, 1, 1)

    def forward(self, coarse: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
        """NCHW channels_last in and out."""
        x = self.inp(torch.cat([coarse, priors.to(coarse.dtype)], dim=1))
        for blk in self.body:
            x = blk(x)
        return coarse + self.out(x)


class Discriminator(nn.Module):
    """Strided ConvBlocks (the first with a bias and no BN) up to width 512,
    global mean, ``fc`` → one logit per image. NHWC in."""

    def __init__(self, width: int = 64, n_down: int = 4):
        super().__init__()
        layers = [ConvBlock(3, width, stride=2, norm=False)]
        ch = width
        for _ in range(n_down - 1):
            layers.append(ConvBlock(ch, min(ch * 2, 512), stride=2))
            ch = min(ch * 2, 512)
        self.layers = nn.ModuleList(layers)
        self.fc = nn.Linear(ch, 1)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        for layer in self.layers:
            x = layer(x)
        return self.fc(x.mean(dim=(2, 3)))[:, 0]


class Hallucinator(nn.Module):
    """LR → (sr, coarse, priors), each NHWC: the full SR stage."""

    def __init__(self, scale: int = 8, n_priors: int = 16, resize_mode: str = "pil",
                 bicubic_skip: bool = True):
        super().__init__()
        self.scale = scale
        self.n_priors = n_priors
        self.coarse = CoarseUpsampler(scale, resize_mode=resize_mode, bicubic_skip=bicubic_skip)
        self.prior = PriorEstimator(n_priors)
        self.gen = Generator(n_priors)
        self.to(memory_format=torch.channels_last)

    def forward(self, lr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        coarse = self.coarse(lr)
        priors = self.prior(coarse)
        sr = self.gen(coarse, priors)
        return _nhwc(sr), _nhwc(coarse), _nhwc(priors)


def build_hallucinator(scale: int = 8, n_priors: int = 16, resize_mode: str = "pil",
                       bicubic_skip: bool = True,
                       generator: torch.Generator | None = None) -> Hallucinator:
    """A ``Hallucinator`` drawn from ``generator`` (seed 0 when None) on the
    CPU, with its correction heads at zero: G equals bicubic at init."""
    g = Hallucinator(scale, n_priors, resize_mode, bicubic_skip)
    init_weights(g, generator if generator is not None else torch.Generator().manual_seed(0))
    with torch.no_grad():                 # the coarse head only on top of the skip
        for head in [g.gen.out] + ([g.coarse.out] if bicubic_skip else []):
            head.weight.zero_()
            head.bias.zero_()
    return g


def build_discriminator(generator: torch.Generator | None = None) -> Discriminator:
    """A ``Discriminator`` drawn from ``generator`` (seed 1 when None)."""
    return init_weights(Discriminator(),
                        generator if generator is not None else torch.Generator().manual_seed(1))

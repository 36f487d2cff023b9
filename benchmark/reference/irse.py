"""The IR backbone of ArcFace (arXiv:1801.07698), written out in plain float32
PyTorch from its layer equations, with its parameters in a dict by name.

    input : Conv3x3(3 -> 64) -> BN -> PReLU
    body  : stages of units, the first unit of each stage at stride 2
            unit: BN -> Conv3x3 -> PReLU -> Conv3x3(stride) -> BN
            shortcut: identity when the unit keeps width and size, else
            Conv1x1(stride) -> BN (insightface's iresnet rule; face.evoLVe
            takes a strided 1x1 max-pool where only the size changes)
    output: BN -> Dropout -> flatten -> Linear(512 * (S/16)^2 -> D) -> BN1d

Convolutions pad 1 (3x3) and 0 (1x1), have no bias, and PReLU slopes start
at 0.25. The flatten takes each image's features in (H, W, C) order, as a
network written for NHWC tensors lays them out. BatchNorm has eps 1e-5; in
training it normalises by the batch's biased variance (the running
statistics, which no comparison reads, are not kept), in evaluation by the
running statistics it is given.

``quant="fp8"`` computes as FP8 training does, the control of a bfloat16
configuration: each convolution's and the linear layer's two operands are
rounded to float8 e4m3 (a per-tensor scale to 448) before the product, and
the gradient arriving at each product's output to float8 e5m2 (a
per-tensor scale to 57,344); the rounding passes gradients straight
through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

STAGES = {
    "18": (2, 2, 2, 2),
    "50": (3, 4, 14, 3),
    "100": (3, 13, 30, 3),
}
WIDTHS = (64, 128, 256, 512)
EPS = 1e-5


def units(backbone: str) -> list[tuple[int, int, int]]:
    """(in width, out width, stride) of every unit of ``ir_<depth>``."""
    depth = backbone.split("_")[-1]
    if depth not in STAGES:
        raise ValueError(f"backbone {backbone!r} not in {sorted(STAGES)}")
    out, cin = [], 64
    for width, n in zip(WIDTHS, STAGES[depth]):
        for u in range(n):
            out.append((cin, width, 2 if u == 0 else 1))
            cin = width
    return out


def param_specs(backbone: str, embedding_dim: int, input_size: int,
                num_classes: int) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter of backbone and head. init is
    ``lecun`` (normal, variance 1/fan-in), ``zeros``, ``ones``, ``prelu``
    (0.25) or ``xavier`` (uniform in +-sqrt(6 / (D + C)))."""
    specs: list[tuple[str, tuple[int, ...], str]] = []

    def bn(name: str, c: int) -> None:
        specs.extend([(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros")])

    specs.append(("backbone.input_conv.weight", (64, 3, 3, 3), "lecun"))
    bn("backbone.input_bn", 64)
    specs.append(("backbone.input_prelu.weight", (64,), "prelu"))
    for i, (cin, cout, stride) in enumerate(units(backbone)):
        p = f"backbone.blocks.{i}"
        bn(f"{p}.bn0", cin)
        specs.append((f"{p}.conv1.weight", (cout, cin, 3, 3), "lecun"))
        specs.append((f"{p}.prelu.weight", (cout,), "prelu"))
        specs.append((f"{p}.conv2.weight", (cout, cout, 3, 3), "lecun"))
        bn(f"{p}.bn2", cout)
        if cin != cout or stride != 1:
            specs.append((f"{p}.shortcut_conv.weight", (cout, cin, 1, 1), "lecun"))
            bn(f"{p}.shortcut_bn", cout)
    bn("backbone.out_bn", 512)
    feat = input_size // 16
    specs.append(("backbone.out_linear.weight", (embedding_dim, 512 * feat * feat), "lecun"))
    specs.append(("backbone.out_linear.bias", (embedding_dim,), "zeros"))
    bn("backbone.out_feat_bn", embedding_dim)
    specs.append(("head.weight", (embedding_dim, num_classes), "xavier"))
    return specs


def decayed(name: str) -> bool:
    """Weight decay applies to convolution and linear weights and the head's
    W, not to biases, BN scales or PReLU slopes."""
    return name == "head.weight" or (name.endswith(".weight") and
                                     ("conv" in name or "linear" in name))


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t + (_round(t.detach(), torch.float8_e4m3fn, 448.0) - t).detach()


class _GradFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


_QUANT = {None: (lambda t: t, lambda y: y), "fp8": (_fp8, _GradFP8.apply)}


def _bn(p: dict, name: str, x: torch.Tensor, stats: dict | None) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if stats is None:
        return F.batch_norm(x, None, None, w, b, True, 0.0, EPS)
    return F.batch_norm(x, stats[f"{name}.running_mean"], stats[f"{name}.running_var"],
                        w, b, False, 0.0, EPS)


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, a.view(1, -1, *([1] * (x.ndim - 2))) * x)


def backbone_forward(p: dict, x: torch.Tensor, backbone: str, *, stats: dict | None = None,
                     keep: torch.Tensor | None = None, drop: float = 0.0,
                     quant: str | None = None, remat: bool = False) -> torch.Tensor:
    """(B, S, S, 3) normalized float32 pixels → (B, D) float32 embeddings.

    ``stats`` None: training (batch statistics, dropout with the boolean
    ``keep`` mask of shape (B, 512, S/16, S/16) when ``drop`` > 0); else
    evaluation with the running statistics in ``stats``. ``remat``
    recomputes each unit in the backward pass to bound the memory."""
    q, qg = _QUANT[quant]

    def conv(x, name, stride, pad):
        return qg(F.conv2d(q(x), q(p[name]), stride=stride, padding=pad))

    x = x.permute(0, 3, 1, 2)
    x = _prelu(_bn(p, "backbone.input_bn", conv(x, "backbone.input_conv.weight", 1, 1), stats),
               p["backbone.input_prelu.weight"])
    for i, (cin, cout, stride) in enumerate(units(backbone)):
        pre = f"backbone.blocks.{i}"

        def unit(x, pre=pre, cin=cin, cout=cout, stride=stride):
            r = _bn(p, f"{pre}.bn0", x, stats)
            r = _prelu(conv(r, f"{pre}.conv1.weight", 1, 1), p[f"{pre}.prelu.weight"])
            r = _bn(p, f"{pre}.bn2", conv(r, f"{pre}.conv2.weight", stride, 1), stats)
            if cin != cout or stride != 1:
                x = _bn(p, f"{pre}.shortcut_bn",
                        conv(x, f"{pre}.shortcut_conv.weight", stride, 0), stats)
            return r + x

        x = checkpoint(unit, x, use_reentrant=False) if remat else unit(x)
    x = _bn(p, "backbone.out_bn", x, stats)
    if stats is None and drop > 0:
        x = torch.where(keep, x / (1.0 - drop), torch.zeros((), device=x.device))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = qg(F.linear(q(x), q(p["backbone.out_linear.weight"]), p["backbone.out_linear.bias"]))
    return _bn(p, "backbone.out_feat_bn", x, stats)


def fan_in(shape: tuple[int, ...]) -> int:
    return math.prod(shape[1:])

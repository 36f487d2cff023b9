"""int8 post-training quantization of the embedding backbones
(crfr/models/quant.py), for serving.

The scheme is the reference's, unchanged:

- weights: per-output-channel symmetric int8 from the float32 weights,
  ``sw = max(max |W| over (I, kh, kw), 1e-12) / 127``,
  ``w8 = clip(round(W / sw), −127, 127)``;
- activations: per-tensor symmetric int8, ``sx = max(absmax, 1e-12) / 127``,
  where ``absmax`` is the largest |x| the conv's input reaches over a few
  calibration batches (``calibrate``);
- the conv computes s8 × s8 → s32, then ``y · (sx · sw)`` (+ bias) in
  float32, cast to the dtype the replaced conv emitted;
- BN, PReLU, SE, the residual adds and the Linear + BN1d head stay float;
  grouped and depthwise convs (``groups > 1``) stay float too.

Rounding is half to even on both sides (``torch.round``, ``jnp.round``),
and the input is divided by ``sx`` (not multiplied by its reciprocal), so
the codes, the s32 sums and the float epilogue equal the reference's.

The s8 convolution: stock PyTorch has no CUDA s8 convolution, so the conv
is a patch gather and a GEMM. The activation is NCHW in ``channels_last``
memory, so its NHWC view is free; it is padded spatially and its (kh, kw, C)
patches are gathered into one contiguous int8 (B·Ho·Wo, K) matrix, K
ordered as the weights reshaped O × (kh·kw·I). On CUDA the product is
``torch._int_mm`` (cuBLASLt's s8 × s8 → s32 GEMM), which needs more than 16
rows and K and N multiples of 8: zero rows and columns pad the operands
where they fall short, which changes no sum (the input conv's K = 27 is
gathered straight into 32 columns). On CPU tensors the product is its plain
version, an int32 matmul (``int8_matmul_reference``). The (B·Ho·Wo, O)
result is viewed back as NHWC, which is NCHW in ``channels_last`` memory.

Usage::

    q = quantize_backbone(backbone, calib_batches, compute_dtype=torch.bfloat16)
    emb = q(normalized_nhwc)
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from crfr_torch.utils.profiling import annotate

_MIN_ROWS = 17           # torch._int_mm on CUDA: more than 16 rows
_ALIGN = 8               # ... and K and N multiples of 8


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of ``int8_matmul``: (M, K) int8 · (N, K)ᵀ int8 →
    (M, N) int32 as an int32 matmul (CPU tensors). Exact: every partial sum
    is at most 127²·K, within int32 for K below 133,000."""
    return a.to(torch.int32) @ b.to(torch.int32).t()


def int_mm_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a`` (M, K) and ``b`` (N, K) as ``torch._int_mm`` takes them on
    CUDA: contiguous, more than 16 rows of ``a``, K and N multiples of 8,
    padded with zeros (which change no sum) where they fall short."""
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = max(m, _MIN_ROWS), _ceil(k, _ALIGN), _ceil(n, _ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    return a.contiguous(), b.contiguous()


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (N, K)ᵀ int8 → (M, N) int32: ``torch._int_mm`` on
    CUDA tensors (operands from ``int_mm_operands``), the plain version on
    CPU tensors."""
    if a.device.type != "cuda":
        return int8_matmul_reference(a, b)
    m, n = a.shape[0], b.shape[0]
    ap, bp = int_mm_operands(a, b)
    y = torch._int_mm(ap, bp.t())
    return y[:m, :n] if y.shape != (m, n) else y


def _conv_padding(conv: nn.Conv2d) -> tuple[int, int]:
    if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
        raise ValueError(f"QuantConv: padding {conv.padding!r} ({conv.padding_mode}); "
                         "it takes explicit zero padding")
    return tuple(conv.padding)


def gather_patches(x: torch.Tensor, kernel: tuple[int, int], stride: tuple[int, int],
                   padding: tuple[int, int], dilation: tuple[int, int] = (1, 1),
                   k_cols: int | None = None) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """NHWC ``x``, zero-padded by ``padding`` = (ph, pw) on each side → its
    (B·Ho·Wo, K) patch matrix, K = kh·kw·C ordered (kh, kw, C), in a
    contiguous buffer of ``k_cols`` ≥ K columns (the columns past K zero),
    and (B, Ho, Wo)."""
    (kh, kw), (sh, sw), (dh, dw), (ph, pw) = kernel, stride, dilation, padding
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    b, h, w, c = x.shape
    ho, wo = (h - dh * (kh - 1) - 1) // sh + 1, (w - dw * (kw - 1) - 1) // sw + 1
    s_b, s_h, s_w, s_c = x.stride()
    view = x.as_strided((b, ho, wo, kh, kw, c),
                        (s_b, s_h * sh, s_w * sw, s_h * dh, s_w * dw, s_c))
    k, m = kh * kw * c, b * ho * wo
    k_cols = k if k_cols is None else k_cols
    if k_cols == k:
        return view.reshape(m, k).contiguous(), (b, ho, wo)
    patches = torch.empty((m, k_cols), dtype=x.dtype, device=x.device)
    patches[:, k:].zero_()
    patches[:, :k].view(b, ho, wo, kh, kw, c).copy_(view)
    return patches, (b, ho, wo)


class QuantConv(nn.Module):
    """int8-weight, int8-activation stand-in for an ``nn.Conv2d`` (groups
    1), built from the trained float conv and its input's calibrated
    absmax. Buffers (in ``state_dict``): ``w8`` (O, I, kh, kw) int8, ``sw``
    (O,) and ``sx`` () float32, ``bias`` (O,) float32 when the conv has one.

    It emits the dtype the replaced conv emitted: the autocast dtype while
    autocast is on, else ``out_dtype``, the conv's weight dtype. Casting the
    module (``.to(torch.bfloat16)``, ``.float()``) moves ``out_dtype``; the
    scales and bias stay float32 and ``w8`` int8."""

    def __init__(self, conv: nn.Conv2d, act_absmax: float):
        super().__init__()
        if conv.groups != 1:
            raise ValueError(f"QuantConv: a conv of {conv.groups} groups stays float")
        dev = conv.weight.device
        w = conv.weight.detach().to("cpu", torch.float32)                 # OIHW
        sw = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
        w8 = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127).to(torch.int8)
        self.register_buffer("w8", w8.to(dev))
        self.register_buffer("sw", sw.to(dev))
        self.register_buffer("sx", torch.tensor(max(float(act_absmax), 1e-12) / 127.0,
                                                dtype=torch.float32, device=dev))
        self.register_buffer("bias", None if conv.bias is None else
                             conv.bias.detach().to(torch.float32).clone())
        self.kernel_size = tuple(conv.kernel_size)
        self.stride = tuple(conv.stride)
        self.dilation = tuple(conv.dilation)
        self.padding = _conv_padding(conv)
        self.out_dtype = conv.weight.dtype
        self._pack()

    def _pack(self) -> None:
        """``wmat``: w8 as (O, kh·kw·I) in (kh, kw, I) order, padded with
        zeros to multiples of 8 (not in ``state_dict``; rebuilt on load)."""
        o, i, kh, kw = self.w8.shape
        k = kh * kw * i
        mat = self.w8.permute(0, 2, 3, 1).reshape(o, k)
        mat = F.pad(mat, (0, _ceil(k, _ALIGN) - k, 0, _ceil(o, _ALIGN) - o))
        self.register_buffer("wmat", mat.contiguous(), persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._pack()

    def _apply(self, fn, recurse=True):
        probe = fn(torch.zeros((), dtype=self.out_dtype, device=self.w8.device))
        self.out_dtype = probe.dtype
        return super()._apply(lambda t: t.to(probe.device), recurse)

    def extra_repr(self) -> str:
        o, i, kh, kw = self.w8.shape
        return (f"{i}, {o}, kernel_size={(kh, kw)}, stride={self.stride}, padding={self.padding}, "
                f"out_dtype={self.out_dtype}")

    def int_sums(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
        """(the (B·Ho·Wo, O) int32 sums of the quantized input with ``w8``,
        (B, Ho, Wo)) for an NCHW ``x``."""
        with annotate("quant::quantize"):
            xq = torch.round(x.float() / self.sx).clamp_(-127, 127).to(torch.int8)
        with annotate("quant::gather"):
            patches, shape = gather_patches(xq.permute(0, 2, 3, 1), self.kernel_size,
                                            self.stride, self.padding, self.dilation,
                                            self.wmat.shape[1])
        with annotate("quant::int_mm"):
            acc = int8_matmul(patches, self.wmat)
        return acc[:, :self.w8.shape[0]], shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device.type
        out_dtype = (torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev)
                     else self.out_dtype)
        acc, (b, ho, wo) = self.int_sums(x)
        with annotate("quant::epilogue"):
            y = acc.view(b, ho, wo, -1) * (self.sx * self.sw)        # int32 · f32 → f32
            if self.bias is not None:
                y = y + self.bias
            y = y.to(out_dtype)
        return y.permute(0, 3, 1, 2)                         # NCHW, channels_last memory


def quantizable_convs(model: nn.Module) -> list[tuple[str, nn.Conv2d]]:
    """(module path, conv) of every ``nn.Conv2d`` with groups 1."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, nn.Conv2d) and m.groups == 1]


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def calibrate(model: nn.Module, calib_batches: Iterable) -> dict[str, float]:
    """Run ``model`` in eval mode over ``calib_batches`` (normalized NHWC
    pixels, numpy or tensors) and return {conv path: the largest |x| its
    input reached}. Forward pre-hooks record each input's absmax, in the
    autocast dtype while autocast is on (what the conv computes on); the
    hooks and the module's mode are restored after."""
    convs = quantizable_convs(model)
    if not convs:
        raise ValueError("no quantizable convs found in model")
    amax: dict[str, torch.Tensor] = {}

    def observer(name: str):
        def hook(_mod, args):
            x = args[0]
            if torch.is_autocast_enabled(x.device.type):
                x = x.to(torch.get_autocast_dtype(x.device.type))
            a = x.detach().abs().amax().float()
            amax[name] = a if name not in amax else torch.maximum(amax[name], a)
        return hook

    handles = [m.register_forward_pre_hook(observer(n)) for n, m in convs]
    was, dev, n = model.training, _device(model), 0
    model.eval()
    try:
        for batch in calib_batches:
            model(torch.as_tensor(batch).to(dev))
            n += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was)
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return {name: float(a) for name, a in amax.items()}


def calibration_batch(raw, degrade_to: int | None = None, mode: str = "pil",
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """Raw (B, S, S, 3) pixels → a float32 calibration batch on ``device``:
    the plain bicubic down-up operator to ``degrade_to`` (none when None),
    then normalization, as the reference prepares its calibration input."""
    from crfr_torch.ops.bicubic import degrade_updown
    from crfr_torch.ops.normalize import normalize

    x = torch.as_tensor(raw).to(device=device, dtype=torch.float32)
    if degrade_to:
        x = degrade_updown(x, degrade_to, mode)
    return normalize(x)


def _cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    set_dtype = getattr(model, "set_dtype", None)
    return set_dtype(dtype) if callable(set_dtype) else model.to(dtype)


def quantize_backbone(backbone: nn.Module, calib_batches: Iterable,
                      compute_dtype: torch.dtype | None = None) -> nn.Module:
    """A copy of ``backbone`` in eval mode with every conv of groups 1
    replaced by a ``QuantConv``; ``backbone`` is left as it is.

    ``calib_batches``: a few batches of normalized NHWC pixels like the
    serving traffic (absmax scales: more data only widens them).
    ``compute_dtype``: the dtype the quantized model computes in, as the
    reference's float32 parameters compute in their module's dtype:
    calibration runs a copy cast to it, the convs quantize from
    ``backbone``'s own (float32) weights, and the float remainder is cast
    to it after. None keeps ``backbone``'s dtype."""
    calib_model = copy.deepcopy(backbone)
    if compute_dtype is not None:
        _cast(calib_model, compute_dtype)
    scales = calibrate(calib_model, calib_batches)
    del calib_model

    q = copy.deepcopy(backbone)
    for name, conv in quantizable_convs(q):
        parent_name, _, attr = name.rpartition(".")
        setattr(q.get_submodule(parent_name), attr, QuantConv(conv, scales[name]))
    if compute_dtype is not None:
        _cast(q, compute_dtype)
    return q.eval()


def quantized_embed_fn(backbone: nn.Module, calib_batches: Iterable,
                       compute_dtype: torch.dtype | None = None) -> Callable:
    """Trained float backbone → an inference-mode int8 embed callable
    (normalized NHWC pixels, numpy or tensor → (B, D) embeddings)."""
    q = quantize_backbone(backbone, calib_batches, compute_dtype)
    dev = _device(q)

    @torch.inference_mode()
    def f(x) -> torch.Tensor:
        return q(torch.as_tensor(x).to(dev))

    return f

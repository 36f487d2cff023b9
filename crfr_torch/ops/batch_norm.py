"""Train-mode BatchNorm by flax's rule, over channels_last activations.

The batch is normalised by its own biased variance, and the running
statistics move as ``new = (1 − m)·old + m·batch`` with the *biased* batch
variance (m = 0.1: flax's momentum 0.9 on the old value), where torch's
kernels take the unbiased one. The update is skipped with ``update=False``
(a remat block's recomputation).

A CPU tensor, or one of another rank than 4 (a ``BatchNorm1d``'s), goes
through ``batch_norm_reference``, ATen's ``batch_norm`` handed ``rv·n/(n−1)``
with its result scaled back by (n−1)/n. A rank-4 CUDA tensor goes through the four hand-written kernels of ``csrc/batch_norm.cu`` or the
call raises: there is no fallback. It takes a rank-4 channels_last tensor in
bf16 or float32 with float32 weight, bias and running statistics; the output
and the input gradient are in the input's dtype, the weight and bias
gradients float32. The backward saves x, the mean and 1/σ, as ATen's does.
``batch_norm.launches`` counts launches: two a forward, two a backward.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from crfr_torch.ops import _build

_THREADS = 256                  # a CTA, as csrc/batch_norm.cu's kThreads
_UNROLL = 4                     # rows a thread loads at once, as its kUnroll
_CTAS_PER_SM = 2
_MAX_VB = 16                    # 16-byte vectors of a row a CTA's column block (8 and 32
                                # were slower at IR-50's shapes)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_scratches: dict[tuple[int, int], tuple] = {}   # (device, stream) → partials, tickets, pointers


def batch_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         running_mean: torch.Tensor, running_var: torch.Tensor,
                         momentum: float, eps: float, update: bool = True) -> torch.Tensor:
    """The plain version: torch's kernel updates ``running_var`` with
    ``(1−m)·rv + m·var·n/(n−1)``; handing it ``rv·n/(n−1)`` and scaling its
    result by (n−1)/n gives ``(1−m)·rv + m·var``, flax's update, in a few
    operations on C values. (The kernel gets a copy: autograd keeps what it
    was given for the backward pass.)"""
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        rm = running_mean if update else running_mean.clone()
        rv = running_var * (n / (n - 1))
    y = F.batch_norm(x, rm, rv, weight, bias, True, momentum, eps)
    if update:
        with torch.no_grad():
            torch.mul(rv, (n - 1) / n, out=running_var)
    return y


@functools.cache
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _layout(rows: int, c: int, wide: int, aligned: bool, sms: int) -> tuple:
    vec = wide if c % wide == 0 and aligned else 1
    cv = c // vec
    vb = min(_MAX_VB, cv & -cv)
    blocks = cv // vb
    row_blocks = max(1, min(_CTAS_PER_SM * sms // blocks,
                            -(-rows // (_THREADS // vb * _UNROLL)), 65535))
    return rows, c, vec, vb, row_blocks, math.isqrt(row_blocks - 1) + 1


def _plan(x: torch.Tensor, *others: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """(rows, channels, vec, vb, row_blocks, group) of a launch over ``x``:
    16-byte loads where every tensor's rows allow them, at most ``_MAX_VB``
    of them a CTA's column block, about ``_CTAS_PER_SM`` CTAs an SM (fewer where each
    thread would not get ``_UNROLL`` rows), and the row blocks' partials
    summed in groups of ⌈√row_blocks⌉, then the groups'. Worked out once a
    shape."""
    c = x.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return _layout(x.numel() // c, c, 16 // x.element_size(), aligned, _sms(x.device.index))


def _scratch(device: int, stream: int, plan: tuple) -> tuple[int, int]:
    """Pointers to the f32 partials of a reduction launch (the row blocks',
    then the groups') and to zeroed tickets (groups + 1 a column block; each
    counter's last taker resets it): one pair of buffers a stream, grown
    when a launch needs more. The launches on a stream run one after
    another, so each takes the buffers whole."""
    rows, c, vec, vb, row_blocks, group = plan
    groups = -(-row_blocks // group)
    need_part, need_tickets = 2 * (row_blocks + groups) * c, c // vec // vb * (groups + 1)
    key = (device, stream)
    held = _scratches.get(key)
    if held is None or held[0].numel() < need_part or held[1].numel() < need_tickets:
        have = (0, 0) if held is None else (held[0].numel(), held[1].numel())
        part = torch.empty(max(need_part, have[0], 1 << 18), dtype=torch.float32,
                           device=f"cuda:{device}")
        tickets = torch.zeros(max(need_tickets, have[1], 4096), dtype=torch.int32,
                              device=f"cuda:{device}")
        held = _scratches[key] = (part, tickets, part.data_ptr(), tickets.data_ptr())
    return held[2], held[3]


def _check(x, weight, bias, running_mean, running_var) -> None:
    what = "batch_norm"
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: the kernel takes bfloat16 or float32 input, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: the kernel takes channels_last-contiguous input")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t is None:
            raise ValueError(f"{what}: the kernel needs {name}")
        if t.device != x.device or t.dtype != torch.float32 or t.shape != (c,) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 ({c},) tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")


def _on(device: int):
    """The launches' device context: none where ``device`` is current
    already (a train step's, and the backward's on autograd's device
    thread)."""
    return contextlib.nullcontext() if torch.cuda.current_device() == device \
        else torch.cuda.device(device)


class _TrainBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, update):
        lib = _build.load_library()
        dev = x.device.index
        with _on(dev):
            stream = torch._C._cuda_getCurrentRawStream(dev)
            plan = _plan(x)
            c = plan[1]
            stats = torch.empty((2, c), dtype=torch.float32, device=x.device)  # mean, 1/σ
            mean, invstd = stats.data_ptr(), stats.data_ptr() + 4 * c
            part, tickets = _scratch(dev, stream, plan)
            err = lib.crfr_batch_norm_stats(
                x.data_ptr(), _DTYPES[x.dtype], *plan, part, tickets, mean, invstd,
                running_mean.data_ptr(), running_var.data_ptr(), momentum, eps, update, stream)
            _build.check(lib, err, "batch_norm (statistics)")
            y = torch.empty_like(x)
            err = lib.crfr_batch_norm_transform(
                x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], *plan, mean, invstd,
                weight.data_ptr(), bias.data_ptr(), stream)
            _build.check(lib, err, "batch_norm (transform)")
        batch_norm.launches += 2
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        lib = _build.load_library()
        dev = x.device.index
        with _on(dev):
            stream = torch._C._cuda_getCurrentRawStream(dev)
            dy = dy.contiguous(memory_format=torch.channels_last)
            dx = torch.empty_like(x)
            plan = _plan(x, dy, dx)
            c = plan[1]
            mean, invstd = stats.data_ptr(), stats.data_ptr() + 4 * c
            grads = torch.empty((2, c), dtype=torch.float32, device=x.device)  # weight, bias
            dw, db = grads.data_ptr(), grads.data_ptr() + 4 * c
            part, tickets = _scratch(dev, stream, plan)
            err = lib.crfr_batch_norm_backward_reduce(
                dy.data_ptr(), x.data_ptr(), _DTYPES[x.dtype], *plan, part, tickets, mean,
                invstd, dw, db, stream)
            _build.check(lib, err, "batch_norm (backward reduce)")
            err = lib.crfr_batch_norm_backward_apply(
                dy.data_ptr(), x.data_ptr(), dx.data_ptr(), _DTYPES[x.dtype], *plan, mean,
                invstd, weight.data_ptr(), dw, db, stream)
            _build.check(lib, err, "batch_norm (backward apply)")
        batch_norm.launches += 2
        return dx, grads[0], grads[1], None, None, None, None, None


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               momentum: float, eps: float, update: bool = True) -> torch.Tensor:
    """Train-mode BN of ``x`` by flax's rule, moving ``running_mean`` and
    ``running_var`` in place unless ``update`` is False."""
    if x.device.type == "cpu" or x.ndim != 4:
        return batch_norm_reference(x, weight, bias, running_mean, running_var, momentum, eps,
                                    update)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm: the kernel takes CUDA tensors, got {x.device}")
    _check(x, weight, bias, running_mean, running_var)
    return _TrainBatchNorm.apply(x, weight, bias, running_mean, running_var, float(momentum),
                                 float(eps), bool(update))


batch_norm.launches = 0

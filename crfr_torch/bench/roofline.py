"""Analytic roofline of the IR backbone on one NVIDIA H100 (crfr/bench/roofline.py).

Per conv layer the least time is

    t >= max(FLOPs_padded / peak,  bytes / hbm_bw)

A conv is a GEMM of M = B·Ho·Wo rows, K = kh·kw·Cin and N = Cout. Hopper's
tensor cores take a ``wgmma`` of K in steps of 16 (bf16; 8 in TF32, 32 in
int8) and N in steps of 8, so ``flops_padded`` rounds K and N up to those
steps: the input conv's K = 27 runs as 32, every other IR-50 layer is
already a multiple. The bytes are each activation read once and written
once, and the weights read once, at the compute dtype's width (layout as
``crfr_torch/models/irse.py``'s depth table). The FLOPs and bytes are
facts of the architecture, the same as ``crfr``'s; only the peaks and the
padding rule are the card's. Summing the per-layer bounds gives the
batch's speed of light on the card; a measured time over it is the
attainment.

``train_step_bounds`` adds what a train step moves beyond the forward
convs: each conv's forward, input gradient (dgrad) and weight gradient
(wgrad), FLOP-bound; each train-mode BatchNorm2d's forward (the batch
statistics and the transform: x read once, y written once) and backward
(the reduction of dy and dy·x̂ and the elementwise dx: dy and x read once,
dx written once); and each PReLU's forward (x read, y written) and backward
(dy and x read once, dx written once, the per-channel alpha gradient
reduced in the same read). All over channels_last activations at the
compute dtype's width, with the per-channel vectors in float32. These are
byte bounds: a kernel pair that moves fewer bytes does not exist, whatever
its fusion.

Peaks: NVIDIA H100 80GB HBM3 (SXM5, 700 W), NVIDIA's spec sheet, dense:
HBM 3.35 TB/s; bf16 989.4 TFLOP/s; TF32 494.7 TFLOP/s (cuDNN's default for
float32 convolutions); float32 outside the tensor cores 66.9 TFLOP/s;
int8 1,978.9 TOP/s. A card set below 700 W runs under them.

    python -m crfr_torch.bench.roofline [--depth 50] [--batch 256]
        [--input-size 112] [--measured-ms MS] [--train] [--dtype bfloat16]
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from crfr_torch.models.irse import _DEPTH_CONFIGS

CARD = "NVIDIA H100 80GB HBM3 (SXM5, 700 W)"
HBM_BW = 3.35e12            # B/s
PEAK_BF16 = 989.4e12        # FLOP/s, dense
PEAK_TF32 = 494.7e12
PEAK_F32 = 66.9e12          # outside the tensor cores
PEAK_INT8 = 1978.9e12       # OP/s, dense
# dtype → (tensor peak, bytes an element, K step, N step of a wgmma)
_DTYPES = {"bfloat16": (PEAK_BF16, 2, 16, 8), "float32": (PEAK_TF32, 4, 8, 8),
           "int8": (PEAK_INT8, 1, 32, 8)}
_VEC = 4                    # bytes of a float32 per-channel value


def _dtype(dtype: str) -> tuple[float, int, int, int]:
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {sorted(_DTYPES)}")
    return _DTYPES[dtype]


@dataclass
class LayerBound:
    name: str
    flops: float            # ideal MACs×2
    flops_padded: float     # with K/N padded to the wgmma steps
    bytes: float            # activations in+out + weights, at the dtype's width
    bound_s: float          # max(flops_padded/peak, bytes/bw)
    limiter: str            # 'tensor' | 'hbm'


def _bound(name: str, flops: float, fp: float, byts: float, peak: float) -> LayerBound:
    t_ops, t_mem = fp / peak, byts / HBM_BW
    return LayerBound(name, flops, fp, byts, max(t_ops, t_mem),
                      "hbm" if t_mem > t_ops else "tensor")


def _gemm_flops(m: int, k: int, n: int, dtype: str) -> tuple[float, float]:
    _, _, k_step, n_step = _dtype(dtype)
    return (2.0 * m * k * n,
            2.0 * m * (math.ceil(k / k_step) * k_step) * (math.ceil(n / n_step) * n_step))


def _conv(name: str, batch: int, h: int, cin: int, cout: int, k: int, stride: int,
          dtype: str) -> LayerBound:
    peak, e, _, _ = _dtype(dtype)
    ho = h // stride
    m, kk = batch * ho * ho, k * k * cin
    flops, fp = _gemm_flops(m, kk, cout, dtype)
    byts = e * (batch * h * h * cin + m * cout + kk * cout)
    return _bound(name, flops, fp, byts, peak)


def _layout(depth: str, input_size: int):
    """(name, h, cin, cout, k, stride) of every conv, in order, and the
    (name, channels, h) of every BN and PReLU of the IR backbone."""
    if depth not in _DEPTH_CONFIGS:
        raise ValueError(f"depth {depth!r} not in {sorted(_DEPTH_CONFIGS)}")
    convs = [("input", input_size, 3, 64, 3, 1)]
    norms = [("input_bn", 64, input_size, "bn"), ("input_prelu", 64, input_size, "prelu")]
    h, cin = input_size, 64
    for ch, units in _DEPTH_CONFIGS[depth]:
        for u in range(units):
            s = 2 if u == 0 else 1
            norms.append((f"{ch}.{u}.bn0", cin, h, "bn"))
            convs.append((f"{ch}.{u}.c1", h, cin, ch, 3, 1))
            norms.append((f"{ch}.{u}.prelu", ch, h, "prelu"))
            convs.append((f"{ch}.{u}.c2", h, ch, ch, 3, s))
            norms.append((f"{ch}.{u}.bn2", ch, h // s, "bn"))
            if s != 1 or cin != ch:
                convs.append((f"{ch}.{u}.sc", h, cin, ch, 1, s))
                norms.append((f"{ch}.{u}.sc_bn", ch, h // s, "bn"))
            h //= s
            cin = ch
    norms.append(("out_bn", 512, input_size // 16, "bn"))
    return convs, norms


def ir_layer_bounds(depth: str = "50", batch: int = 256, input_size: int = 112,
                    embedding_dim: int = 512, dtype: str = "bfloat16") -> list[LayerBound]:
    """Per-layer forward bounds of the IR backbone: its convs and the
    final linear layer."""
    peak, e, _, _ = _dtype(dtype)
    convs, _ = _layout(depth, input_size)
    layers = [_conv(name, batch, h, cin, cout, k, s, dtype)
              for name, h, cin, cout, k, s in convs]
    feat = input_size // 16
    fc_in = 512 * feat * feat
    flops, fp = _gemm_flops(batch, fc_in, embedding_dim, dtype)
    byts = e * (batch * fc_in + batch * embedding_dim + fc_in * embedding_dim)
    layers.append(_bound("fc", flops, fp, byts, peak))
    return layers


@dataclass
class RooflineSummary:
    ideal_flops: float
    padded_flops: float
    bytes: float
    bound_s: float                    # sum of per-layer bounds
    t_flops_ideal_s: float
    t_mem_s: float

    def mfu(self, measured_s: float) -> float:
        return self.t_flops_ideal_s / measured_s

    def attainment(self, measured_s: float) -> float:
        """Fraction of the workload's speed of light actually reached."""
        return self.bound_s / measured_s


def summarize(layers: list[LayerBound], dtype: str = "bfloat16") -> RooflineSummary:
    peak = _dtype(dtype)[0]
    f = sum(l.flops for l in layers)
    fp = sum(l.flops_padded for l in layers)
    b = sum(l.bytes for l in layers)
    return RooflineSummary(ideal_flops=f, padded_flops=fp, bytes=b,
                           bound_s=sum(l.bound_s for l in layers),
                           t_flops_ideal_s=f / peak, t_mem_s=b / HBM_BW)


@dataclass
class OpBound:
    name: str               # the layer, e.g. "64.0.bn0"
    group: str              # conv_forward | conv_backward | batch_norm | prelu
    pass_: str              # forward | dgrad | wgrad | backward
    flops: float            # padded for the convs; elementwise operations otherwise
    bytes: float
    bound_s: float
    limiter: str            # 'tensor' | 'cores' | 'hbm'


# elementwise operations an element: BN forward (sum, square-sum, then
# subtract-multiply-add), BN backward (two products and sums, then the dx
# formula), PReLU forward (compare-select-multiply), backward (select,
# multiply, and the alpha product-sum)
_ELEM_OPS = {("batch_norm", "forward"): 5, ("batch_norm", "backward"): 8,
             ("prelu", "forward"): 2, ("prelu", "backward"): 4}


def _elementwise(name: str, group: str, pass_: str, n: int, c: int, e: int) -> OpBound:
    # forward: x in, y out; backward: dy and x in, dx out; the per-channel
    # vectors (γ, β, the running and saved statistics, or alpha, and their
    # gradients) counted as four float32 vectors of C, negligible beside them
    act = 2 * n * e if pass_ == "forward" else 3 * n * e
    byts = act + 4 * c * _VEC
    ops = _ELEM_OPS[(group, pass_)] * n
    t_ops, t_mem = ops / PEAK_F32, byts / HBM_BW
    return OpBound(name, group, pass_, ops, byts, max(t_ops, t_mem),
                   "hbm" if t_mem > t_ops else "cores")


def train_step_bounds(depth: str = "50", batch: int = 512, input_size: int = 112,
                      dtype: str = "bfloat16") -> list[OpBound]:
    """Per-op bounds of a train step of the IR backbone: each conv's
    forward, dgrad and wgrad (FLOP-bound on the tensor cores; dgrad reads
    dy and the weights and writes dx, wgrad reads x and dy and writes dw),
    and each train-mode BN's and PReLU's forward and backward (byte-bound,
    as the module docstring counts them). ``dtype``: bfloat16 (autocast)
    or float32 (TF32 convs)."""
    peak, e, _, _ = _dtype(dtype)
    convs, norms = _layout(depth, input_size)
    out: list[OpBound] = []
    for name, h, cin, cout, k, s in convs:
        ho = h // s
        m, kk = batch * ho * ho, k * k * cin
        _, fp = _gemm_flops(m, kk, cout, dtype)
        x, y, w = batch * h * h * cin * e, m * cout * e, kk * cout * e
        for pass_, group, byts in (("forward", "conv_forward", x + w + y),
                                   ("dgrad", "conv_backward", y + w + x),
                                   ("wgrad", "conv_backward", x + y + w)):
            t_ops, t_mem = fp / peak, byts / HBM_BW
            out.append(OpBound(name, group, pass_, fp, byts, max(t_ops, t_mem),
                               "hbm" if t_mem > t_ops else "tensor"))
    for name, c, h, kind in norms:
        group = "batch_norm" if kind == "bn" else "prelu"
        for pass_ in ("forward", "backward"):
            out.append(_elementwise(name, group, pass_, batch * h * h * c, c, e))
    return out


def group_bounds(ops: list[OpBound]) -> dict[str, float]:
    """Seconds of bound by group (``xprof_check``'s train groups)."""
    out: dict[str, float] = {}
    for o in ops:
        out[o.group] = out.get(o.group, 0.0) + o.bound_s
    return out


def report(depth: str = "50", batch: int = 256, input_size: int = 112,
           measured_ms: float | None = None, top: int = 8, dtype: str = "bfloat16",
           train: bool = False) -> str:
    layers = ir_layer_bounds(depth, batch, input_size, dtype=dtype)
    s = summarize(layers, dtype)
    peak = _dtype(dtype)[0]
    lines = [
        f"IR-{depth} @{input_size} batch={batch} {dtype} on {CARD} "
        f"(spec-sheet peaks: {peak / 1e12:.1f} TFLOP/s, {HBM_BW / 1e12:.2f} TB/s)",
        f"  ideal  {s.ideal_flops / 1e12:.3f} TFLOP/batch  "
        f"padded {s.padded_flops / 1e12:.3f} TFLOP  traffic {s.bytes / 1e9:.3f} GB",
        f"  bounds: flops-ideal {s.t_flops_ideal_s * 1e3:.3f} ms   "
        f"mem {s.t_mem_s * 1e3:.3f} ms   per-layer speed-of-light {s.bound_s * 1e3:.3f} ms",
    ]
    if measured_ms is not None:
        lines.append(f"  measured {measured_ms:.3f} ms → "
                     f"{100 * s.attainment(measured_ms / 1e3):.1f}% of attainable, "
                     f"ideal-MFU {100 * s.mfu(measured_ms / 1e3):.1f}%")
    lines.append("  heaviest layers (bound, limiter):")
    for l in sorted(layers, key=lambda l: -l.bound_s)[:top]:
        lines.append(f"    {l.name:10s} {l.bound_s * 1e6:8.1f} us  {l.limiter}  "
                     f"pad-waste ×{l.flops_padded / max(l.flops, 1.0):.2f}")
    if train:
        ops = train_step_bounds(depth, batch, input_size, dtype)
        lines.append(f"  train step at batch {batch}, bound by group:")
        for g, t in sorted(group_bounds(ops).items(), key=lambda kv: -kv[1]):
            gb = sum(o.bytes for o in ops if o.group == g)
            lines.append(f"    {g:14s} {t * 1e3:8.3f} ms  {gb / 1e9:8.3f} GB")
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", default="50")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--input-size", type=int, default=112)
    ap.add_argument("--measured-ms", type=float, default=None)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--train", action="store_true", help="add the train step's bounds")
    args = ap.parse_args()
    print(report(args.depth, args.batch, args.input_size, args.measured_ms,
                 dtype=args.dtype, train=args.train))

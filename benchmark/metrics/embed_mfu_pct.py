"""The embed step's share of the cards' bf16 peak: the backbone's forward
FLOPs (convolutions and the embedding GEMM, ``benchmark.roofline``) of
every call of the untraced window, over its seconds, the peak and the
cards."""

from benchmark.roofline import PEAK_BF16


def read(traces, ctx):
    flops = ctx["flops_per_call"] * ctx["window_calls"]
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16 * ctx["cards"])

"""The share of the traced segment in which the device computed nothing:
one less the union of its operations but the collectives' kernels (which
mostly wait on the other cards: ``trace.summarize``'s ``compute_busy_s``)
over the segment's span on the device, both read from the trace alone and
averaged over the cards."""


def read(traces, ctx):
    shares = [1.0 - t["compute_busy_s"] / t["window_s"] for t in traces if t["window_s"] > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None

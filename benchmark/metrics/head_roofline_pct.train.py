"""The head's share of its roofline in a train step: the least time of the
head's work (``head_work``: its three float32 products over the rank's rows
and classes, and W read twice and its gradient written once) at the float32
peak (the head runs with TF32 off) over the device time of the program's
``train.head`` and ``train.head_backward`` spans, over the traced segment's
steps of rank 0's log. The rows are the span's, the classes its ``counts``;
the work does not depend on how the head is computed (dense, in blocks or
fused), so any implementation is read by the same yardstick. None without
the spans or their counts, or off the card."""

from benchmark.roofline import PEAK_F32, bound_s
from benchmark.spans import calls

SPANS = ("train.head", "train.head_backward")


def head_work(rows: int, dim: int, classes: int) -> tuple[float, float]:
    """(operations, bytes) of a margin CE's forward and backward over
    ``rows`` embeddings of ``dim`` and ``classes`` columns of W: the cosine
    product and its two gradient products, 2 * rows * dim * classes each;
    W's float32 columns read by the forward and the backward, and its
    gradient written."""
    return 6.0 * rows * dim * classes, 3.0 * 4 * dim * classes


def read(traces, ctx):
    need = secs = 0.0
    for s in calls("train.step", traces[0]["calls"]):
        kids = s["children"]
        if not all(kids.get(n, {}).get("device_ms") is not None for n in SPANS):
            continue
        head = kids["train.head"]
        if not head.get("counts") or not head.get("rows"):
            continue
        work = head_work(head["rows"], ctx["config"]["embedding_dim"], head["counts"]["classes"])
        need += bound_s(*work, PEAK_F32)
        secs += sum(kids[n]["device_ms"] for n in SPANS) / 1e3
    return 100.0 * need / secs if secs else None

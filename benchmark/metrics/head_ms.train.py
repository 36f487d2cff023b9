"""Device milliseconds a train step in the head and its CE, forward and
backward: the program's ``train.head`` and ``train.head_backward`` spans
(``crfr_torch.utils.profiling``'s log, read by ``benchmark.spans``; timed
by CUDA events), the mean over the traced segment's steps, from rank 0's
log. None without the spans or off the card."""

from benchmark.spans import calls


def read(traces, ctx):
    ms = [sum(s["children"][n]["device_ms"] for n in ("train.head", "train.head_backward"))
          for s in calls("train.step", traces[0]["calls"])
          if all(s["children"].get(n, {}).get("device_ms") is not None
                 for n in ("train.head", "train.head_backward"))]
    return sum(ms) / len(ms) if ms else None

"""Device milliseconds a train step in the optimizer (``SGDTx.step``: the
gradients' norms, the clip, SGD with momentum and decay): the program's
``train.optimizer`` span (``crfr_torch.utils.profiling``'s log, read by
``benchmark.spans``; timed by CUDA events), the mean over the traced
segment's steps, from rank 0's log. None without the span or off the
card."""

from benchmark.spans import calls


def read(traces, ctx):
    ms = [s["children"]["train.optimizer"]["device_ms"]
          for s in calls("train.step", traces[0]["calls"])
          if s["children"].get("train.optimizer", {}).get("device_ms") is not None]
    return sum(ms) / len(ms) if ms else None

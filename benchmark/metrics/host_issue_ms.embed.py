"""Host milliseconds a serving call: the mean duration of the program's
``embed.call`` span (``crfr_torch.utils.profiling``'s log, read by
``benchmark.spans``; the serving callable of
``eval/extract.py::make_extract_fn``) over the traced segment's calls.
While the call is host-paced, as it is at this cell's batch (the device
waits on its launches), this is the host's issue time a call; a call the
device paced would read the device's pace. Only a call on a card is read
(its span holds CUDA events): on the CPU the host computes the call
itself, and there is no issue to time. None where the program has no such
span."""

from benchmark.spans import calls


def read(traces, ctx):
    cs = [c for c in calls("embed.call", traces[0]["calls"]) if c["device_ms"] is not None]
    return sum(c["host_ms"] for c in cs) / len(cs) if cs else None

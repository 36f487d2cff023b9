"""The share of the device's time over the traced segment's serving calls
that falls between calls: the sum, over consecutive calls, of the device
milliseconds from one ``embed.call`` span's end event to the next one's
start event (``crfr_torch.utils.profiling``'s log, read by
``benchmark.spans``; CUDA events on the call's stream), over the device
milliseconds from the first call's start event to the last one's end
event. A call issued while the device still works on the one before adds
nothing; a device that ran dry between calls adds its wait on the caller.
None without the span or off the card."""

from benchmark.spans import calls


def read(traces, ctx):
    cs = calls("embed.call", traces[0]["calls"])
    if len(cs) < 2 or any(c["device_ms"] is None for c in cs):
        return None
    between = sum(b["device_start_ms"] - a["device_end_ms"] for a, b in zip(cs, cs[1:]))
    return 100.0 * between / (cs[-1]["device_end_ms"] - cs[0]["device_start_ms"])

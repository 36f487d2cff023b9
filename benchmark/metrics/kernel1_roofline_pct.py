"""Kernel 1, the int-low form of the preprocessing kernel: the least time
of its work (``roofline.degrade_work_int``: the batch's uint8 pixels in, its
normalized pixels out at the compute dtype, the taps of the degrade) over
the device time of its launches, for every traced call on every card."""

from benchmark.roofline import bound_s, degrade_work_int
from benchmark.trace import kernel_s

KERNELS = ("resample_normalize_kernel",)


def read(traces, ctx):
    c, t = ctx["config"], ctx["traffic"]
    bound = bound_s(*degrade_work_int(t["batch"], c["input_size"], t["degrade_to"], 3,
                                      c["resize_mode"], 1, 2))
    need = secs = 0.0
    for tr in traces:
        s, n = kernel_s(tr, KERNELS)
        if n:
            need += tr["calls"] * bound
            secs += s
    return 100.0 * need / secs if secs else None

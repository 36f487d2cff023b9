"""Kernel 1', the preprocessing kernel with a low per image: the least time
of each traced step's work on each card (``roofline.degrade_work``: the
rank's uint8 pixels and lows in, its normalized pixels out at the compute
dtype, the taps of each image's degrade) over the device time of its
launches."""

from benchmark.roofline import bound_s, degrade_work
from benchmark.trace import kernel_s

KERNELS = ("degrade_lows_kernel",)


def read(traces, ctx):
    c = ctx["config"]
    need = secs = 0.0
    for tr in traces:
        s, n = kernel_s(tr, KERNELS)
        if n:
            need += sum(bound_s(*degrade_work(c["input_size"], lows, 3, c["resize_mode"], 1, 2))
                        for lows in tr["info"]["lows"])
            secs += s
    return 100.0 * need / secs if secs else None

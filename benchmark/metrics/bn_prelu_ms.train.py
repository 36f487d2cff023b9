"""Device milliseconds a train step in the backbone's BatchNorm and PReLU
kernels, forward and backward (cuDNN's and ATen's kernels by name), averaged
over the cards."""

from benchmark.trace import kernel_s

KERNELS = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "prelu")


def read(traces, ctx):
    ms = [1e3 * kernel_s(tr, KERNELS)[0] / tr["calls"] for tr in traces
          if kernel_s(tr, KERNELS)[1]]
    return sum(ms) / len(ms) if ms else None

"""The CPU yardstick of the bench (crfr/bench/torch_reference.py): the
pipeline a PyTorch user would run on the host, PIL bicubic 112→16→112
probe degradation, (x − 127.5)/128 and a torch-CPU IR-50 eval forward.
``bench.py`` divides the card's images/s by this pipeline's.

It runs on the CPU by design: it is the yardstick, not a device path.
The measured images/s is cached in ``_CACHE`` (``.bench_cpu_baseline.json``
at the repo root, the file ``crfr``'s copy keeps) under ``crfr``'s key
``torch{version}-b{batch}-t{threads}``, so one host keeps one reading for
the one pipeline whichever package measured it. PIL (the pillow package)
is needed only to measure; where it is not installed, a measurement raises
an error that names it.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".bench_cpu_baseline.json")


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the CPU reference degrades its probes with PIL's bicubic resize: "
                          "it needs PIL (the pillow package), which is not installed") from e
    return Image


def _build_torch_ir50():
    """IR-50 in plain ``torch.nn``, eval mode, torch's default init: the
    module tree (and so the state-dict keys) of ``crfr``'s yardstick."""
    import torch.nn as tnn

    class Bottleneck(tnn.Module):
        def __init__(self, in_ch, out_ch, stride):
            super().__init__()
            self.res = tnn.Sequential(
                tnn.BatchNorm2d(in_ch),
                tnn.Conv2d(in_ch, out_ch, 3, 1, 1, bias=False),
                tnn.PReLU(out_ch),
                tnn.Conv2d(out_ch, out_ch, 3, stride, 1, bias=False),
                tnn.BatchNorm2d(out_ch))
            self.short = (None if in_ch == out_ch and stride == 1 else
                          tnn.Sequential(
                              tnn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                              tnn.BatchNorm2d(out_ch)))

        def forward(self, x):
            sc = x if self.short is None else self.short(x)
            return self.res(x) + sc

    class IR50(tnn.Module):
        def __init__(self):
            super().__init__()
            self.inp = tnn.Sequential(tnn.Conv2d(3, 64, 3, 1, 1, bias=False),
                                      tnn.BatchNorm2d(64), tnn.PReLU(64))
            blocks, in_ch = [], 64
            for ch, units in [(64, 3), (128, 4), (256, 14), (512, 3)]:
                for u in range(units):
                    blocks.append(Bottleneck(in_ch, ch, 2 if u == 0 else 1))
                    in_ch = ch
            self.body = tnn.Sequential(*blocks)
            self.out = tnn.Sequential(tnn.BatchNorm2d(512), tnn.Flatten(),
                                      tnn.Linear(512 * 49, 512),
                                      tnn.BatchNorm1d(512))

        def forward(self, x):
            return self.out(self.body(self.inp(x)))

    m = IR50()
    m.eval()
    return m


def measure_cpu_reference(batch: int = 32, iters: int = 3, use_cache: bool = True) -> float:
    """Images/s of the CPU reference pipeline (PIL degrade + torch IR-50),
    from the cache when ``use_cache`` and it holds this host's key."""
    import torch

    key = f"torch{torch.__version__}-b{batch}-t{torch.get_num_threads()}"
    if use_cache and os.path.exists(_CACHE):
        try:
            with open(_CACHE) as f:
                cache = json.load(f)
            if key in cache:
                return float(cache[key])
        except (ValueError, OSError):
            pass

    Image = _pil()
    model = _build_torch_ir50()
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(batch, 112, 112, 3)).astype(np.uint8)

    with torch.no_grad():                            # warmup
        model(torch.zeros(2, 3, 112, 112))

    t0 = time.perf_counter()
    for _ in range(iters):
        batch_np = np.empty((batch, 112, 112, 3), np.float32)
        for i in range(batch):
            im = Image.fromarray(imgs[i]).resize((16, 16), Image.BICUBIC)
            batch_np[i] = np.asarray(im.resize((112, 112), Image.BICUBIC), np.float32)
        x = (torch.from_numpy(batch_np).permute(0, 3, 1, 2) - 127.5) / 128.0
        with torch.no_grad():
            model(x)
    ips = batch * iters / (time.perf_counter() - t0)

    try:
        cache = {}
        if os.path.exists(_CACHE):
            with open(_CACHE) as f:
                cache = json.load(f)
        cache[key] = ips
        with open(_CACHE, "w") as f:
            json.dump(cache, f)
    except (ValueError, OSError):
        pass
    return ips

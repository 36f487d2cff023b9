"""Driver ``embed``: the serving callable, ``serve.build_serving_fn`` over a
trainer's backbone (as ``python -m crfr_torch extract`` builds it), on
batches of raw uint8 images taken in turn from a pool made on the card.

Each call degrades a batch to the traffic's low and back, normalizes it
(kernel 1) and embeds it with the backbone in the configuration's compute
dtype. Calls go back to back with no fence; every output is kept. The
check compares every output of the window with the reference's embedding
of the same images: the worst row's ``||e - e_ref|| / ||e_ref||`` is
``embed_gap``. The control is the program's own lower-precision path, the
int8 backbone (``models.quant``, calibrated as the CLI's ``--int8``
calibrates), in the same serving callable.
"""

from __future__ import annotations

import gc

import torch

from benchmark import faults
from benchmark.inputs import make_pool, make_weights
from benchmark.program import load_weights, program_config
from benchmark.reference.train import embed as reference_embed
from benchmark.roofline import forward_flops


def images_per_call(cell) -> int:
    return cell.traffic["batch"]


def flops_per_call(cell) -> float:
    c = cell.config
    return forward_flops(c["backbone"], cell.traffic["batch"], c["input_size"],
                         c["embedding_dim"])


class Driver:
    KIND = "embed"

    def __init__(self, cell, seed: int, rt, fault: str | None):
        self.cell, self.seed, self.device = cell, seed, rt.device
        self.pool = make_pool(seed, cell.traffic["pool"], cell.traffic["batch"],
                              cell.config["input_size"], rt.device)["images"]
        self.trainer, self.fn = self._program()
        self.outs: list[torch.Tensor] = []
        self.calls = 0
        if fault:
            faults.apply(fault, self)
        self.call()                                  # the one shape this cell runs

    def _program(self, int8: bool = False):
        from crfr_torch.serve import build_serving_fn
        from crfr_torch.train.loop import Trainer

        c, t = self.cell.config, self.cell.traffic
        tr = Trainer(program_config(self.cell, self.seed), device=self.device)
        params, stats = make_weights(c, self.seed, self.device)
        load_weights(tr, params, stats)
        del params, stats
        apply = lambda x: tr.backbone_apply(tr.model.backbone, x)           # noqa: E731
        if int8:
            from crfr_torch.models.quant import calibration_batch, quantize_backbone

            calib = [calibration_batch(self.pool[i, :32], t["degrade_to"], c["resize_mode"],
                                       self.device) for i in range(2)]
            q = quantize_backbone(tr.model.backbone, calib, compute_dtype=tr.compute_dtype)
            apply = lambda x: q(x).float()                                  # noqa: E731
        fn = build_serving_fn(apply, degrade_to=t["degrade_to"], resize_mode=c["resize_mode"],
                              image_size=c["input_size"], device=self.device)
        return tr, fn

    def call(self) -> None:
        self.outs.append(self.fn(self.pool[self.calls % len(self.pool)]))
        self.calls += 1

    def segment_info(self, first: int, count: int) -> dict:
        return {}

    def _gaps(self, outs, first: int) -> torch.Tensor:
        """The worst row's gap of each output against the reference."""
        n = len(self.pool)
        gaps = []
        for j, o in enumerate(outs):
            r = self.ref[(first + j) % n]
            g = ((o - r).norm(dim=1) / r.norm(dim=1)).max()
            gaps.append(torch.where(torch.isfinite(g), g, torch.full_like(g, float("inf"))))
        return torch.stack(gaps).cpu()

    def check(self, first: int, n: int) -> tuple[dict, int, int]:
        outs = self.outs[first:first + n]
        self.outs = []
        del self.fn, self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        c, t = self.cell.config, self.cell.traffic
        params, stats = make_weights(c, self.seed, self.device)
        p, b = self.pool.shape[:2]
        self.ref = reference_embed(params, stats, self.pool.flatten(0, 1), t["degrade_to"],
                                   c).view(p, b, -1)
        gaps = self._gaps(outs, first)
        failed = int(sum(not bool(torch.isfinite(o).all()) for o in outs))
        self.detail = {"embed_gap": float(gaps.max()), "calls": len(outs)}
        return {"embed_gap": self.detail["embed_gap"]}, n, failed

    def reserve(self, calls: int) -> None:
        """Grow the allocator's cache to hold ``calls`` more outputs, so that
        keeping them allocates nothing inside the window."""
        out = self.outs[-1]
        held = [torch.empty_like(out) for _ in range(calls)]
        del held

    def planted(self) -> dict:
        """The control: the int8 backbone in the same callable, over the pool."""
        self.trainer, self.fn = self._program(int8=True)
        outs = [self.fn(self.pool[i]) for i in range(len(self.pool))]
        del self.fn, self.trainer
        return {"control": {"embed_gap": float(self._gaps(outs, 0).max())}}

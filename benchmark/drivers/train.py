"""Driver ``train``: ``Trainer.train_step`` on global batches taken in turn
from a pool made on the card: uint8 images, labels uniform over the
classes, and a low per image uniform over the configuration's range, passed
as ``lows`` (the trainer degrades each image to its own low in one launch).
On a mesh each rank passes the global batch and keeps its rows.

Set-up builds the one trainer, puts the harness's weights in, and drives it
through its first ``CHECK_STEPS`` calls: the call and the feed that the
window drives, on the pool's first batches (their rows all differ), at the
schedule's first learning rates (0, then 1e-4 and 2e-4 for 0.1 warmed up
over 1,000 steps). It keeps the momentum after the first step (the first
gradient as the optimizer got it) and the parameters after the last. The
window then goes on with the same trainer; of the window's own steps the
check holds only that every loss is finite.

The check runs the reference over the same batches from the same weights,
and reads (rank 0):

- ``loss_gap``: the worst step's |loss - loss_ref| / |loss_ref|;
- ``grad_gap``: the worst leaf's | ||g|| - ||g_ref|| | of the first
  gradient, over the larger of ||g_ref|| and the median leaf's;
- ``change_gap``: the same of each leaf's change over the steps;
- ``grad_median``, ``change_median``: the median leaf's gaps;
- ``grad_diff_median``, ``change_diff_median``: the median leaf's
  ||g - g_ref|| over the same denominator, and the same of the change.
  They hold nearly still from seed to seed and part the program's rounding
  from a precision below it, where the gaps of norms do not.

The cell's limits file names the readings that are compared.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a bias under a batch norm) move by rounding alone and are left out of both.
"""

from __future__ import annotations

import gc
import statistics

import torch

from benchmark import faults
from benchmark.inputs import make_pool, make_weights
from benchmark.program import load_weights, program_config, steps_per_epoch
from benchmark.reference.irse import decayed
from benchmark.reference.train import train_steps
from benchmark.roofline import train_flops

CHECK_STEPS = 3


def images_per_call(cell) -> int:
    return cell.traffic["batch"]


def flops_per_call(cell) -> float:
    c = cell.config
    return train_flops(c["backbone"], cell.traffic["batch"], c["num_classes"],
                       c["input_size"], c["embedding_dim"])


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def _leaf_gaps(side: dict, ref: dict, keep) -> dict:
    ref_n = {n: _norm(ref[n]) for n in keep}
    med = statistics.median(ref_n.values())
    return {n: abs(_norm(side[n]) - ref_n[n]) / max(ref_n[n], med) for n in keep}


def _leaf_diffs(side: dict, ref: dict, keep) -> dict:
    ref_n = {n: _norm(ref[n]) for n in keep}
    med = statistics.median(ref_n.values())
    return {n: _norm(side[n] - ref[n]) / max(ref_n[n], med) for n in keep}


def train_numbers(side: dict, ref: dict, w0: dict) -> dict:
    """``side`` and ``ref``: {"losses", "grads" (the first step's, raw),
    "params" (after the steps)} → the three gaps, and beside them what the
    limits were set from: the median leaf's gaps and the worst leaves."""
    g_ref = {n: _norm(g) for n, g in ref["grads"].items()}
    med = statistics.median(g_ref.values())
    keep = [n for n, v in g_ref.items() if v >= 1e-3 * med]
    losses = [abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"])]
    grad = _leaf_gaps(side["grads"], ref["grads"], keep)
    change = _leaf_gaps({n: side["params"][n] - w0[n] for n in keep},
                        {n: ref["params"][n] - w0[n] for n in keep}, keep)
    gdiff = _leaf_diffs(side["grads"], ref["grads"], keep)
    cdiff = _leaf_diffs({n: side["params"][n] - w0[n] for n in keep},
                        {n: ref["params"][n] - w0[n] for n in keep}, keep)
    worst = lambda gaps: sorted(gaps.items(), key=lambda kv: -kv[1])[:3]   # noqa: E731
    return {"loss_gap": max(losses), "grad_gap": max(grad.values()),
            "change_gap": max(change.values()), "loss_gaps": losses,
            "grad_median": statistics.median(grad.values()),
            "change_median": statistics.median(change.values()),
            "grad_diff_median": statistics.median(gdiff.values()),
            "change_diff_median": statistics.median(cdiff.values()),
            "grad_worst": worst(grad), "change_worst": worst(change),
            "left_out": sorted(set(g_ref) - set(keep))}


def reference_config(cell) -> dict:
    c = cell.config
    return {k: c[k] for k in ("backbone", "input_size", "dropout", "scale", "margin",
                              "ce_block", "lr", "warmup_steps", "momentum", "weight_decay",
                              "resize_mode")}


class Driver:
    KIND = "train"

    def __init__(self, cell, seed: int, rt, fault: str | None):
        from crfr_torch.train.loop import Trainer

        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.device, self.rank = cell, seed, rt.device, rt.rank
        self.world = t["layout"][0] * t["layout"][1]
        self.trainer = Trainer(program_config(cell, seed), steps_per_epoch(cell),
                               device=rt.device)
        params, stats = make_weights(c, seed, rt.device)
        load_weights(self.trainer, params, stats)
        del params, stats
        self.pool = self._pool()
        self.losses: list[torch.Tensor] = []
        self.calls = 0
        if fault:
            faults.apply(fault, self)
        names = {id(p): n for n, p in self.trainer.model.named_parameters()}
        self.opt_names = [names[id(p)] for g in self.trainer.tx.opt.param_groups
                          for p in g["params"]]
        self.call()
        self.momentum = self._momentum()
        for _ in range(CHECK_STEPS - 1):
            self.call()
        self.after = self._params()

    def _pool(self) -> dict:
        c, t = self.cell.config, self.cell.traffic
        return make_pool(self.seed, t["pool"], t["batch"], c["input_size"], self.device,
                         classes=c["num_classes"], lows=(c["degrade_min"], c["degrade_max"]))

    def call(self) -> None:
        k = self.calls % self.pool["images"].shape[0]
        m = self.trainer.train_step(self.pool["images"][k], self.pool["labels"][k],
                                    lows=self.pool["lows"][k])
        self.losses.append(m["loss"])
        self.calls += 1

    def _momentum(self) -> dict:
        st = self.trainer.state                       # a collective on a mesh
        if self.rank != 0:
            return {}
        bufs = {self.opt_names[i]: s["momentum_buffer"].clone()
                for i, s in st["opt"]["state"].items() if "momentum_buffer" in s}
        return {n: bufs.get(n, torch.zeros_like(p))
                for n, p in st["model"].items() if n in self.opt_names}

    def _params(self) -> dict:
        st = self.trainer.state
        if self.rank != 0:
            return {}
        return {n: st["model"][n].clone() for n in self.opt_names}

    def segment_info(self, first: int, count: int) -> dict:
        """This rank's lows of each traced call."""
        b = self.pool["lows"].shape[1] // self.world
        n = self.pool["lows"].shape[0]
        return {"lows": [self.pool["lows"][(first + j) % n, self.rank * b:(self.rank + 1) * b]
                         .tolist() for j in range(count)]}

    def check(self, first: int, n: int) -> tuple[dict, int, int]:
        losses = torch.stack(self.losses).float().cpu()
        failed = int((~torch.isfinite(losses[first:first + n])).sum())
        wd = self.cell.config["weight_decay"]
        del self.trainer, self.pool, self.losses
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.w0, _ = make_weights(self.cell.config, self.seed, self.device)
        pool = self._pool()
        self.batches = [(pool["images"][k], pool["labels"][k], pool["lows"][k].cpu().numpy())
                        for k in range(CHECK_STEPS)]
        del pool
        grads = {n: b - wd * self.w0[n] if decayed(n) else b for n, b in self.momentum.items()}
        side = {"losses": losses[:CHECK_STEPS].tolist(), "grads": grads, "params": self.after}
        del self.momentum, self.after
        self.ref = self._reference()
        self.detail = train_numbers(side, self.ref, self.w0)
        return {k: self.detail[k] for k in self.cell.limits}, n, failed

    def _reference(self, **kw) -> dict:
        return train_steps(self.w0, self.batches, reference_config(self.cell), self.seed,
                           remat=self.device.type == "cuda", **kw)

    def planted(self) -> dict:
        """The readings of the control (the reference in FP8) and of the
        faults planted in the reference: half of each batch left out; on a
        mesh, no exchange between ranks (rank 0's rows alone, their share)."""
        b = self.batches[0][0].shape[0]
        out = {"control": train_numbers(self._reference(quant="fp8"), self.ref, self.w0),
               "half_batch": train_numbers(self._reference(rows=slice(0, b // 2)), self.ref,
                                           self.w0)}
        if self.world > 1:
            out["no_exchange"] = train_numbers(
                self._reference(rows=slice(0, b // self.world), share=True), self.ref, self.w0)
        return out

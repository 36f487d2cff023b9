"""Faults planted under a driver's timed path, for the tests that show the
check catches them (``run.py --fault NAME``). The benchmark's own runs plant
none."""

from __future__ import annotations

import torch


def _frozen_state(d) -> None:
    """A train step that leaves the parameters and the optimizer as they were."""
    d.trainer.tx.opt.step = lambda *a, **k: None


def _half_batch_train(d) -> None:
    """The loss of half of each rank's rows, the mean taken over them."""
    loss = d.trainer._loss
    d.trainer._loss = lambda emb, y: loss(emb[:emb.shape[0] // 2], y[:y.shape[0] // 2])


def _no_exchange(d) -> None:
    """Each rank updates from its own gradients: no sum over the ranks."""
    d.trainer._sync_grads = lambda: None


def _half_batch_embed(d) -> None:
    """Only the first half of each batch embedded; the rest left zero."""
    fn = d.fn

    def half(images):
        b = images.shape[0]
        out = fn(images[:b // 2])
        return torch.cat([out, torch.zeros_like(out)])[:b]

    d.fn = half


def _altered_answer(d) -> None:
    """One embedding of each batch altered where it is produced."""
    fn = d.fn

    def altered(images):
        out = fn(images).clone()
        out[0] = out[0].flip(0)
        return out

    d.fn = altered


FAULTS = {
    ("train", "frozen_state"): _frozen_state,
    ("train", "half_batch"): _half_batch_train,
    ("train", "no_exchange"): _no_exchange,
    ("embed", "half_batch"): _half_batch_embed,
    ("embed", "altered_answer"): _altered_answer,
}


def apply(name: str, driver) -> None:
    key = (driver.KIND, name)
    if key not in FAULTS:
        raise KeyError(f"no fault {name!r} for a {driver.KIND} driver")
    FAULTS[key](driver)

"""SGD with momentum and L2 weight decay, as the ArcFace recipe trains: the
decay is added to the gradient before the momentum,
``buf = momentum * buf + (g + wd * w)`` (the first step's ``buf`` is
``g + wd * w``), then ``w -= lr * buf``. The learning rate warms up
linearly from 0 over ``warmup`` steps, then drops by ``factor`` at each
boundary (counted from the end of the warm-up)."""

from __future__ import annotations

import torch


def learning_rate(step: int, lr: float, warmup: int, boundaries=(), factor: float = 0.1
                  ) -> float:
    if step < warmup:
        return lr * step / warmup
    return lr * factor ** sum(step - warmup >= b for b in boundaries)


@torch.no_grad()
def sgd_step(params: dict, grads: dict, bufs: dict, lr: float, momentum: float, wd: float,
             decayed) -> None:
    """One update of ``params`` in place; ``bufs`` holds the momentum."""
    for name, w in params.items():
        d = grads[name] + wd * w if decayed(name) else grads[name].clone()
        bufs[name] = d if name not in bufs else bufs[name].mul_(momentum).add_(d)
        w.sub_(lr * bufs[name])

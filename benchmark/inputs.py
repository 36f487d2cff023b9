"""Weights and traffic made on the device from ``--seed``, in a few large calls.

The same seed gives the same tensors on any CUDA card (Philox), so the
harness makes them again for the reference once the program is gone.
Weights: conv and linear weights normal with variance 1/fan-in, biases 0,
BN scales 1 and shifts 0 (running mean 0, variance 1), PReLU slopes 0.25,
the head's W uniform in +-sqrt(6 / (D + C)): the published initialisers.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.irse import fan_in, param_specs

_POOL_STREAM = 1 << 62      # the pool's generator is seeded apart from the weights'


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """→ (parameters by name, BN running statistics by name), float32."""
    specs = param_specs(cfg["backbone"], cfg["embedding_dim"], cfg["input_size"],
                        cfg["num_classes"])
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict[str, torch.Tensor] = {}
    normal = [(n, s) for n, s, init in specs if init == "lecun"]
    flat = torch.randn(sum(math.prod(s) for _, s in normal), generator=gen, device=device)
    off = 0
    for n, s in normal:
        k = math.prod(s)
        params[n] = flat[off:off + k].view(s).mul_(fan_in(s) ** -0.5)
        off += k
    for n, s, init in specs:
        if init == "xavier":
            a = math.sqrt(6.0 / (s[0] + s[1]))
            params[n] = torch.rand(s, generator=gen, device=device).mul_(2 * a).sub_(a)
        elif init != "lecun":
            value = {"zeros": 0.0, "ones": 1.0, "prelu": 0.25}[init]
            params[n] = torch.full(s, value, device=device)
    stats = {}
    for n, s, init in specs:
        if init == "ones":                        # a BN's scale
            bn = n.removesuffix(".weight")
            stats[f"{bn}.running_mean"] = torch.zeros(s, device=device)
            stats[f"{bn}.running_var"] = torch.ones(s, device=device)
    return {n: params[n] for n, _, _ in specs}, stats


def make_pool(seed: int, count: int, batch: int, size: int, device, classes: int = 0,
              lows: tuple[int, int] | None = None) -> dict:
    """``count`` batches of ``batch`` uint8 (size, size, 3) images, with
    labels uniform over ``classes`` and a low per image uniform in ``lows``
    when those are given."""
    gen = torch.Generator(device=device).manual_seed(seed + _POOL_STREAM)
    out = {"images": torch.randint(0, 256, (count, batch, size, size, 3), generator=gen,
                                   device=device, dtype=torch.uint8)}
    if classes:
        out["labels"] = torch.randint(0, classes, (count, batch), generator=gen, device=device)
    if lows is not None:
        out["lows"] = torch.randint(lows[0], lows[1] + 1, (count, batch), generator=gen,
                                    device=device, dtype=torch.int32)
    return out

"""Carry the JAX backbone's weights into ``crfr_torch.models.irse``.

``params_from_jax`` takes the parameters and BN statistics of a
``crfr.models.irse.IRBackbone`` as numpy arrays, keyed by their nnx state
paths joined with '/' (``blocks/3/conv1/kernel``, ``out_linear/kernel``,
``input_bn/mean``, ...), and returns a ``state_dict`` for the port's
``IRBackbone``. The port keeps the reference's module names, so only the
leaf names and layouts change:

- conv ``kernel`` (kh, kw, I, O) → ``weight`` (O, I, kh, kw)
- linear ``kernel`` (I, O) → ``weight`` (O, I); ``out_linear`` needs no
  flatten permutation, because the port flattens an NHWC view
- BN ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var`` (+ ``num_batches_tracked`` = 0)
- PReLU ``alpha`` → ``weight``
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def params_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        *mods, leaf = path.split("/")
        prefix = ".".join(mods)
        arr = np.array(value, dtype=np.float32)        # a writable copy
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{path}: kernel of rank {arr.ndim}")
            name = "weight"
        elif leaf in _BN_LEAVES:
            name = _BN_LEAVES[leaf]
            if leaf == "mean":
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        elif leaf == "alpha":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"{path}: no counterpart in crfr_torch")
        sd[f"{prefix}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd

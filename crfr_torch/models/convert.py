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

``train_state_from_jax`` does the same for a ``crfr`` ``Trainer``'s
``params`` and ``batch_stats`` (paths ``backbone/...`` and ``head/weight``):
a ``state_dict`` for ``crfr_torch.train.loop.FaceTrainModel``, the head's
W kept as (D, C), or with ``shard`` (a ``parallel.mesh.Sharding``, e.g.
``class_sharding(mesh)``) as this rank's class shard of it: the state of
``crfr``'s trainer on a (data, model) mesh lands in the rank that holds
the same columns. ``student_state_from_jax`` does it for the distilled
student (``crfr.train.distill_loop.StudentModel``), whose residual branch
adds ``residual/fc1/kernel`` and ``residual/fc2/kernel`` (transposed),
their biases, ``residual/prelu/alpha`` and the BN's scale, bias and
statistics: a ``state_dict`` for ``crfr_torch.train.distill_loop.StudentModel``.

``quant_state_from_jax`` does it for a backbone quantized by
``crfr.models.quant.quantize_backbone``: each ``QuantConv``'s ``w8`` (kh, kw,
I, O) int8 → (O, I, kh, kw), its ``sw``, ``sx`` and ``bias`` as float32, the
rest through ``params_from_jax``: a ``state_dict`` for the port's
``models.quant.quantize_backbone`` of the same backbone.

The SR networks need no converter of their own: ``crfr_torch.models.sr``
keeps ``crfr.models.sr``'s module names and leaves, so ``params_from_jax``
carries a ``Hallucinator``'s state (``coarse/body/0/c1/conv/kernel``,
``coarse/ups/0/bias``, ``prior/hg/skip/0/...``, ``gen/out/kernel``) and a
``Discriminator``'s (``layers/0/conv/bias``, ``layers/1/bn/mean``,
``fc/kernel``) as it stands, and so does it a ``MobileFaceNet``'s
(``blocks/0/depthwise/conv/kernel``, a grouped (3, 3, 1, C) kernel that
becomes (C, 1, 3, 3) by the same transpose; ``gdconv/kernel``,
``out_linear/kernel``, ``out_bn/mean``).

``mtcnn_state_from_jax`` does it for the three nets of a ``crfr`` ``MTCNN``
(paths ``pnet/conv1/kernel``, ``rnet/fc/kernel``, ``onet/prelu5/alpha``):
a ``state_dict`` for ``crfr_torch.models.mtcnn.MTCNN``. R/O-net's first
linear layer needs no flatten permutation either: both stacks flatten
H·W·C.
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


def train_state_from_jax(flat: Mapping[str, np.ndarray],
                         modules: tuple[str, ...] = ("backbone",),
                         shard=None) -> dict[str, torch.Tensor]:
    """A ``crfr`` trainer's parameters and BN statistics, keyed by their
    '/'-joined nnx paths, → ``FaceTrainModel.state_dict()``: the submodules
    ``modules`` through ``params_from_jax``, and the head's W (this rank's
    columns of it with ``shard``)."""
    sd: dict[str, torch.Tensor] = {}
    taken = {"head/weight"}
    for mod in modules:
        part = {k[len(mod) + 1:]: v for k, v in flat.items() if k.startswith(f"{mod}/")}
        taken |= {f"{mod}/{k}" for k in part}
        sd.update({f"{mod}.{k}": v for k, v in params_from_jax(part).items()})
    rest = set(flat) - taken
    if rest:
        raise KeyError(f"{sorted(rest)}: no counterpart in crfr_torch")
    w = np.array(flat["head/weight"], dtype=np.float32)
    if shard is not None:
        w = np.ascontiguousarray(shard.local(w))
    sd["head.weight"] = torch.from_numpy(w)
    return sd


def student_state_from_jax(flat: Mapping[str, np.ndarray], shard=None
                           ) -> dict[str, torch.Tensor]:
    """A ``crfr`` ``StudentModel``'s parameters and BN statistics →
    ``distill_loop.StudentModel.state_dict()`` (W's ``shard`` as above)."""
    return train_state_from_jax(flat, ("backbone", "residual"), shard)


_QUANT_LEAVES = ("w8", "sw", "sx", "bias")


def quant_state_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A quantized ``crfr`` backbone's parameters, BN statistics and
    ``QuantConv`` tensors, keyed by their '/'-joined nnx paths → the
    port's quantized backbone's ``state_dict``."""
    quant = {p.rpartition("/")[0] for p in flat if p.endswith("/w8")}
    sd: dict[str, torch.Tensor] = {}
    rest = {}
    for path, value in flat.items():
        prefix, _, leaf = path.rpartition("/")
        if prefix not in quant:
            rest[path] = value
            continue
        if leaf not in _QUANT_LEAVES:
            raise KeyError(f"{path}: no counterpart in crfr_torch")
        arr = np.asarray(value)
        if leaf == "w8":
            arr = arr.astype(np.int8).transpose(3, 2, 0, 1)
        else:
            arr = arr.astype(np.float32)
        sd[f"{prefix.replace('/', '.')}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(arr))
    sd.update(params_from_jax(rest))
    return sd


_MTCNN_NETS = ("pnet", "rnet", "onet")


def mtcnn_state_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A ``crfr`` ``MTCNN``'s parameters, keyed by their '/'-joined paths
    under ``pnet``, ``rnet`` and ``onet`` → ``models.mtcnn.MTCNN.state_dict()``:
    conv kernels (kh, kw, I, O) → (O, I, kh, kw), linear kernels transposed,
    PReLU ``alpha`` → ``weight``."""
    stray = sorted(k for k in flat if k.split("/")[0] not in _MTCNN_NETS)
    if stray:
        raise KeyError(f"{stray}: not under {_MTCNN_NETS}")
    return params_from_jax(flat)

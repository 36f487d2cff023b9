"""face.evoLVe state dicts ↔ ``models.irse.IRBackbone`` (crfr/train/torch_import.py).

face.evoLVe's ``model_irse.py`` names its modules:

    input_layer.0/1/2           Conv, BN, PReLU
    body.<i>.res_layer.0..4     BN, Conv, PReLU, Conv, BN   (+ .5.fc1/.5.fc2 SE convs)
    body.<i>.shortcut_layer.0/1 Conv, BN                    (where present)
    output_layer.0/3/4          BN2d, Linear, BN1d
    (output_layer.1/2 are Dropout and Flatten, without state)

The port's modules are torch's too, so convs, BNs and PReLUs carry across as
they are. Two differ: the SE's 1×1 convs (O, I, 1, 1) are ``nn.Linear``
weights (O, I) here, and ``output_layer.3`` reads its input flattened in
NCHW order, where ``IRBackbone`` flattens H·W·C (``models/irse.py``), so its
columns are permuted. Values are copied in the module's own dtype.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from crfr_torch.models.irse import IRBackbone


def _t(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _copy(dst: torch.Tensor, src) -> None:
    src = _t(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.dtype))


def _set_bn(bn: nn.Module, sd: Mapping, prefix: str) -> None:
    _copy(bn.weight, sd[f"{prefix}.weight"])
    _copy(bn.bias, sd[f"{prefix}.bias"])
    _copy(bn.running_mean, sd[f"{prefix}.running_mean"])
    _copy(bn.running_var, sd[f"{prefix}.running_var"])


def _flatten_columns(c: int, h: int, w: int) -> torch.Tensor:
    """Column order: entry j of the H·W·C flatten is entry ``perm[j]`` of
    the NCHW (C·H·W) flatten."""
    return torch.arange(c * h * w).reshape(c, h, w).permute(1, 2, 0).reshape(-1)


def load_face_evolve_state_dict(model: IRBackbone, sd: Mapping) -> IRBackbone:
    """Copy a face.evoLVe IR / IR-SE state dict into ``model`` in place."""
    _copy(model.input_conv.weight, sd["input_layer.0.weight"])
    _set_bn(model.input_bn, sd, "input_layer.1")
    _copy(model.input_prelu.weight, sd["input_layer.2.weight"])
    for i, blk in enumerate(model.blocks):
        p = f"body.{i}"
        _set_bn(blk.bn0, sd, f"{p}.res_layer.0")
        _copy(blk.conv1.weight, sd[f"{p}.res_layer.1.weight"])
        _copy(blk.prelu.weight, sd[f"{p}.res_layer.2.weight"])
        _copy(blk.conv2.weight, sd[f"{p}.res_layer.3.weight"])
        _set_bn(blk.bn2, sd, f"{p}.res_layer.4")
        if blk.se is not None:
            for name, lin in (("fc1", blk.se.fc1), ("fc2", blk.se.fc2)):
                w = _t(sd[f"{p}.res_layer.5.{name}.weight"])
                _copy(lin.weight, w[:, :, 0, 0] if w.ndim == 4 else w)
        if blk.shortcut_conv is not None:
            _copy(blk.shortcut_conv.weight, sd[f"{p}.shortcut_layer.0.weight"])
            _set_bn(blk.shortcut_bn, sd, f"{p}.shortcut_layer.1")
    _set_bn(model.out_bn, sd, "output_layer.0")
    w = _t(sd["output_layer.3.weight"])
    c = model.out_bn.num_features
    feat = int(round((w.shape[1] // c) ** 0.5))
    _copy(model.out_linear.weight, w[:, _flatten_columns(c, feat, feat)])
    _copy(model.out_linear.bias, sd["output_layer.3.bias"])
    _set_bn(model.out_feat_bn, sd, "output_layer.4")
    return model


def export_face_evolve_state_dict(model: IRBackbone) -> dict[str, np.ndarray]:
    """The inverse: ``model`` → a face.evoLVe state dict of float32 numpy
    arrays, as ``crfr`` writes it (``output_layer.3`` in NCHW column order;
    SE weights as (O, I) matrices, which the import takes as it takes 1×1
    convs)."""
    sd: dict[str, np.ndarray] = {}

    def put(key: str, t: torch.Tensor) -> None:
        sd[key] = t.detach().to("cpu", torch.float32).contiguous().numpy()

    def bn(prefix: str, b: nn.Module) -> None:
        for name in ("weight", "bias", "running_mean", "running_var"):
            put(f"{prefix}.{name}", getattr(b, name))

    put("input_layer.0.weight", model.input_conv.weight)
    bn("input_layer.1", model.input_bn)
    put("input_layer.2.weight", model.input_prelu.weight)
    for i, blk in enumerate(model.blocks):
        p = f"body.{i}"
        bn(f"{p}.res_layer.0", blk.bn0)
        put(f"{p}.res_layer.1.weight", blk.conv1.weight)
        put(f"{p}.res_layer.2.weight", blk.prelu.weight)
        put(f"{p}.res_layer.3.weight", blk.conv2.weight)
        bn(f"{p}.res_layer.4", blk.bn2)
        if blk.se is not None:
            put(f"{p}.res_layer.5.fc1.weight", blk.se.fc1.weight)
            put(f"{p}.res_layer.5.fc2.weight", blk.se.fc2.weight)
        if blk.shortcut_conv is not None:
            put(f"{p}.shortcut_layer.0.weight", blk.shortcut_conv.weight)
            bn(f"{p}.shortcut_layer.1", blk.shortcut_bn)
    bn("output_layer.0", model.out_bn)
    w = model.out_linear.weight
    c = model.out_bn.num_features
    feat = int(round((w.shape[1] // c) ** 0.5))
    put("output_layer.3.weight", w[:, torch.argsort(_flatten_columns(c, feat, feat))])
    put("output_layer.3.bias", model.out_linear.bias)
    bn("output_layer.4", model.out_feat_bn)
    return sd

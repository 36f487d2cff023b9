"""Serving function and the serving artifact (crfr/serve.py).

``build_serving_fn``: raw pixels → embeddings through the fused kernel.
``build_serving_module``: the same pipeline as an ``nn.Module`` with static
shapes, which ``export_embed`` exports with ``torch.export`` into an
artifact that ``load_embed`` runs with no model code: the weights are the
program's parameters, the preprocessing is one node of the custom op
``crfr_torch::fused_degrade_normalize`` (or ``fused_resize_normalize``
in front of a hallucinator), which launches the hand-written kernel on
the card, and the batch is fixed at export.

    export_embed(trainer, "/models/ir50.crfrt", batch=256, degrade_to=16)
    fn = load_embed("/models/ir50.crfrt")
    emb = fn(raw_uint8_batch)          # (256, 512) f32 on the artifact's device

The file: the 8-byte magic ``CRFRT001``, the meta JSON's length as a
little-endian u32, the meta JSON (``crfr``'s keys; ``platforms`` is
``["cuda"]`` or ``["cpu"]``, the device the program runs on), then the
bytes of ``torch.export.save``. It is not ``crfr``'s StableHLO artifact
(magic ``CRFRX001``), and neither package loads the other's.
"""

from __future__ import annotations

import io
import json
import os
import struct
import warnings
from typing import Callable

import torch
from torch import nn

from crfr_torch.eval.extract import make_extract_fn
from crfr_torch.ops.fused_preprocess import fused_degrade_normalize, fused_resize_normalize
from crfr_torch.ops.normalize import normalize

_MAGIC = b"CRFRT001"
_CRFR_MAGIC = b"CRFRX001"


def build_serving_fn(backbone_apply: Callable, degrade_to: int | None = None,
                     resize_mode: str = "pil", flip_tta: bool = False,
                     image_size: int = 112, sr_apply: Callable | None = None,
                     device: str | torch.device = "cuda") -> Callable:
    """Raw (B, S, S, 3) pixels (uint8/f32, numpy or tensor) → (B, D) f32
    embeddings on ``device``: ``make_extract_fn`` with flip-TTA fused by sum.
    With ``sr_apply`` (a frozen hallucinator, ``train.sr_loop.load_sr_apply``)
    the probe goes ↓``degrade_to`` → G ↑ → backbone."""
    f = make_extract_fn(backbone_apply, degrade_to, resize_mode, flip=flip_tta,
                        flip_fusion="sum", image_size=image_size, sr_apply=sr_apply,
                        device=device)
    return lambda images: f(images).float()


class ServingModule(nn.Module):
    """``build_serving_fn``'s pipeline as a module: (B, S, S, 3) raw pixels
    (a tensor on the module's device) → (B, D) f32. The backbone and the
    hallucinator are submodules, so their weights are the exported
    program's parameters and buffers."""

    def __init__(self, backbone: nn.Module, degrade_to: int | None = None,
                 resize_mode: str = "pil", flip_tta: bool = False, image_size: int = 112,
                 sr: nn.Module | None = None, autocast_dtype: torch.dtype | None = None):
        super().__init__()
        if sr is not None and degrade_to is None:
            raise ValueError("sr needs degrade_to (the LR size)")
        self.backbone = backbone
        self.sr = sr
        self.degrade_to = degrade_to
        self.resize_mode = resize_mode
        self.flip_tta = flip_tta
        self.image_size = image_size
        self.autocast_dtype = autocast_dtype

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, dtype=self.autocast_dtype or torch.bfloat16,
                            enabled=self.autocast_dtype is not None):
            return self.backbone(x).float()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        s = self.image_size
        if images.ndim != 4 or tuple(images.shape[1:]) != (s, s, 3):
            raise ValueError(f"expected (B, {s}, {s}, 3), got {tuple(images.shape)}")
        x = images.contiguous()
        if self.sr is not None:
            lr = fused_resize_normalize(x, (self.degrade_to, self.degrade_to),
                                        self.resize_mode, out_dtype=torch.float32)
            x = self.sr(lr)[0]
        elif self.degrade_to is not None:
            x = fused_degrade_normalize(x, self.degrade_to, self.resize_mode,
                                        out_dtype=torch.float32)
        else:
            x = normalize(x)
        emb = self._embed(x)
        if self.flip_tta:
            emb = emb + self._embed(x.flip(dims=[2]))          # NHWC width axis
        return emb


def build_serving_module(backbone: nn.Module, degrade_to: int | None = None,
                         resize_mode: str = "pil", flip_tta: bool = False,
                         image_size: int = 112, sr: nn.Module | None = None,
                         autocast_dtype: torch.dtype | None = None) -> ServingModule:
    """``build_serving_fn`` as an ``nn.Module`` (``ServingModule``).
    ``backbone``: normalized NHWC pixels → embeddings, run under
    ``torch.autocast(autocast_dtype)`` when that is given (the trainer's
    bf16 compute) and as it is otherwise (a float32 or an int8 backbone);
    ``sr``: a ``Hallucinator`` (its first output is the SR image), which
    needs ``degrade_to``. Call ``.eval()`` before use."""
    return ServingModule(backbone, degrade_to, resize_mode, flip_tta, image_size, sr,
                         autocast_dtype)


def _sr_module(sr_apply) -> nn.Module | None:
    """The hallucinator of ``sr_apply``: a module, or the plug of
    ``train.sr_loop.sr_apply_from_state`` (its ``module``)."""
    if sr_apply is None or isinstance(sr_apply, nn.Module):
        return sr_apply
    module = getattr(sr_apply, "module", None)
    if not isinstance(module, nn.Module):
        raise TypeError("sr_apply must be a Hallucinator or the plug of "
                        "sr_apply_from_state / load_sr_apply")
    return module


def export_embed(trainer, path: str, batch: int = 256, degrade_to: int | None = None,
                 flip_tta: bool = False, input_dtype: torch.dtype = torch.uint8,
                 sr_apply=None, backbone_apply: nn.Module | None = None,
                 quantized: bool = False) -> dict:
    """Export a ``Trainer``'s embed pipeline as a serving artifact at ``path``
    on the trainer's device, and return its meta.

    ``backbone_apply`` replaces the trainer's backbone (which runs in the
    trainer's compute dtype) with a module run as it is, e.g. the int8
    backbone of ``models.quant.quantize_backbone``: pass ``quantized=True``
    so the meta records it. ``sr_apply``: a frozen hallucinator (a module,
    or the plug ``load_sr_apply`` returns) behind a ↓``degrade_to``. The
    modules are exported in eval mode under ``torch.no_grad`` and left in
    the mode they were in."""
    cfg = trainer.cfg
    size = cfg.model.input_size
    if backbone_apply is None:
        backbone = trainer.model.backbone
        autocast_dtype = trainer.compute_dtype if trainer.compute_dtype != torch.float32 \
            else None
    else:
        backbone, autocast_dtype = backbone_apply, None
    module = build_serving_module(backbone, degrade_to, cfg.data.resize_mode, flip_tta, size,
                                  sr=_sr_module(sr_apply), autocast_dtype=autocast_dtype)
    modes = {m: m.training for m in module.modules()}
    example = torch.zeros((batch, size, size, 3), dtype=input_dtype, device=trainer.device)
    try:
        module.eval()
        with torch.no_grad():
            program = torch.export.export(module, (example,))
    finally:
        for m, was in modes.items():
            m.training = was
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # the channels_last conv weights are dense but not contiguous, for
        # which the archive warns that it saves no "complete tensor": it
        # writes each one's whole storage with its strides, and they load
        # back equal (chip_smoke.py's export phase checks device, strides
        # and values on the card)
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, buf)
    meta = {
        "batch": batch, "image_size": size,
        "embedding_dim": cfg.model.embedding_dim,
        "degrade_to": degrade_to, "flip_tta": flip_tta,
        "hallucinated": sr_apply is not None,
        "int8": quantized,
        "input_dtype": str(input_dtype).removeprefix("torch."),
        "platforms": [trainer.device.type],
        "backbone": cfg.model.backbone,
    }
    meta_b = json.dumps(meta).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(meta_b)))
        f.write(meta_b)
        f.write(buf.getvalue())
    return meta


def _read_header(f, path: str) -> dict:
    magic = f.read(8)
    if magic == _CRFR_MAGIC:
        raise ValueError(f"{path}: a crfr (JAX) StableHLO artifact; crfr_torch loads only "
                         "its own (python -m crfr_torch export)")
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a crfr_torch serving artifact")
    (mlen,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(mlen).decode())


def read_meta(path: str) -> dict:
    """The meta of the artifact at ``path``, without loading the program."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def load_embed(path: str) -> Callable:
    """Load a serving artifact → ``call(images)``: raw (batch, S, S, 3)
    pixels, numpy or a tensor, of the artifact's input dtype → (batch, D)
    f32 on the artifact's device; ``call.meta`` is its meta, ``call.program``
    the ``ExportedProgram``. The batch is the static one it was exported
    with; another raises. A CUDA artifact needs a CUDA device and raises
    without one: it never runs on the CPU. The custom ops the program calls
    are registered by importing this module (``crfr_torch.ops``)."""
    with open(path, "rb") as f:
        meta = _read_header(f, path)
        blob = f.read()
    platform = meta["platforms"][0]
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: a CUDA artifact, and there is no CUDA device here; "
                           "export one for the CPU to run it on the CPU")
    device = torch.device(platform)
    program = torch.export.load(io.BytesIO(blob))
    run = program.module()

    def call(images) -> torch.Tensor:
        x = torch.as_tensor(images).to(device)
        with torch.no_grad():
            return run(x)

    call.meta = meta          # type: ignore[attr-defined]
    call.program = program    # type: ignore[attr-defined]
    return call

"""Device resolution and the float32 switch for parity runs."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent. Nothing in the port falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("crfr_torch: no CUDA device available; pass "
                               "device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"crfr_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def device_of(ref, device: str | torch.device | None = None) -> torch.device:
    """Where work on ``ref`` runs: ``device`` when given, else ``ref``'s own
    device when it is a tensor, else CUDA. Raises as ``resolve_device``."""
    if device is None:
        device = ref.device if isinstance(ref, torch.Tensor) else "cuda"
    return resolve_device(device)


def refuse_mesh(mesh, what: str) -> None:
    """Raise ``NotImplementedError`` for a mesh of more than one device: the
    sharded paths are not ported. A mesh of one device (a
    ``torch.distributed.DeviceMesh``, or any object whose ``devices`` array
    has size 1) runs the single-device path, as in ``crfr``; a mesh whose
    size cannot be read raises too."""
    if mesh is None:
        return
    size = getattr(mesh, "size", None)
    n = size() if callable(size) else getattr(getattr(mesh, "devices", None), "size", None)
    if n != 1:
        raise NotImplementedError(f"mesh ({what}) over more than one device is not "
                                  "ported yet; call without it for the single-device path")


@contextlib.contextmanager
def strict_fp32():
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block. cuDNN runs float32 convolutions in TF32 by default, which keeps
    about three decimal digits and alone breaks float32 parity with the
    reference."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved

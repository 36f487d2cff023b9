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


def mesh_world(mesh) -> int:
    """The mesh dispatch: 1 for no mesh or a mesh of one device (the
    single-device path, as in ``crfr``), else the mesh's size, which must be
    the size of the default process group (the sharded paths run one
    process per device). Raises ValueError when the two differ and
    TypeError when the mesh's size cannot be read."""
    from crfr_torch.parallel.mesh import mesh_size, world_size

    n = mesh_size(mesh)
    if n == 1:
        return 1
    if n != world_size():
        raise ValueError(f"a mesh of {n} devices needs a process group of {n} ranks, "
                         f"this one has {world_size()}")
    return n


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

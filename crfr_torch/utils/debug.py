"""Debug-mode switches (crfr/utils/debug.py): NaN and Inf trapping, compile
switches, and a guard against device-to-host synchronisation. Each is opt-in
and restores what it changed when its block leaves, on error too.

    with debug_mode(nans=True):
        trainer.train_step(...)     # a NaN out of any op raises, naming the op

``crfr``'s ``pallas_interpret`` has no counterpart: a CUDA tensor always
takes its hand kernel (the plain PyTorch versions run only for CPU
tensors), so there is no interpreter to force.
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _NonFiniteCheck(TorchDispatchMode):
    """Checks every floating output of every op for NaN (and Inf)."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()) or t.numel() == 0:
                continue
            if self.nans and torch.isnan(t).any():
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and torch.isinf(t).any():
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = False, disable_jit: bool = False,
               log_compiles: bool = False):
    """``nans``/``infs``: every op's floating outputs are checked (each
    check reads a flag back from the device) and the first NaN/Inf raises
    ``FloatingPointError`` naming the op; with ``nans`` autograd's anomaly
    mode also names the backward function that made a NaN.
    ``disable_jit``: ``torch.compile`` runs its functions eagerly
    (dynamo off). ``log_compiles``: ``torch._logging``'s recompile logs."""
    with contextlib.ExitStack() as stack:
        if disable_jit:
            import torch._dynamo as dynamo

            stack.enter_context(dynamo.config.patch(disable=True))
        if log_compiles:
            from torch._logging import _internal

            prev = copy.deepcopy(_internal._get_log_state())

            def _restore_logs():
                _internal._set_log_state(prev)
                _internal._init_logs()

            stack.callback(_restore_logs)
            torch._logging.set_logs(recompiles=True)
        if nans:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        if nans or infs:
            stack.enter_context(_NonFiniteCheck(nans, infs))
        yield


@contextlib.contextmanager
def no_host_transfers():
    """Raise on an operation that synchronises the host with the card
    inside the block (``.item()``, ``.cpu()``, ``.tolist()``, a blocking
    copy): catches accidental syncs on the training hot path
    (``torch.cuda.set_sync_debug_mode("error")``; the previous mode comes
    back after). Without a CUDA device (a CPU build has none) it does
    nothing: there is no device, so no device-to-host copy to stop."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)

"""Build and load the port's CUDA kernels.

The sources under ``crfr_torch/ops/csrc/`` have a plain C interface. At
first use each is compiled with its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library under
``build/crfr_torch_kernels/`` of the checkout, named by a hash of the
sources and flags, and loaded with ``ctypes``. This keeps
PyTorch's headers out of the build: a source that includes them takes
minutes to compile, a plain one seconds. A failed build raises; nothing
falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "fused_preprocess.cu", _CSRC / "bank_scan.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "crfr_torch_kernels"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("crfr_torch kernels: no CUDA toolkit found "
                           "(set CUDA_HOME to a directory with bin/nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crfr_resample_normalize.argtypes = [p, i, p, i, i, i, p, i, i, i, i, p]
    lib.crfr_resample_normalize.restype = i
    lib.crfr_resample_info.argtypes = [i, i, i, i, p, i, i, i, i, p]
    lib.crfr_resample_info.restype = i
    lib.crfr_degrade_lows_normalize.argtypes = [p, i, p, i, i, i, p, p, i, i, p, i, p, p]
    lib.crfr_degrade_lows_normalize.restype = i
    lib.crfr_degrade_lows_info.argtypes = [i, i, i, i, p, i, i, p, p]
    lib.crfr_degrade_lows_info.restype = i
    lib.crfr_resize_two_pass.argtypes = [p, i, p, p, i, i, i, p, p]
    lib.crfr_resize_two_pass.restype = i
    lib.crfr_resize_two_pass_info.argtypes = [i, i, i, i, p, p]
    lib.crfr_resize_two_pass_info.restype = i
    lib.crfr_bank_tilemax.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.crfr_bank_tilemax.restype = i
    lib.crfr_bank_tilemax_tile.argtypes = []
    lib.crfr_bank_tilemax_tile.restype = i
    lib.crfr_bank_tilemax_info.argtypes = [i, i, i, p]
    lib.crfr_bank_tilemax_info.restype = i
    lib.crfr_error_string.argtypes = [i]
    lib.crfr_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def _compile_and_link(so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    tag = f"{so.stem}.{os.getpid()}"
    objs = [so.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    tmp = so.with_name(f"{tag}.tmp")
    nvcc = _nvcc()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                  for src, o in zip(SOURCES, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)             # atomic: a concurrent build is harmless
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            digest.update(src.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libcrfr_torch_kernels_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            _compile_and_link(so)
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.crfr_error_string(err).decode()}")

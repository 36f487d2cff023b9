"""Build and load the port's CUDA kernels.

The sources under ``crfr_torch/ops/csrc/`` have a plain C interface. At
first use they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library under ``build/crfr_torch_kernels/`` of the checkout, named by a
hash of the sources and flags, and loaded with ``ctypes``. This keeps
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
SOURCES = (_CSRC / "fused_preprocess.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "crfr_torch_kernels"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

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
    lib.crfr_resample_normalize.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i, p]
    lib.crfr_resample_normalize.restype = i
    lib.crfr_resample_max_hw.argtypes = []
    lib.crfr_resample_max_hw.restype = i
    lib.crfr_error_string.argtypes = [i]
    lib.crfr_error_string.restype = ctypes.c_char_p
    return lib


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
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}): "
                                   f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
            os.replace(tmp, so)         # atomic: a concurrent build is harmless
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.crfr_error_string(err).decode()}")

"""Build and load the port's CUDA kernels (`ccdm_tpu_torch/csrc/*.cu`).

All kernel sources compile with `nvcc` into one shared library with a plain
C interface, `libccdm_kernels.so`, which is loaded with `ctypes`. In a source
checkout it goes to `build/ccdm_tpu_torch/` at the repository root (git
ignores `build/`); an installed copy of the package builds into `build/`
beside its own `csrc/`, as `ccdm_tpu/native` does. The build runs on first
use and again whenever a source in `csrc/` is newer than the library.
Nothing here runs at import time; this module is only reached from a
wrapper that was handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = (_PACKAGE.parent / "build" / "ccdm_tpu_torch"
             if (_PACKAGE.parent / "pyproject.toml").is_file() else _PACKAGE / "build")
LIB_PATH = BUILD_DIR / "libccdm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points (see the .cu files) -> argtypes. Every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    # x, y, gamma, beta, partial, dtype, batch, channels, hw, groups, splits, eps, silu, stream
    "ccdm_group_norm": [_P, _P, _P, _P, _P, _I, _LL, _LL, _LL, _I, _I, _F, _I, _P],
    # q, k, v, out, dtype, bh, t, dh, q_sbh, q_sd, k_sbh, k_sd, v_sbh, v_sd, scale, stream
    "ccdm_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I,
                             _LL, _LL, _LL, _LL, _LL, _LL, _F, _P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    cu, cuh = _sources()
    return any(p.stat().st_mtime > built for p in cu + cuh)


def build(force: bool = False) -> float:
    """Compile `csrc/*.cu` into `LIB_PATH` if stale (or `force`); returns the
    seconds spent compiling (0.0 when the library was current)."""
    if not force and not _stale():
        return 0.0
    cu, _ = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *map(str, cu)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - start


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ccdm_error_string.argtypes = [ctypes.c_int]
            lib.ccdm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero `cudaError_t`."""
    if status != 0:
        text = library().ccdm_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {text}")

"""Build and load the port's CUDA kernels (`ccdm_tpu_torch/csrc/*.cu`).

Each kernel source compiles in its own `nvcc` process, all at once, and the
objects link into one shared library with a plain C interface,
`libccdm_kernels.so`, which is loaded with `ctypes`. In a source
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
              "-Xcompiler", "-fPIC"]
# ptxas's registers, shared memory and spills per kernel, from the last build
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points (see the .cu files) -> argtypes. Every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    # x, y, gamma, beta, add, partial, dtype, batch, channels, hw, groups, path, vec,
    # param, chunk, eps, silu, stream
    "ccdm_group_norm": [_P, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL, _I, _I, _I,
                        _I, _LL, _F, _I, _P],
    # x, y, gamma, beta, add, partial, dtype, batch, channels, hw, groups, path, vec,
    # tile, cluster, splits, chunk, apply, eps, silu, stream
    "ccdm_group_norm_nhwc": [_P, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL, _I, _I, _I,
                             _I, _I, _I, _I, _I, _F, _I, _P],
    # x, dy, gamma, beta, add, dx, dadd, scratch, counter, dgamma, dbeta, dtype, batch,
    # channels, hw, groups, path, vec, param, chunk, eps, silu, stream
    "ccdm_group_norm_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL,
                                 _LL, _I, _I, _I, _I, _LL, _F, _I, _P],
    # q, k, v, out, dtype, path, bh, t, dh, q_sbh, q_sd, k_sbh, k_sd, v_sbh, v_sd,
    # scale, stream
    "ccdm_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _LL, _LL, _LL, _LL, _LL, _LL, _F, _P],
    # q, k, out, bh, t, dh, q_sbh, q_sd, k_sbh, k_sd, stream
    "ccdm_attention_logits": [_P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _LL, _P],
    # x, w_q, s_w, bias, s_x, out, acc32, dtype, batch, cin, h, w, cout, kernel, stride,
    # padding, cin_pad, path, p0, p1, p2, p3, p4, stream
    "ccdm_quant_conv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _P],
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


def _run(procs) -> str:
    """Wait for every (command, Popen); raise on the first failure."""
    logs = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        logs.append(out)
    return "".join(logs)


def build(force: bool = False) -> float:
    """Compile `csrc/*.cu` into `LIB_PATH` if stale (or `force`): one nvcc per
    source, all started together, then one link. Returns the seconds spent
    (0.0 when the library was current)."""
    global build_log
    if not force and not _stale():
        return 0.0
    cu, _ = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    # objects and the library go to private names first, then the library is
    # renamed: concurrent builders never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        compiles = []
        for src, obj in zip(cu, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
            compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
        log = _run(compiles)
        lib = Path(tmp) / LIB_PATH.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))])
        os.replace(lib, LIB_PATH)
    build_log = log
    return time.perf_counter() - start


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed: the first call's
    build and load are the span `setup.kernels` (`utils/trace.py`)."""
    global _lib
    with _lock:
        if _lib is None:
            # imported at the first load, not with this module: importing the
            # served loader (utils/serving.py) loads torch and the kernels' modules
            from ccdm_tpu_torch.utils import trace

            with trace.span("setup.kernels"):
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


def host_library(source: Path, lib_path: Path) -> ctypes.CDLL:
    """A C++ helper for the host (`csrc/*.cpp`, a plain C interface), built
    with the host's C++ compiler into `lib_path` if missing or older than
    its source, and loaded. The library is renamed into place, so processes
    that build it at once never load a half-written one. The caller holds a
    lock around the call and declares the functions' types."""
    if not lib_path.exists() or lib_path.stat().st_mtime < source.stat().st_mtime:
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"no C++ compiler (c++ or g++) on PATH: {source} cannot be built")
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
            out = Path(tmp) / lib_path.name
            proc = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(out), str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed to build {source} ({proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(out, lib_path)
    return ctypes.CDLL(str(lib_path))


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero `cudaError_t`."""
    if status != 0:
        text = library().ccdm_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {text}")

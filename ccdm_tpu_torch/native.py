"""Confusion counts on the host through a small C++ library (the port of
`ccdm_tpu/native`).

`csrc/confusion_matrix.cpp` is built with the host's C++ compiler at first
use into the git-ignored `build/` beside the CUDA kernels' library
(`ops/_build.host_library`), and bound here with ctypes. Unlike the JAX
package's binding, a failed build or load raises: nothing falls back to
NumPy. `add_to_confusion_matrix_numpy` and
`pairwise_intersection_union_numpy` are the same counts in NumPy, the tests'
reference.

Every array is checked here before its pointer reaches the library: dtype,
shape, contiguity and the range of the ids, so no count lands outside its
matrix.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from ccdm_tpu_torch.ops._build import BUILD_DIR, CSRC, host_library

_SOURCE = CSRC / "confusion_matrix.cpp"
LIB_PATH = BUILD_DIR / "libccdm_native.so"

_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = host_library(_SOURCE, LIB_PATH)
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.add_to_confusion_matrix.argtypes = [p, p, i64, i64, p]
            lib.add_to_confusion_matrix_i32.argtypes = [p, p, i64, i64, p]
            lib.pairwise_intersection_union.argtypes = [p, p, i64, i64, i64, i64, p, p]
            for fn in (lib.add_to_confusion_matrix, lib.add_to_confusion_matrix_i32,
                       lib.pairwise_intersection_union):
                fn.restype = None
            _lib = lib
        return _lib


def _check_ids(name: str, a: np.ndarray, n_ids: int) -> None:
    if a.size and (int(a.min()) < 0 or int(a.max()) >= n_ids):
        raise ValueError(f"{name} holds ids in [{int(a.min())}, {int(a.max())}], outside "
                         f"[0, {n_ids})")


def _maps(gt, pred, n_ids: int) -> Tuple[np.ndarray, np.ndarray]:
    gt, pred = np.asarray(gt), np.asarray(pred)
    if gt.shape != pred.shape:
        raise ValueError(f"gt {gt.shape} and pred {pred.shape} differ in shape")
    if gt.dtype != pred.dtype or gt.dtype not in (np.uint8, np.int32):
        raise TypeError(f"gt and pred must both be uint8 or both int32, got {gt.dtype} and "
                        f"{pred.dtype}")
    for name, a in (("gt", gt), ("pred", pred)):
        if gt.dtype != np.uint8 or n_ids < 256:
            _check_ids(name, a, n_ids)
    return np.ascontiguousarray(gt).reshape(-1), np.ascontiguousarray(pred).reshape(-1)


def _matrix(cm: Optional[np.ndarray], n_ids: int) -> np.ndarray:
    if cm is None:
        return np.zeros((n_ids, n_ids), dtype=np.int64)
    if cm.shape != (n_ids, n_ids) or cm.dtype != np.int64 or not cm.flags.c_contiguous \
            or not cm.flags.writeable:
        raise ValueError(f"cm must be a writable C-contiguous int64 [{n_ids}, {n_ids}] array, "
                         f"got {cm.dtype} {cm.shape}")
    return cm


def add_to_confusion_matrix(gt: np.ndarray, pred: np.ndarray, n_ids: int,
                            cm: Optional[np.ndarray] = None) -> np.ndarray:
    """Add the `[gt, pred]` counts of two class maps of one shape (both
    uint8 or both int32, ids in `[0, n_ids)`) into the `[n_ids, n_ids]`
    int64 matrix `cm` (a new one when None) and return it."""
    gt, pred = _maps(gt, pred, n_ids)
    cm = _matrix(cm, n_ids)
    fn = (_library().add_to_confusion_matrix if gt.dtype == np.uint8
          else _library().add_to_confusion_matrix_i32)
    fn(gt.ctypes.data, pred.ctypes.data, gt.size, n_ids, cm.ctypes.data)
    return cm


def add_to_confusion_matrix_numpy(gt: np.ndarray, pred: np.ndarray, n_ids: int,
                                  cm: Optional[np.ndarray] = None) -> np.ndarray:
    """`add_to_confusion_matrix` by `np.bincount` (the tests' reference)."""
    gt, pred = _maps(gt, pred, n_ids)
    cm = _matrix(cm, n_ids)
    codes = gt.astype(np.int64) * n_ids + pred.astype(np.int64)
    cm += np.bincount(codes, minlength=n_ids * n_ids).reshape(n_ids, n_ids)
    return cm


def _pairs(x, y, n_classes: int):
    x, y = np.asarray(x), np.asarray(y)
    if x.dtype != np.uint8 or y.dtype != np.uint8 or x.ndim != 2 or y.ndim != 2 \
            or x.shape[1] != y.shape[1]:
        raise ValueError(f"x and y must be uint8 [S, P] maps with one P, got {x.dtype} "
                         f"{x.shape} and {y.dtype} {y.shape}")
    if not 0 < n_classes <= 256:
        raise ValueError(f"n_classes {n_classes} outside [1, 256]")
    _check_ids("x", x, n_classes)
    _check_ids("y", y, n_classes)
    return np.ascontiguousarray(x), np.ascontiguousarray(y)


def pairwise_intersection_union(x: np.ndarray, y: np.ndarray,
                                n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per pair of uint8 class maps `x` `[Sx, P]` and `y` `[Sy, P]`, per
    class, the pixels both give it (intersection) and the pixels either
    gives it (union): two int64 `[Sx, Sy, n_classes]` arrays."""
    x, y = _pairs(x, y, n_classes)
    (sx, p), sy = x.shape, y.shape[0]
    inter = np.zeros((sx, sy, n_classes), dtype=np.int64)
    union = np.zeros((sx, sy, n_classes), dtype=np.int64)
    _library().pairwise_intersection_union(x.ctypes.data, y.ctypes.data, sx, sy, p, n_classes,
                                           inter.ctypes.data, union.ctypes.data)
    return inter, union


def pairwise_intersection_union_numpy(x: np.ndarray, y: np.ndarray,
                                      n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """`pairwise_intersection_union` by one-hot broadcasts (the tests'
    reference)."""
    x, y = _pairs(x, y, n_classes)
    xb = np.eye(n_classes, dtype=bool)[x]  # [Sx,P,C]
    yb = np.eye(n_classes, dtype=bool)[y]
    inter = (xb[:, None] & yb[None]).sum(2).astype(np.int64)
    union = (xb[:, None] | yb[None]).sum(2).astype(np.int64)
    return inter, union

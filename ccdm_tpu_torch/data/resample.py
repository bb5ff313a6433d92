"""PIL's `Image.resize` in NumPy, bit for bit (the card's machine has no
PIL, and the model sees these pixels).

- `resize_bilinear_uint8`: `BILINEAR` on "L" and "RGB" images. PIL's
  separable resampler (`libImaging/Resample.c`): per output pixel a
  triangle filter widened by the scale factor when downsampling, its taps
  normalised to sum 1 in double precision, then converted to 22-bit fixed
  point (`PRECISION_BITS = 32 - 8 - 2`, rounded half away from zero);
  integer sums start at half an output step, shift right by 22 and clip to
  [0, 255]. The horizontal pass runs first, its result rounded to uint8,
  then the vertical pass.
- `resize_lanczos_uint8`: `LANCZOS` on "L" and "RGB" images, the same
  passes with PIL's Lanczos filter (a sinc windowed by a sinc 3 times as
  wide, support 3, widened by the scale when downsampling), whose negative
  taps round away from zero in fixed point and whose sums clip at 0 and
  255.
- `resize_bilinear_float`: `BILINEAR` on float32 "F" planes: the same taps
  in double, summed tap by tap in double, each pass rounded to float32.
- `resize_nearest`: `NEAREST` (`libImaging/Geometry.c`, the scaling affine
  transform): source index `int(x0 + (x + 0.5) * scale)`, with the source
  position advanced by repeated addition of `scale` in double as PIL does.

A pass whose size does not change is skipped, as PIL skips it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _sinc(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(x == 0.0, 1.0, np.sin(x * math.pi) / (x * math.pi))


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


# PIL's filters: (support, filter)
_FILTERS = {"bilinear": (1.0, _bilinear), "lanczos": (3.0, _lanczos)}


def _taps(in_size: int, out_size: int, kind: str = "bilinear"):
    """PIL's `precompute_coeffs` for the filter `kind` over the box
    `[0, in_size)`: `(first source index [out], weights [out, ksize])`,
    weights past each output's tap count are 0."""
    base_support, fn = _FILTERS[kind]
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    arg = ((x[None, :] + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5) * (
        1.0 / filterscale)
    w = np.where(x[None, :] < xmax[:, None], fn(arg), 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):  # PIL sums the taps in order
        total += w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    return xmin, w


def _indices(xmin: np.ndarray, ksize: int, in_size: int) -> np.ndarray:
    return np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)


def _pass_uint8(img: np.ndarray, out_size: int, axis: int, kind: str = "bilinear") -> np.ndarray:
    in_size = img.shape[axis]
    xmin, w = _taps(in_size, out_size, kind)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << PRECISION_BITS))).astype(np.int32)
    idx = _indices(xmin, w.shape[1], in_size)
    src = np.moveaxis(img, axis, 0).astype(np.int32)  # [in, other, (channels)]
    # int32 as in PIL: 255 x 2^22 per unit of weight (at most ~1.3 units of
    # |weight| for Lanczos) stays below 2^31
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), dtype=np.int32)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for k in range(w.shape[1]):
        acc += src[idx[:, k]] * fixed[:, k].reshape(shape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _pass_float(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmin, w = _taps(in_size, out_size)
    idx = _indices(xmin, w.shape[1], in_size)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    acc = np.zeros((out_size,) + src.shape[1:], dtype=np.float64)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for k in range(w.shape[1]):
        acc += src[idx[:, k]] * w[:, k].reshape(shape)
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def _resize_uint8(img: np.ndarray, size: Tuple[int, int], kind: str, name: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"{name} takes uint8 [H,W] or [H,W,3], got {img.dtype} {img.shape}")
    th, tw = int(size[0]), int(size[1])
    if tw != img.shape[1]:
        img = _pass_uint8(img, tw, 1, kind)
    if th != img.shape[0]:
        img = _pass_uint8(img, th, 0, kind)
    return np.ascontiguousarray(img)


def resize_bilinear_uint8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL `BILINEAR` of a uint8 `[H,W]` ("L") or `[H,W,3]` ("RGB") image
    to `size = (height, width)`."""
    return _resize_uint8(img, size, "bilinear", "resize_bilinear_uint8")


def resize_lanczos_uint8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL `LANCZOS` of a uint8 `[H,W]` ("L") or `[H,W,3]` ("RGB") image to
    `size = (height, width)`."""
    return _resize_uint8(img, size, "lanczos", "resize_lanczos_uint8")


def resize_bilinear_float(plane: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL `BILINEAR` of a float32 `[H,W]` ("F") plane to `size = (height,
    width)`."""
    plane = np.asarray(plane, dtype=np.float32)
    if plane.ndim != 2:
        raise ValueError(f"resize_bilinear_float takes one [H,W] plane, got {plane.shape}")
    th, tw = int(size[0]), int(size[1])
    if tw != plane.shape[1]:
        plane = _pass_float(plane, tw, axis=1)
    if th != plane.shape[0]:
        plane = _pass_float(plane, th, axis=0)
    return np.ascontiguousarray(plane)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    scale = float(np.float32(in_size)) / out_size
    pos = np.empty(out_size, dtype=np.float64)
    pos[0] = scale * 0.5
    pos[1:] = scale
    pos = np.cumsum(pos)  # sequential additions, as PIL's loop
    return np.where(pos < 0.0, -1, np.trunc(pos)).astype(np.int64)


def resize_nearest(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL `NEAREST` of an `[H,W]` (or `[H,W,C]`) array to `size = (height,
    width)`."""
    arr = np.asarray(arr)
    th, tw = int(size[0]), int(size[1])
    rows = _nearest_index(arr.shape[0], th)
    cols = _nearest_index(arr.shape[1], tw)
    if rows.min() < 0 or cols.min() < 0 or rows.max() >= arr.shape[0] or \
            cols.max() >= arr.shape[1]:
        raise ValueError("nearest source index out of range")
    return np.ascontiguousarray(arr[rows][:, cols])

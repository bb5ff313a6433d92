"""PNG reading and writing without PIL (the card's machine has none).

Non-interlaced PNG with zlib, the formats the port's data and dumps use:

- gray 8 and 16 bit, RGB 8, RGBA 8 and palette 8 on read, with all five
  row filters; `read_png(path, mode="RGB")` converts as PIL's
  `.convert("RGB")` does (gray replicated, alpha dropped, the palette
  looked up);
- gray 8 and 16 bit, RGB 8, RGBA 8 and palette 8 on write, every row
  unfiltered (filter type 0).

Anything else (interlacing, 1-4 bit depths, 16-bit colour, gray+alpha)
raises. Rows are unfiltered by a small C++ helper (`csrc/png_unfilter.cpp`)
built with the host's C++ compiler at first use into the git-ignored
`build/` beside the CUDA kernels' library: the Sub, Average and Paeth
filters are serial along a row, and a 1024x2048 RGB image would take
seconds in a Python loop. `unfilter_numpy` is the same algorithm in NumPy,
for the tests.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from ccdm_tpu_torch.ops._build import BUILD_DIR, CSRC, host_library

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SOURCE = CSRC / "png_unfilter.cpp"
LIB_PATH = BUILD_DIR / "libccdm_png.so"
# colour type -> channels; bit depths read
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_DEPTHS = {0: (8, 16), 2: (8,), 3: (8,), 6: (8,)}

_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    """The unfilter helper, compiled first if missing or older than its
    source (`ops/_build.host_library`)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = host_library(_SOURCE, LIB_PATH)
            lib.ccdm_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_longlong, ctypes.c_longlong,
                                              ctypes.c_int]
            lib.ccdm_png_unfilter.restype = ctypes.c_longlong
            _lib = lib
        return _lib


def unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """`raw`, `height` rows of a filter byte and `rowbytes` bytes, ->
    `[height, rowbytes]` uint8, through the C++ helper."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size != height * (rowbytes + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not {height} rows of "
                         f"1 + {rowbytes}")
    out = np.empty((height, rowbytes), dtype=np.uint8)
    bad = _library().ccdm_png_unfilter(raw.ctypes.data, out.ctypes.data, height,
                                       rowbytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {raw[(bad - 1) * (rowbytes + 1)]}")
    return out


def unfilter_numpy(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """`unfilter` in NumPy, a row at a time (Sub by a running sum, Up by one
    add, Average and Paeth a pixel at a time): the tests' reference."""
    rows = np.asarray(raw, dtype=np.uint8).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), dtype=np.uint8)
    zero = np.zeros(rowbytes, dtype=np.uint8)
    for r in range(height):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        up = out[r - 1] if r else zero
        if kind == 0:
            out[r] = line
        elif kind == 1:
            out[r] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[r] = line + up
        elif kind in (3, 4):
            cur = out[r].astype(np.int32)
            above = up.astype(np.int32)
            for i in range(0, rowbytes, bpp):
                a = cur[i - bpp:i] if i else np.zeros(bpp, np.int32)
                b = above[i:i + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = above[i - bpp:i] if i else np.zeros(bpp, np.int32)
                    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[i:i + bpp] = (line[i:i + bpp].astype(np.int32) + pred) & 0xFF
            out[r] = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG row {r} has filter type {kind}")
    return out


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def read_png(path, mode: Optional[str] = None) -> np.ndarray:
    """The pixels of a PNG file: gray `[H,W]` uint8 or uint16, RGB
    `[H,W,3]`, RGBA `[H,W,4]`, palette `[H,W]` uint8 indices (as
    `np.asarray(PIL.Image.open(path))` gives them), or with `mode="RGB"`
    `[H,W,3]` uint8 as `.convert("RGB")` gives them."""
    if mode not in (None, "RGB"):
        raise ValueError(f"mode must be None or 'RGB', got {mode!r}")
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise ValueError(f"{path}: PNG colour type {color} at {depth} bits is not supported")
    if compression or filtering or interlace:
        raise ValueError(f"{path}: interlaced or non-standard PNG is not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    rowbytes = width * bpp
    rows = unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8),
                    height, rowbytes, bpp)
    if depth == 16:
        pixels = rows.view(">u2").astype(np.uint16).reshape(height, width)
    else:
        pixels = rows.reshape(height, width, channels)
        if channels == 1:
            pixels = pixels[..., 0]
    if mode != "RGB":
        return pixels
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        table = np.zeros((256, 3), dtype=np.uint8)
        table[:len(palette)] = palette
        return table[pixels]
    if depth == 16:
        raise ValueError(f"{path}: 16-bit gray has no RGB conversion here")
    if channels == 1:
        return np.repeat(pixels[..., None], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def write_png(path, pixels: np.ndarray, palette: Optional[np.ndarray] = None,
              level: int = 6) -> str:
    """Write gray `[H,W]` uint8 or uint16, RGB `[H,W,3]` or RGBA `[H,W,4]`
    uint8, or palette indices `[H,W]` uint8 with `palette` `[N,3]` uint8
    (N <= 256), every row unfiltered, zlib at `level`."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2 and pixels.dtype == np.uint16 and palette is None:
        color, depth, rows = 0, 16, pixels.astype(">u2").view(np.uint8)
    elif pixels.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8 (or 2-D uint16), got {pixels.dtype}")
    elif pixels.ndim == 2:
        color, depth, rows = (0 if palette is None else 3), 8, pixels
    elif pixels.ndim == 3 and pixels.shape[-1] in (3, 4) and palette is None:
        color, depth = (2 if pixels.shape[-1] == 3 else 6), 8
        rows = pixels.reshape(pixels.shape[0], -1)
    else:
        raise ValueError(f"no PNG layout for pixels of shape {pixels.shape}")
    height, width = pixels.shape[:2]
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows.reshape(height, -1)], axis=1)
    out = [_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color,
                                                   0, 0, 0))]
    if palette is not None:
        palette = np.asarray(palette, dtype=np.uint8).reshape(-1, 3)
        if not 0 < len(palette) <= 256:
            raise ValueError(f"a PNG palette holds 1-256 entries, got {len(palette)}")
        out.append(_chunk(b"PLTE", palette.tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)), _chunk(b"IEND", b"")]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return str(path)

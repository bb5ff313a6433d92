"""The port's PNG codec (`ccdm_tpu_torch/utils/png.py`) against PIL: files
PIL writes (its adaptive filters, 16-bit big-endian gray, palettes), files
that use each of the five row filters, what the port writes read back by
PIL, and the C++ unfilter helper against its NumPy reference."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ccdm_tpu_torch.utils import png

RNG = np.random.default_rng(0)


def _smooth(h, w, channels):
    """Gradients with noise: PIL's adaptive filter picks every type on it."""
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(xx * (c + 1) + yy * (3 - c) + RNG.integers(0, 4, (h, w))) % 256
              for c in range(channels)]
    return np.stack(planes, -1).astype(np.uint8)


CASES = {
    "gray8": lambda: _smooth(37, 53, 1)[..., 0],
    "gray16": lambda: (_smooth(37, 53, 1)[..., 0].astype(np.uint16) * 257
                       + RNG.integers(0, 200, (37, 53))).astype(np.uint16),
    "rgb": lambda: _smooth(37, 53, 3),
    "rgba": lambda: _smooth(37, 53, 4),
    "noise_rgb": lambda: RNG.integers(0, 256, (40, 64, 3)).astype(np.uint8),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_reads_what_pil_writes_and_pil_reads_ours(tmp_path, kind):
    arr = CASES[kind]()
    path = tmp_path / "pil.png"
    Image.fromarray(arr).save(path)
    ref = np.asarray(Image.open(path))
    ours = png.read_png(path)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    if kind != "gray16":
        np.testing.assert_array_equal(png.read_png(path, mode="RGB"),
                                      np.asarray(Image.open(path).convert("RGB")))
    written = png.write_png(tmp_path / "ours.png", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(written)), arr)
    np.testing.assert_array_equal(png.read_png(written), arr)


def test_palette_both_ways(tmp_path):
    pal_img = Image.fromarray(_smooth(30, 41, 3)).convert("P", palette=Image.ADAPTIVE, colors=37)
    pal_img.save(tmp_path / "pil.png")
    np.testing.assert_array_equal(png.read_png(tmp_path / "pil.png"),
                                  np.asarray(Image.open(tmp_path / "pil.png")))
    np.testing.assert_array_equal(png.read_png(tmp_path / "pil.png", mode="RGB"),
                                  np.asarray(Image.open(tmp_path / "pil.png").convert("RGB")))
    idx = RNG.integers(0, 5, (9, 11)).astype(np.uint8)
    palette = RNG.integers(0, 256, (5, 3)).astype(np.uint8)
    png.write_png(tmp_path / "ours.png", idx, palette=palette)
    back = Image.open(tmp_path / "ours.png")
    assert back.mode == "P"
    np.testing.assert_array_equal(np.asarray(back), idx)
    np.testing.assert_array_equal(np.asarray(back.convert("RGB")), palette[idx])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_bytes(w, h, color, raw, interlace=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, color, 0, 0, interlace))
        + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def _encode_every_filter(arr, bpp):
    """A PNG body whose row r uses filter type r % 5 (what other writers
    than PIL may emit), and the raw filtered rows."""
    rows = arr.reshape(arr.shape[0], -1).astype(np.int32)
    out = []
    for r, line in enumerate(rows):
        up = rows[r - 1] if r else np.zeros_like(line)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        kind = r % 5
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][kind]
        out.append(np.concatenate([[kind], (line - pred) & 0xFF]).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_every_row_filter(tmp_path, channels):
    arr = _smooth(23, 19, channels)
    raw = _encode_every_filter(arr, channels)
    h, w = arr.shape[:2]
    ours = png.unfilter(raw, h, w * channels, channels)
    np.testing.assert_array_equal(ours, arr.reshape(h, -1))
    np.testing.assert_array_equal(png.unfilter_numpy(raw, h, w * channels, channels), ours)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_bytes(w, h, {1: 0, 3: 2, 4: 6}[channels], raw))
    np.testing.assert_array_equal(png.read_png(path), np.asarray(Image.open(path)))


def test_native_and_numpy_unfilter_agree_on_pil_files(tmp_path):
    """PIL's own filter choices on a photo-like RGB image, through both."""
    arr = _smooth(64, 96, 3)
    Image.fromarray(arr).save(tmp_path / "a.png")
    data = (tmp_path / "a.png").read_bytes()
    idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    assert len(set(raw.reshape(64, -1)[:, 0].tolist())) > 1  # PIL mixed its filters
    np.testing.assert_array_equal(png.unfilter(raw, 64, 288, 3),
                                  png.unfilter_numpy(raw, 64, 288, 3))


def test_refuses_what_it_does_not_read(tmp_path):
    Image.fromarray(np.zeros((4, 4), bool)).save(tmp_path / "bits.png")  # 1-bit
    with pytest.raises(ValueError, match="colour type"):
        png.read_png(tmp_path / "bits.png")
    (tmp_path / "inter.png").write_bytes(_png_bytes(4, 4, 0, np.zeros((4, 5), np.uint8), 1))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(tmp_path / "inter.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(tmp_path / "x.png")
    good = tmp_path / "good.png"
    png.write_png(good, np.zeros((3, 3), np.uint8))
    data = bytearray(good.read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT body
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(tmp_path / "bad.png")
    with pytest.raises(ValueError):
        png.write_png(tmp_path / "f.png", np.zeros((3, 3), np.float32))

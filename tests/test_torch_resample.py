"""`ccdm_tpu_torch/data/resample.py` against Pillow's `Image.resize`: BILINEAR
uint8 ("L" and "RGB") bit for bit, BILINEAR "F" planes within 1e-6, NEAREST
bit for bit, at the Cityscapes factor (1024x2048 -> 256x512), at odd
factors, upsampling and one-axis resizes."""

import numpy as np
import pytest
from PIL import Image

from ccdm_tpu_torch.data.resample import (
    resize_bilinear_float,
    resize_bilinear_uint8,
    resize_nearest,
)

SIZES = [
    ((1024, 2048), (256, 512)),   # the Cityscapes input
    ((37, 53), (11, 29)),         # odd factors
    ((181, 181), (128, 97)),
    ((20, 30), (47, 61)),         # upsampling
    ((100, 7), (33, 7)),          # one axis only
    ((5, 9), (5, 4)),
]


@pytest.mark.parametrize("src,dst", SIZES)
def test_matches_pil(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    th, tw = dst
    for shape in (src, (*src, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((tw, th), Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_uint8(img, dst), ref)
    plane = (rng.standard_normal(src) * 3).astype(np.float32)
    ref = np.asarray(Image.fromarray(plane, mode="F").resize((tw, th), Image.BILINEAR))
    np.testing.assert_allclose(resize_bilinear_float(plane, dst), ref, rtol=0, atol=1e-6)
    labels = rng.integers(0, 34, src).astype(np.uint8)
    ref = np.asarray(Image.fromarray(labels).resize((tw, th), Image.NEAREST))
    np.testing.assert_array_equal(resize_nearest(labels, dst), ref)


def test_rejects_other_layouts():
    with pytest.raises(ValueError):
        resize_bilinear_uint8(np.zeros((4, 4, 4), np.uint8), (2, 2))  # RGBA: premultiplied in PIL
    with pytest.raises(ValueError):
        resize_bilinear_uint8(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        resize_bilinear_float(np.zeros((4, 4, 2), np.float32), (2, 2))

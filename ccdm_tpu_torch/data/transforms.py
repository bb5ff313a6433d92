"""Host-side augmentation pipeline, explicitly seeded (a copy of
`ccdm_tpu/data/transforms.py` with PIL's resampling replaced by
`data/resample.py`, which gives the same pixels).

Re-expresses the reference's named-transform factory
(`datasets/pipelines/transforms.py:339-421`) without torch/torchvision. Every
transform is a function `(img, lbl, rng, metadata) -> (img, lbl, metadata)`
over `img` HWC float32/uint8 arrays and `lbl` HW integer arrays, driven by an
explicit `np.random.Generator` (replaces global `random`/`np.random` state so
data order is reproducible and shardable per process).

Implemented transforms and their reference counterparts:
- flip       -> `FlipNP` (`transforms.py:31-53`), default (p_v, p_h) = (0, .5)
- resize     -> `Resize` (`transforms.py:113-201`): PIL BILINEAR image /
                NEAREST label, optional stride-fit bottom/right padding with
                label pad = ignore class, optional original-label capture
- random_scale -> `RandomScale` (`transforms.py:204-283`)
- random_crop  -> `RandomCropImgLbl` (`transforms.py:56-110`) incl. the
                class-max-ratio constrained retry loop (patience 10)
- pad        -> `Pad` (`transforms.py:286-336`): random-offset pad to target
- colorjitter -> torchvision `ColorJitter(brightness=.5, contrast=.5,
                saturation=.5)` semantics: factors ~ U[max(0,1-v), 1+v],
                applied in random order (`transforms.py:399-404`)
- torchvision_normalise -> ImageNet mean/std normalisation applied after
                scaling to [0,1] (`transforms.py:417-419`)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ccdm_tpu_torch.data.resample import (
    resize_bilinear_float,
    resize_bilinear_uint8,
    resize_nearest,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

Array = np.ndarray
TransformFn = Callable[[Array, Array, np.random.Generator, Optional[dict]],
                       Tuple[Array, Array, Optional[dict]]]


def _ensure_hwc(img: Array) -> Array:
    return img[..., None] if img.ndim == 2 else img


def flip(probability: Tuple[float, float] = (0.0, 0.5)) -> TransformFn:
    p_v, p_h = probability

    def fn(img, lbl, rng, metadata=None):
        if rng.random() < p_v:
            img, lbl = np.flip(img, axis=0), np.flip(lbl, axis=0)
        if rng.random() < p_h:
            img, lbl = np.flip(img, axis=1), np.flip(lbl, axis=1)
        return np.ascontiguousarray(img), np.ascontiguousarray(lbl), metadata

    return fn


def resize(
    target_size: Optional[Sequence[int]] = None,  # (H, W)
    min_side_length: Optional[int] = None,
    fit_stride: Optional[int] = None,
    ignore_class: int = 0,
    img_pad_value: float = 0.0,
    return_original_labels: bool = False,
) -> TransformFn:
    if target_size is None and min_side_length is None:
        raise ValueError("resize needs target_size or min_side_length")

    def fn(img, lbl, rng, metadata=None):
        img = _ensure_hwc(np.asarray(img))
        h, w = img.shape[:2]
        if target_size is not None:
            th, tw = int(target_size[0]), int(target_size[1])
        else:
            scale = min_side_length / min(h, w)
            th, tw = int(round(h * scale)), int(round(w * scale))

        if return_original_labels and metadata is not None:
            metadata["original_labels"] = lbl.astype(np.int32).copy()

        # float images: each channel plane as PIL's 'F' mode resizes it
        if img.dtype != np.uint8:
            planes = [resize_bilinear_float(img[..., c], (th, tw))
                      for c in range(img.shape[-1])]
            new_img = np.stack(planes, axis=-1).astype(np.float32)
        else:
            # uint8: as PIL's "L" (one channel) or "RGB" image
            new_img = resize_bilinear_uint8(img[..., 0] if img.shape[-1] == 1 else img,
                                            (th, tw))
            new_img = _ensure_hwc(new_img)
        # labels: as PIL's "L" image, so ids wrap to uint8 first
        new_lbl = resize_nearest(lbl.astype(np.uint8), (th, tw)).astype(lbl.dtype)

        if fit_stride:
            pad_r = (-th) % fit_stride
            pad_c = (-tw) % fit_stride
            if pad_r or pad_c:
                new_img = np.pad(new_img, ((0, pad_r), (0, pad_c), (0, 0)),
                                 constant_values=img_pad_value)
                new_lbl = np.pad(new_lbl, ((0, pad_r), (0, pad_c)),
                                 constant_values=ignore_class)
        if metadata is not None:
            metadata["resize_hw_in_out"] = ((h, w), new_lbl.shape)
        return new_img, new_lbl, metadata

    return fn


def random_scale(
    scale_range: Tuple[float, float] = (0.5, 2.0),
    aspect_range: Tuple[float, float] = (0.9, 1.1),
    probability: float = 0.5,
    target_size: Optional[Sequence[int]] = None,  # (H, W): pad up to this
    ignore_class: int = 0,
    img_pad_value: float = 0.0,
) -> TransformFn:
    def fn(img, lbl, rng, metadata=None):
        img = _ensure_hwc(np.asarray(img))
        if rng.random() >= probability:
            return img, lbl, metadata
        h, w = img.shape[:2]
        scale = rng.uniform(*scale_range)
        aspect = rng.uniform(*aspect_range)
        sw = np.sqrt(aspect) * scale
        sh = np.sqrt(1.0 / aspect) * scale
        tw, th = int(w * sw), int(h * sh)
        img_r, lbl_r, _ = resize(target_size=(th, tw), ignore_class=ignore_class)(
            img, lbl, rng, None)
        if target_size is not None:
            pad_h = int(target_size[0]) - th
            pad_w = int(target_size[1]) - tw
            if pad_h > 0 or pad_w > 0:
                top = rng.integers(0, pad_h + 1) if pad_h > 0 else 0
                left = rng.integers(0, pad_w + 1) if pad_w > 0 else 0
                img_r = np.pad(img_r, ((top, max(0, pad_h - top)),
                                       (left, max(0, pad_w - left)), (0, 0)),
                               constant_values=img_pad_value)
                lbl_r = np.pad(lbl_r, ((top, max(0, pad_h - top)),
                                       (left, max(0, pad_w - left))),
                               constant_values=ignore_class)
        return img_r, lbl_r, metadata

    return fn


def random_crop(
    shape: Sequence[int],  # (H, W)
    crop_class_max_ratio: Optional[float] = None,
    ignore_class: int = 0,
    patience: int = 10,
) -> TransformFn:
    ch, cw = int(shape[0]), int(shape[1])

    def crop_at(arr, i, j):
        return arr[i:i + ch, j:j + cw]

    def fn(img, lbl, rng, metadata=None):
        img = _ensure_hwc(np.asarray(img))
        h, w = lbl.shape[:2]
        if h < ch or w < cw:
            pad_h, pad_w = max(0, ch - h), max(0, cw - w)
            img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)))
            lbl = np.pad(lbl, ((0, pad_h), (0, pad_w)), constant_values=ignore_class)
            h, w = lbl.shape[:2]

        def draw():
            i = rng.integers(0, h - ch + 1)
            j = rng.integers(0, w - cw + 1)
            return int(i), int(j)

        i, j = draw()
        if crop_class_max_ratio is not None:
            for _ in range(patience):
                lbl_c = crop_at(lbl, i, j)
                classes, cnt = np.unique(lbl_c, return_counts=True)
                cnt = cnt[classes != ignore_class]
                if len(cnt) > 1 and cnt.max() / cnt.sum() < crop_class_max_ratio:
                    break
                i, j = draw()
        if metadata is not None:
            metadata["crop_ij"] = (i, j)
        return crop_at(img, i, j), crop_at(lbl, i, j), metadata

    return fn


def pad(target_size: Sequence[int], ignore_class: int = 0,
        img_pad_value: float = 0.0) -> TransformFn:
    th, tw = int(target_size[0]), int(target_size[1])

    def fn(img, lbl, rng, metadata=None):
        img = _ensure_hwc(np.asarray(img))
        h, w = lbl.shape[:2]
        pad_h, pad_w = th - h, tw - w
        if pad_h > 0 or pad_w > 0:
            top = rng.integers(0, pad_h + 1) if pad_h > 0 else 0
            left = rng.integers(0, pad_w + 1) if pad_w > 0 else 0
            img = np.pad(img, ((top, max(0, pad_h - top)),
                               (left, max(0, pad_w - left)), (0, 0)),
                         constant_values=img_pad_value)
            lbl = np.pad(lbl, ((top, max(0, pad_h - top)),
                               (left, max(0, pad_w - left))),
                         constant_values=ignore_class)
        return img, lbl, metadata

    return fn


def color_jitter(brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5) -> TransformFn:
    """torchvision ColorJitter semantics on uint8/float RGB images."""

    def fn(img, lbl, rng, metadata=None):
        img = _ensure_hwc(np.asarray(img))
        in_dtype = img.dtype  # preserved through the float working copy
        # range keyed on DTYPE, not a data-dependent max(): a nearly-black
        # uint8 frame (max <= 1) is still 0..255-scaled
        scale = 255.0 if np.issubdtype(in_dtype, np.integer) else 1.0
        x = img.astype(np.float32) / scale
        ops = []
        if brightness:
            f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
            ops.append(lambda v, f=f: v * f)
        if contrast:
            f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
            # torchvision: blend with the mean of the grayscale image
            ops.append(lambda v, f=f: f * v + (1 - f) * _gray(v).mean())
        if saturation:
            f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
            ops.append(lambda v, f=f: f * v + (1 - f) * _gray(v)[..., None])
        rng.shuffle(ops)
        for op in ops:
            x = np.clip(op(x), 0.0, 1.0)
        return (x * scale).astype(in_dtype if in_dtype == np.uint8 else np.float32), lbl, metadata

    return fn


def _gray(x: Array) -> Array:
    if x.shape[-1] == 1:
        return x[..., 0]
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD) -> TransformFn:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def fn(img, lbl, rng, metadata=None):
        img = _ensure_hwc(np.asarray(img))
        # integer (0..255) inputs scale to [0,1]; float inputs are assumed
        # already scaled — keyed on dtype (the pipeline preserves it), not a
        # data-dependent max() that misreads nearly-black uint8 frames
        is_int = np.issubdtype(img.dtype, np.integer)
        img = img.astype(np.float32)
        if is_int:
            img = img / 255.0
        c = img.shape[-1]
        img = (img - mean[:c]) / std[:c]
        return img, lbl, metadata

    return fn


def denormalize(mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Inverse of `normalize` for visualisation (parity: `Denormalize`,
    `transforms.py:435-445`). Operates on HWC or BHWC float arrays."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def fn(img: Array) -> Array:
        c = img.shape[-1]
        return img * std[:c] + mean[:c]

    return fn


class TransformPipeline:
    """Ordered composition of TransformFns with an explicit RNG."""

    def __init__(self, fns: List[TransformFn]):
        self.fns = fns

    def __call__(self, img, lbl, rng: np.random.Generator, metadata: Optional[dict] = None):
        for fn in self.fns:
            img, lbl, metadata = fn(img, lbl, rng, metadata)
        return img, lbl, metadata


def build_transforms(names: Sequence[str], settings: Dict, num_classes: int) -> TransformPipeline:
    """Name-keyed factory (parity: `build_transforms`, `transforms.py:339-421`).

    The ignore class is `num_classes - 1` by the reference's convention
    (`transforms.py:23`); normalisation runs last like the torchvision
    Compose ordering upstream.
    """
    settings = settings or {}
    ignore = num_classes - 1
    fns: List[TransformFn] = []
    for name in names or []:
        if name == "flip":
            fns.append(flip())
        elif name in ("resize", "resize_val"):
            fns.append(resize(
                target_size=settings.get("target_size"),
                min_side_length=settings.get("min_side_length"),
                fit_stride=settings.get(
                    "fit_stride_val" if name == "resize_val" else "fit_stride"),
                ignore_class=ignore,
                return_original_labels=settings.get(
                    "return_original_labels", name == "resize_val"),
            ))
        elif name == "random_scale":
            fns.append(random_scale(
                scale_range=tuple(settings["scale_range"]),
                aspect_range=tuple(settings.get("aspect_range", (0.9, 1.1))),
                probability=float(settings.get("p_random_scale", 1.0)),
                target_size=settings.get("crop_shape"),
                ignore_class=ignore,
            ))
        elif name == "RandomCropImgLbl":
            fns.append(random_crop(
                shape=settings["crop_shape"],
                crop_class_max_ratio=settings.get("crop_class_max_ratio"),
                ignore_class=ignore,
            ))
        elif name == "colorjitter":
            fns.append(color_jitter())
        elif name == "torchvision_normalise":
            pass  # appended last, below
        else:
            raise ValueError(f"transform {name!r} not recognized")
    if "torchvision_normalise" in (names or []):
        fns.append(normalize())
    return TransformPipeline(fns)

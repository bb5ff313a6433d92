"""The port's copies of the jax-free data and scoring modules against the
JAX package's originals: every transform, the Cityscapes and LIDC PNG
datasets on the conftest's fake trees, the official scoring of PNG lists
(with and without instanceIds) and the qualitative grids. The port reads
and resamples without PIL; the arrays must still be the same."""

import math

import numpy as np
import pytest
from PIL import Image

import ccdm_tpu.data.cityscapes as jcs
import ccdm_tpu.data.lidc_orig as jlo
import ccdm_tpu.data.transforms as jtr
import ccdm_tpu_torch.data.cityscapes as tcs
import ccdm_tpu_torch.data.lidc_orig as tlo
import ccdm_tpu_torch.data.transforms as ttr


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _run_both(make, img, lbl, seed, metadata=None):
    outs = []
    for mod in (ttr, jtr):
        meta = None if metadata is None else dict(metadata)
        outs.append(make(mod)(img.copy(), lbl.copy(), np.random.default_rng(seed), meta))
    (ti, tl, tm), (ji, jl, jm) = outs
    assert ti.dtype == ji.dtype and tl.dtype == jl.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    if jm is not None:
        _same({k: np.asarray(v) if not isinstance(v, tuple) else str(v) for k, v in tm.items()},
              {k: np.asarray(v) if not isinstance(v, tuple) else str(v) for k, v in jm.items()})


TRANSFORMS = {
    "flip": lambda m: m.flip((0.5, 0.5)),
    "resize_uint8": lambda m: m.resize(target_size=(23, 41), ignore_class=19,
                                       return_original_labels=True),
    "resize_min_side_stride": lambda m: m.resize(min_side_length=29, fit_stride=8,
                                                 ignore_class=19),
    "random_scale": lambda m: m.random_scale((0.5, 1.5), probability=1.0,
                                             target_size=(60, 90), ignore_class=19),
    "random_crop": lambda m: m.random_crop((24, 40), crop_class_max_ratio=0.75,
                                           ignore_class=19),
    "pad": lambda m: m.pad((70, 100), ignore_class=19),
    "color_jitter": lambda m: m.color_jitter(),
    "normalize": lambda m: m.normalize(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_transforms_equal_the_originals(name, dtype):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (48, 80, 3)).astype(np.uint8)
    if dtype == "float32":
        img = img.astype(np.float32) / 255.0
    lbl = rng.integers(0, 20, (48, 80)).astype(np.int64)
    for seed in range(3):
        _run_both(TRANSFORMS[name], img, lbl, seed, metadata={})


def test_build_transforms_and_denormalize_equal_the_originals():
    settings = {"target_size": [32, 64], "crop_shape": [24, 48], "scale_range": [0.7, 1.3],
                "crop_class_max_ratio": 0.9, "fit_stride_val": 16}
    names = ["flip", "random_scale", "RandomCropImgLbl", "colorjitter", "resize_val",
             "torchvision_normalise"]
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (50, 90, 3)).astype(np.uint8)
    lbl = rng.integers(0, 20, (50, 90)).astype(np.int64)
    _run_both(lambda m: m.build_transforms(names, settings, 20), img, lbl, 5, metadata={})
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttr.denormalize()(x), jtr.denormalize()(x))
    with pytest.raises(ValueError, match="not recognized"):
        ttr.build_transforms(["nope"], {}, 20)


@pytest.fixture
def fake_cityscapes(tmp_path, cityscapes_tree_factory, monkeypatch):
    root = cityscapes_tree_factory(tmp_path, splits={"train": 3, "val": 3}, size=(48, 96),
                                   instance_ids=True)
    monkeypatch.setenv("CCDM_CITYSCAPES_PATH", root)
    return root


def test_cityscapes_equals_the_original(fake_cityscapes):
    val_params = {"dataset_pipeline_val": ["resize", "torchvision_normalise"],
                  "dataset_pipeline_val_settings": {"target_size": [24, 48],
                                                    "return_original_labels": True}}
    train_params = {"dataset_pipeline_train": ["flip", "random_scale", "RandomCropImgLbl",
                                               "colorjitter", "torchvision_normalise"],
                    "dataset_pipeline_train_settings": {"scale_range": [0.5, 1.5],
                                                        "crop_shape": [32, 64]}}
    pairs = [
        (tcs.validation_dataset(None, val_params, return_metadata=True),
         jcs.validation_dataset(None, val_params, return_metadata=True)),
        (tcs.validation_dataset(2, val_params), jcs.validation_dataset(2, val_params)),
        (tcs.training_dataset(train_params), jcs.training_dataset(train_params)),
        (tcs.test_dataset(None), jcs.test_dataset(None)),
    ]
    for ours, ref in pairs:
        assert len(ours) == len(ref)
        np.testing.assert_array_equal(ours.indices, ref.indices)
        for i in range(len(ref)):
            _same(ours.get(i, np.random.default_rng(i)), ref.get(i, np.random.default_rng(i)))
    np.testing.assert_array_equal(tcs.get_weights(), jcs.get_weights())
    assert (tcs.get_num_classes(), tcs.get_ignore_class(), tcs.is_multi_annotator()) == (
        jcs.get_num_classes(), jcs.get_ignore_class(), jcs.is_multi_annotator())


def test_lidc_orig_equals_the_original(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for split, n in [("train", 2), ("val", 2), ("test", 3)]:
        for a in ("images", "gt"):
            (tmp_path / f"lidc_crops_{split}" / split / a / "case0").mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (150, 150)).astype(np.uint8)).save(
                tmp_path / f"lidc_crops_{split}" / split / "images" / "case0" / f"s{i}.png")
            for a in range(4):
                mask = (rng.random((150, 150)) > 0.7).astype(np.uint8) * 255
                Image.fromarray(mask).save(
                    tmp_path / f"lidc_crops_{split}" / split / "gt" / "case0" / f"s{i}_l{a}.png")
    monkeypatch.setenv("CCDM_LIDC_ORIG_PATH", str(tmp_path))
    for make, kw in (("training_dataset", {}), ("validation_dataset", {"max_size": 1}),
                     ("test_dataset", {"max_size": None})):
        ours, ref = getattr(tlo, make)(**kw), getattr(jlo, make)(**kw)
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            _same(ours.get(i, np.random.default_rng(i)), ref.get(i, np.random.default_rng(i)))
    with pytest.raises(FileNotFoundError, match="CCDM_LIDC_ORIG_PATH"):
        tlo.training_dataset(base_path=str(tmp_path / "nope"))


def _nan_equal(a, b, path="results"):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _nan_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, float) and math.isnan(b):
        assert isinstance(a, float) and math.isnan(a), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("with_instances", [False, True])
def test_scoring_equals_the_original(tmp_path, with_instances):
    from ccdm_tpu.eval.cs_scoring import score_img_lists as jax_score
    from ccdm_tpu_torch.eval.cs_scoring import score_img_lists

    rng = np.random.default_rng(7)
    ids = [0, 7, 8, 11, 21, 23, 24, 25, 26, 27, 33]
    preds, gts = [], []
    for i in range(3):
        gt = rng.choice(ids, size=(40, 60)).astype(np.uint8)
        pred = np.where(rng.random((40, 60)) < 0.6, gt, rng.choice(ids, size=(40, 60)))
        preds.append(str(tmp_path / f"{i}_pred_labelIds.png"))
        gts.append(str(tmp_path / f"{i}_gtFine_labelIds.png"))
        Image.fromarray(pred.astype(np.uint8)).save(preds[-1])
        Image.fromarray(gt).save(gts[-1])
        if with_instances:
            inst = gt.astype(np.int32)
            for label in (24, 26, 33):
                blob = gt == label
                inst[blob] = label * 1000 + (np.arange(blob.sum()) % 3)  # 3 instances each
            Image.fromarray(inst.astype(np.uint16)).save(
                tmp_path / f"{i}_gtFine_instanceIds.png")
    ours = score_img_lists(preds, gts, export_file=str(tmp_path / "ours.json"))
    ref = jax_score(preds, gts, export_file=str(tmp_path / "ref.json"))
    _nan_equal(ours, ref)
    assert (ours["classInstScores"] is not None) == with_instances
    assert (tmp_path / "ours.json").exists()


def test_qualitative_grid_equals_the_original(tmp_path):
    from ccdm_tpu.utils.visualize import prediction_grid as jax_grid
    from ccdm_tpu_torch.utils.visualize import prediction_grid, save_grid

    rng = np.random.default_rng(1)
    for c in (2, 20):
        images = rng.standard_normal((2, 12, 16, 1 if c == 2 else 3)).astype(np.float32)
        labels = rng.integers(0, c, (2, 12, 16))
        preds = rng.integers(0, c, (2, 3, 12, 16))
        grid = prediction_grid(images, labels, preds, c)
        np.testing.assert_array_equal(grid, jax_grid(images, labels, preds, c))
        path = save_grid(grid, str(tmp_path / "g" / f"grid{c}.png"))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), grid)

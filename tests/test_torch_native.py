"""The port's native confusion counts (`ccdm_tpu_torch/native.py` over
`csrc/confusion_matrix.cpp`) against the JAX package's `ccdm_tpu.native`
and against the NumPy versions kept beside them: uint8 and int32 confusion
matrices, accumulation into a matrix, the pairwise intersection and union
counts, all exact (integers). Then the official scoring, which counts with
the native library, equal to the JAX package's scoring on synthetic PNG
pairs, exact; and the checks that keep a bad id or a failed build from
going unnoticed."""

import math

import numpy as np
import pytest

from ccdm_tpu import native as jax_native
from ccdm_tpu_torch import native


@pytest.mark.parametrize("dtype,n_ids,shape", [(np.uint8, 256, (64, 96)),
                                               (np.uint8, 34, (37, 51)),
                                               (np.int32, 20, (33, 17))])
def test_confusion_matrix_equals_the_jax_package_and_numpy(dtype, n_ids, shape):
    rng = np.random.default_rng(0)
    hi = min(n_ids, 34)
    gt = rng.integers(0, hi, shape).astype(dtype)
    pred = rng.integers(0, hi, shape).astype(dtype)
    cm = native.add_to_confusion_matrix(gt, pred, n_ids)
    assert cm.dtype == np.int64 and cm.shape == (n_ids, n_ids)
    np.testing.assert_array_equal(cm, jax_native.add_to_confusion_matrix(gt, pred, n_ids))
    np.testing.assert_array_equal(cm, native.add_to_confusion_matrix_numpy(gt, pred, n_ids))
    # accumulation into the same matrix, in place
    again = native.add_to_confusion_matrix(gt[::-1], pred, n_ids, cm)
    assert again is cm
    np.testing.assert_array_equal(
        cm, jax_native.add_to_confusion_matrix(gt[::-1], pred, n_ids,
                                               jax_native.add_to_confusion_matrix(gt, pred, n_ids)))


@pytest.mark.parametrize("sx,sy,p,n_classes", [(4, 5, 100, 3), (16, 16, 32 * 32, 2),
                                               (3, 2, 77, 20)])
def test_pairwise_intersection_union_equals_the_jax_package_and_numpy(sx, sy, p, n_classes):
    rng = np.random.default_rng(1)
    x = rng.integers(0, n_classes, (sx, p)).astype(np.uint8)
    y = rng.integers(0, n_classes, (sy, p)).astype(np.uint8)
    inter, union = native.pairwise_intersection_union(x, y, n_classes)
    assert inter.shape == union.shape == (sx, sy, n_classes)
    for ref in (jax_native.pairwise_intersection_union(x, y, n_classes),
                native.pairwise_intersection_union_numpy(x, y, n_classes)):
        np.testing.assert_array_equal(inter, ref[0])
        np.testing.assert_array_equal(union, ref[1])


def test_ids_outside_the_matrix_and_mixed_inputs_are_refused():
    gt = np.zeros((4, 4), np.uint8)
    with pytest.raises(ValueError, match="outside"):
        native.add_to_confusion_matrix(gt, np.full((4, 4), 20, np.uint8), 20)
    with pytest.raises(ValueError, match="outside"):
        native.add_to_confusion_matrix(np.full((4, 4), -1, np.int32), gt.astype(np.int32), 20)
    with pytest.raises(TypeError, match="uint8 or both int32"):
        native.add_to_confusion_matrix(gt, gt.astype(np.int32), 20)
    with pytest.raises(ValueError, match="shape"):
        native.add_to_confusion_matrix(gt, gt[:2], 20)
    with pytest.raises(ValueError, match="int64"):
        native.add_to_confusion_matrix(gt, gt, 20, np.zeros((20, 20), np.int32))
    with pytest.raises(ValueError, match="outside"):
        native.pairwise_intersection_union(gt.reshape(2, 8), gt.reshape(2, 8) + 3, 3)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback to NumPy: a source that does not compile raises."""
    bad = tmp_path / "confusion_matrix.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SOURCE", bad)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libccdm_native.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build"):
        native.add_to_confusion_matrix(np.zeros(4, np.uint8), np.zeros(4, np.uint8), 256)


def _nan_equal(a, b, path="results"):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _nan_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, float) and math.isnan(b):
        assert isinstance(a, float) and math.isnan(a), path
    else:
        assert a == b, (path, a, b)


def test_official_scores_count_natively_and_equal_the_jax_package(tmp_path, monkeypatch):
    from ccdm_tpu.eval.cs_scoring import score_img_lists as jax_score
    from ccdm_tpu_torch.eval import cs_scoring
    from ccdm_tpu_torch.utils.png import write_png

    calls = []
    counted = cs_scoring.add_to_confusion_matrix

    def spy(gt, pred, n_ids, cm):
        calls.append(gt.shape)
        return counted(gt, pred, n_ids, cm)

    monkeypatch.setattr(cs_scoring, "add_to_confusion_matrix", spy)
    rng = np.random.default_rng(3)
    ids = [0, 4, 7, 8, 11, 17, 21, 23, 24, 26, 33]
    preds, gts = [], []
    for i in range(3):
        gt = rng.choice(ids, size=(48, 80)).astype(np.uint8)
        pred = np.where(rng.random(gt.shape) < 0.7, gt, rng.choice(ids, size=gt.shape))
        preds.append(str(tmp_path / f"{i}_pred.png"))
        gts.append(str(tmp_path / f"{i}_gt.png"))
        write_png(preds[-1], pred.astype(np.uint8))
        write_png(gts[-1], gt)
    ours = cs_scoring.score_img_lists(preds, gts)
    _nan_equal(ours, jax_score(preds, gts))
    assert calls == [(48, 80)] * 3

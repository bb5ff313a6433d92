"""Port parity of `eval/metrics.py`: the pairwise distance (NaN -> 1), GED
with both diversities, HM-IoU with the lcm alignment and the confusion
matrix's IoU, mIoU, Dice and accuracy, against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.eval import metrics as jm
from ccdm_tpu_torch.eval import metrics as pm


def _maps(seed, shape, num_classes, empty_class=None):
    rng = np.random.default_rng(seed)
    maps = rng.integers(0, num_classes, shape).astype(np.int32)
    if empty_class is not None:  # a class absent from some maps: IoU NaN -> 1
        maps[0, 0][maps[0, 0] == empty_class] = 0
        maps[0, 1][maps[0, 1] == empty_class] = 0
    return maps


@pytest.mark.parametrize("s,a,c", [(4, 4, 2), (6, 4, 2), (3, 4, 3), (5, 2, 4)])
def test_ged_and_hm_iou_match_jax(s, a, c):
    samples = _maps(s, (2, s, 12, 12), c, empty_class=c - 1)
    refs = _maps(a + 10, (2, a, 12, 12), c, empty_class=1)
    d_ours = pm.pairwise_class_distance(torch.from_numpy(samples), torch.from_numpy(refs), c)
    d_ref = jm.pairwise_class_distance(jnp.asarray(samples), jnp.asarray(refs), c)
    np.testing.assert_allclose(d_ours.numpy(), np.asarray(d_ref), atol=1e-6)
    ours = pm.generalised_energy_distance(torch.from_numpy(samples), torch.from_numpy(refs), c)
    ref = jm.generalised_energy_distance(jnp.asarray(samples), jnp.asarray(refs), c)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, atol=1e-6)
    np.testing.assert_allclose(
        pm.hungarian_matched_iou(torch.from_numpy(samples), torch.from_numpy(refs), c),
        jm.hungarian_matched_iou(jnp.asarray(samples), jnp.asarray(refs), c), atol=1e-6)


def test_identical_sets_score_perfectly():
    maps = torch.from_numpy(_maps(0, (1, 4, 8, 8), 2))
    ged, div_s, div_r = pm.generalised_energy_distance(maps, maps, 2)
    np.testing.assert_allclose(ged, 0.0, atol=1e-7)
    np.testing.assert_allclose(div_s, div_r)
    np.testing.assert_allclose(pm.hungarian_matched_iou(maps, maps, 2), 1.0)


@pytest.mark.parametrize("ignore", [None, 2])
def test_confusion_matrix_matches_jax(ignore):
    ours, ref = pm.ConfusionMatrix(4, ignore), jm.ConfusionMatrix(4, ignore)
    for seed in range(3):
        pred, true = _maps(seed, (2, 9, 7), 4), _maps(seed + 5, (2, 9, 7), 4)
        true[true == 3] = 0 if seed == 0 else 3  # an empty row in one update
        ours.update(torch.from_numpy(pred), torch.from_numpy(true))
        ref.update(pred, true)
    np.testing.assert_array_equal(ours.matrix, ref.matrix)
    for name in ("iou", "dice"):
        np.testing.assert_allclose(getattr(ours, name)(), getattr(ref, name)(), equal_nan=True)
    assert ours.miou() == pytest.approx(ref.miou())
    assert ours.accuracy() == pytest.approx(ref.accuracy())
    ours.update(np.zeros((3, 3), np.int64), np.zeros((3, 3), np.int64))  # numpy input too
    ours.reset()
    assert not ours.matrix.any()

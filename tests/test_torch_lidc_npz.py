"""LIDC v1 without h5py: the port's pickle -> `.npy` directory converter
(`ccdm_tpu_torch/tools/lidc_pickle_to_npz.py`) against the JAX package's
`scripts/lidc_pickle_to_hdf5.py` on a fake pickle of the release's schema
(128x128 crops, 4 masks, series uids), and `data/lidc.py` reading the
directory against the same module and the JAX package's reading the HDF5
file.
Everything is exact: images, labels, split membership, the uids (with
`PYTHONHASHSEED` fixed for both scripts, each in its own process), and
every dataset item under the same seeds."""

import os
import pickle
import subprocess
import sys
import zipfile
from pathlib import Path

import h5py
import numpy as np
import pytest

import ccdm_tpu.data.lidc as jlidc
import ccdm_tpu_torch.data.lidc as tlidc
from ccdm_tpu_torch.tools import lidc_pickle_to_npz

REPO = Path(__file__).resolve().parents[1]
SPLITS = ("train", "val", "test")
KEYS = ("images", "labels", "uids")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A fake release pickle (40 crops of 14 series), converted by both
    scripts with the same hash seed: `(pickle, hdf5, npy directory)` paths."""
    root = tmp_path_factory.mktemp("lidc")
    rng = np.random.default_rng(0)
    data = {}
    for i in range(40):
        data[f"LIDC-{i:04d}_slice{i % 5}"] = {
            "image": rng.random((128, 128)).astype(np.float32),
            "masks": [(rng.random((128, 128)) > 0.85).astype(np.uint8) for _ in range(4)],
            "series_uid": f"1.3.6.1.4.1.14519.5.2.1.6279.{rng.integers(14)}",
        }
    pkl = root / "data_lidc.pickle"
    pkl.write_bytes(pickle.dumps(data))
    env = dict(os.environ, PYTHONHASHSEED="7")
    subprocess.run([sys.executable, str(REPO / "scripts" / "lidc_pickle_to_hdf5.py"), str(pkl),
                    str(root / "data_lidc.hdf5")], check=True, env=env, capture_output=True)
    subprocess.run([sys.executable, "-m", "ccdm_tpu_torch.tools.lidc_pickle_to_npz", str(pkl),
                    str(root / "data_lidc")], check=True, env=env, cwd=REPO,
                   capture_output=True)
    return pkl, root / "data_lidc.hdf5", root / "data_lidc"


def _arrays(directory: Path):
    """`{split/key: array}` of a `.npy` directory."""
    return {f"{p.parent.name}/{p.stem}": np.load(p) for p in directory.glob("*/*.npy")}


def test_the_npz_equals_the_jax_scripts_hdf5(converted):
    pkl, h5, npy = converted
    sizes = []
    ours = _arrays(npy)
    with h5py.File(h5, "r") as ref:
        assert sorted(ours) == sorted(f"{s}/{k}" for s in SPLITS for k in KEYS)
        for split in SPLITS:
            for key in KEYS:
                want = ref[split][key][...]
                got = ours[f"{split}/{key}"]
                assert got.dtype == want.dtype and got.shape == want.shape, (split, key)
                np.testing.assert_array_equal(got, want, err_msg=f"{split}/{key}")
            sizes.append(len(ours[f"{split}/uids"]))
    assert sum(sizes) == 40 and min(sizes) > 0
    # in this process (another hash salt): the same images, labels and splits
    members = lidc_pickle_to_npz.from_pickle(pickle.loads(pkl.read_bytes()), seed=0)
    with h5py.File(h5, "r") as ref:
        for split in SPLITS:
            for key in ("images", "labels"):
                np.testing.assert_array_equal(members[f"{split}/{key}"], ref[split][key][...])


def test_an_hdf5_file_converts_to_the_same_npz(converted, tmp_path):
    _, h5, npy = converted
    assert lidc_pickle_to_npz.main([str(h5), str(tmp_path / "again")]) == 0
    a, b = _arrays(npy), _arrays(tmp_path / "again")
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_without_h5py_the_hdf5_route_says_so_and_exits_1(converted, tmp_path):
    _, h5, _ = converted
    code = ("import sys; sys.modules['h5py'] = None; "
            "from ccdm_tpu_torch.tools.lidc_pickle_to_npz import main; "
            f"sys.exit(main([{str(h5)!r}, {str(tmp_path / 'x')!r}]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True)
    assert proc.returncode == 1 and "h5py cannot be imported" in proc.stderr
    assert not (tmp_path / "x").exists()


def _same_items(a, b, n: int, seeds: bool):
    for i in range(n):
        ra, rb = (np.random.default_rng(i), np.random.default_rng(i)) if seeds else (None, None)
        x, y = a.get(i, ra), b.get(i, rb)
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"item {i} {k}")


@pytest.mark.parametrize("reader", ["port_hdf5", "jax_hdf5"])
def test_npz_items_equal_the_hdf5_items(converted, monkeypatch, reader):
    _, h5, npy = converted
    ref_mod = tlidc if reader == "port_hdf5" else jlidc
    monkeypatch.setenv("CCDM_LIDC_PATH", str(npy))
    train = tlidc.training_dataset()
    assert isinstance(train.images, np.memmap) and isinstance(train.labels, np.memmap)
    ref_train = ref_mod.training_dataset(file_path=str(h5))
    assert len(train) == len(ref_train)
    _same_items(train, ref_train, len(train), seeds=True)
    for make in ("validation_dataset", "test_dataset"):
        for max_size in (None, 2):
            ours = getattr(tlidc, make)(max_size)
            ref = getattr(ref_mod, make)(max_size, file_path=str(h5))
            assert len(ours) == len(ref)
            np.testing.assert_array_equal(ours.indices, ref.indices)
            _same_items(ours, ref, len(ours), seeds=False)
    ours = tlidc.test_dataset(indices=[1, 0])
    _same_items(ours, ref_mod.test_dataset(indices=[1, 0], file_path=str(h5)), 2, seeds=False)


def test_an_unzipped_npz_reads_the_same_and_a_missing_array_is_named(tmp_path):
    """An `.npz` of the schema (`np.savez`), unzipped, is such a directory."""
    rng = np.random.default_rng(2)
    members = {f"{s}/{k}": v for s in SPLITS for k, v in (
        ("images", rng.random((3, 128, 128)) - 0.5),
        ("labels", (rng.random((3, 4, 128, 128)) > 0.9).astype(np.uint8)),
        ("uids", np.arange(3, dtype=np.int64)))}
    np.savez(tmp_path / "c.npz", **members)
    with zipfile.ZipFile(tmp_path / "c.npz") as archive:
        archive.extractall(tmp_path / "c")
    group = tlidc.npy_group(str(tmp_path / "c"), "val")
    assert all(isinstance(group[k], np.memmap) for k in KEYS)
    for key in KEYS:
        np.testing.assert_array_equal(group[key], members[f"val/{key}"])
    (tmp_path / "c" / "test" / "uids.npy").unlink()
    with pytest.raises(KeyError, match="test/uids"):
        tlidc.test_dataset(file_path=str(tmp_path / "c"))

#!/usr/bin/env python3
"""Write LIDC v1 as the `.npy` directory that `data/lidc.py` reads (an
`.npz` of the HDF5 schema, unzipped): the port's counterpart of
`scripts/lidc_pickle_to_hdf5.py`, for a host without h5py.

    python3 -m ccdm_tpu_torch.tools.lidc_pickle_to_npz data_lidc.pickle data_lidc/ [--seed 0]
    python3 -m ccdm_tpu_torch.tools.lidc_pickle_to_npz data_lidc.hdf5 data_lidc/

From the public pickle release (`{key: {"image", "masks" [4,128,128],
"series_uid"}}`), as the JAX script does (parity: `process_data`,
`datasets/lidc.py:35-92`): the unique series uids are split 80/20 into
train+val and test, then 80/20 into train and val (`split_subjects`, the
same seeded permutation); each split's `images` are the float64 crops
shifted by -0.5, its `labels` the uint8 masks `[N,4,128,128]`, its `uids`
`hash(series_uid) % 2**63` as int64 (Python salts its string hash per
process, so these differ from run to run unless `PYTHONHASHSEED` is fixed,
as the JAX script's do; nothing reads them).

From an existing `data_lidc.hdf5` (a file whose name ends in `.hdf5` or
`.h5`), the three groups are copied as they are; that needs h5py, and
without it the tool says so and exits 1.

The output directory holds `{split}/images.npy`, `{split}/labels.npy` and
`{split}/uids.npy` (`np.save`), which `data/lidc.py` memory-maps; point
`$CCDM_LIDC_PATH` at it.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Dict

import numpy as np

SPLITS = ("train", "val", "test")


def split_subjects(uids, seed: int):
    """(train, val, test) sets of series uids: a seeded permutation of the
    unique uids, 20% to test, then 20% of the rest to val (a copy of
    `scripts/lidc_pickle_to_hdf5.py:split_subjects`)."""
    rng = np.random.default_rng(seed)
    unique = np.unique(uids)
    perm = rng.permutation(unique)
    n_test = int(round(0.2 * len(unique)))
    test = set(perm[:n_test])
    rest = perm[n_test:]
    n_val = int(round(0.2 * len(rest)))
    val = set(rest[:n_val])
    train = set(rest[n_val:])
    return train, val, test


def from_pickle(data: dict, seed: int) -> Dict[str, np.ndarray]:
    """The arrays (`{split}/{key}`) of the pickle release's dict."""
    series = [v["series_uid"] for v in data.values()]
    train, val, test = split_subjects(series, seed)
    buckets = {split: ([], [], []) for split in SPLITS}
    for value in data.values():
        sid = value["series_uid"]
        split = "train" if sid in train else ("val" if sid in val else "test")
        imgs, lbls, uids = buckets[split]
        imgs.append(np.asarray(value["image"], dtype=np.float64) - 0.5)
        lbls.append(np.asarray(value["masks"], dtype=np.uint8))
        uids.append(hash(sid) % (2 ** 63))
    members = {}
    for split, (imgs, lbls, uids) in buckets.items():
        members[f"{split}/images"] = np.asarray(imgs)
        members[f"{split}/labels"] = np.asarray(lbls)
        members[f"{split}/uids"] = np.asarray(uids, dtype=np.int64)
    return members


def from_hdf5(path: str) -> Dict[str, np.ndarray]:
    """The arrays (`{split}/{key}`) of an HDF5 file of the same schema."""
    import h5py

    with h5py.File(path, "r") as f:
        return {f"{split}/{key}": np.asarray(f[split][key][...])
                for split in SPLITS for key in ("images", "labels", "uids")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="the pickle release, or a data_lidc.hdf5 (.hdf5 or .h5)")
    ap.add_argument("out_dir", help="the .npy directory to write")
    ap.add_argument("--seed", type=int, default=0, help="the subject split's seed (pickle only)")
    args = ap.parse_args(argv)

    if args.source.endswith((".hdf5", ".h5")):
        try:
            import h5py  # noqa: F401
        except ImportError:
            print(f"lidc_pickle_to_npz: h5py cannot be imported here, so {args.source} cannot "
                  "be read; convert the pickle release instead, or run this where h5py is",
                  file=sys.stderr)
            return 1
        members = from_hdf5(args.source)
    else:
        with open(args.source, "rb") as f:
            members = from_pickle(pickle.load(f), args.seed)
    for split in SPLITS:
        print(f"{split}: {len(members[f'{split}/images'])} slices")
    for name, array in members.items():
        os.makedirs(os.path.join(args.out_dir, os.path.dirname(name)), exist_ok=True)
        np.save(os.path.join(args.out_dir, f"{name}.npy"), array)
    print(f"wrote {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

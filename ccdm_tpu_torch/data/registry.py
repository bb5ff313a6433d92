"""Dataset-module resolution by config string (port of
`ccdm_tpu/data/registry.py`).

A dataset module exposes `training_dataset / validation_dataset /
test_dataset / get_num_classes / get_ignore_class` (+ optional
`get_weights` and `is_multi_annotator`). The reference's module names and
the JAX package's (`datasets.lidc`, `ccdm_tpu.data.synthetic`, ...) map onto
the port's copies, so the same `params.yml` files work and the port imports
nothing of `ccdm_tpu`.
"""

from __future__ import annotations

import importlib

_ALIASES = {
    "datasets.lidc": "ccdm_tpu_torch.data.lidc",
    # the reference encodes the speed benchmark in the dataset name; the data
    # module is plain LIDC
    "datasets.lidc_sampling_speed": "ccdm_tpu_torch.data.lidc",
    "ccdm_tpu.data.lidc": "ccdm_tpu_torch.data.lidc",
    "datasets.synthetic": "ccdm_tpu_torch.data.synthetic",
    "ccdm_tpu.data.synthetic": "ccdm_tpu_torch.data.synthetic",
    "ccdm_tpu.data.synthetic_sampling_speed": "ccdm_tpu_torch.data.synthetic",
    "datasets.lidc_orig": "ccdm_tpu_torch.data.lidc_orig",
    "ccdm_tpu.data.lidc_orig": "ccdm_tpu_torch.data.lidc_orig",
    "datasets.cityscapes": "ccdm_tpu_torch.data.cityscapes",
    "ccdm_tpu.data.cityscapes": "ccdm_tpu_torch.data.cityscapes",
}


def resolve_dataset_module(dataset_file: str):
    name = _ALIASES.get(dataset_file, dataset_file)
    if name.split(".")[0] == "ccdm_tpu":
        raise ValueError(f"dataset module {name!r} belongs to the JAX package; the port "
                         f"imports nothing of it")
    module = importlib.import_module(name)
    for attr in ("training_dataset", "get_num_classes", "get_ignore_class"):
        if not hasattr(module, attr):
            raise AttributeError(f"dataset module {name!r} lacks required {attr}()")
    return module


def is_multi_annotator(module, dataset_file: str = "") -> bool:
    """Whether the dataset carries several expert annotations per image
    (LIDC-style test samples), which selects GED/HM-IoU validation over the
    confusion-matrix mIoU. A module may declare `is_multi_annotator()`;
    otherwise the reference's name test decides."""
    fn = getattr(module, "is_multi_annotator", None)
    if fn is not None:
        return bool(fn())
    name = dataset_file or getattr(module, "__name__", "")
    return "lidc" in name or "synthetic" in name

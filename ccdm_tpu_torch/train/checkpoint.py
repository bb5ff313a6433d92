"""Checkpoints: periodic, best-by-score, debug dumps, resume (port of
`ccdm_tpu/train/checkpoint.py`, which writes Orbax checkpoints).

Each checkpoint is one `torch.save` file, `<manager dir>/<step>/state.pt`,
holding `TrainState.tree()`: the keys of the reference's `objects_to_save`,
`model` (the fp32 master parameters), `average_model` (their EMA),
`opt_state` and `step`, and for a trainable feature encoder
`feature_cond_encoder` and `average_feature_cond_encoder` (a frozen one is
not saved). Managers under the experiment directory:

- `model/`: periodic, the newest 3 kept;
- `best_ged/` (minimised), `best_hmiou/` and `best_miou/` (maximised), the
  best 3 kept, each step's score in `score.json` beside it;
- `debug_state/`: the one-shot dump of an invalid loss, with the recent
  batches under `tensors`.

Saves are synchronous and atomic: a file is written under a temporary name
and renamed, so a reader never sees half a checkpoint. In a process group
every rank holds the same state: rank 0 writes, and every rank waits at a
barrier until it has (`parallel/mesh.py`). A state split over a model axis
is gathered whole first, with every rank taking part. A checkpoint depends
neither on the world size nor on the layout that wrote it.
"""

from __future__ import annotations

import functools
import inspect
import json
import logging
import os
import shutil
from typing import Any, Dict, Optional

import torch

from ccdm_tpu_torch.parallel import mesh

LOGGER = logging.getLogger(__name__)

FILE = "state.pt"
_BEST_MODES = {"ged": "min", "hmiou": "max", "miou": "max"}


def _steps(manager_dir: str):
    if not os.path.isdir(manager_dir):
        return []
    return sorted(int(s) for s in os.listdir(manager_dir)
                  if s.isdigit() and os.path.isfile(os.path.join(manager_dir, s, FILE)))


def _write(manager_dir: str, step: int, tree: Dict[str, Any]) -> str:
    step_dir = os.path.join(manager_dir, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, FILE)
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    return step_dir


def _on_main(save):
    """Run `save` on rank 0 only, with its `state`'s `tree()` as `tree`,
    then hold every rank at a barrier (a save that raises leaves the others
    waiting there until rank 0's process ends, which fails their barrier).
    Every rank makes the tree of a sharded state: a gather."""
    signature = inspect.signature(save)

    @functools.wraps(save)
    def wrapped(*args, **kwargs):
        state = signature.bind(*args, **kwargs).arguments["state"]
        main = mesh.process_index() == 0
        tree = state.tree() if main or state.sharded else None
        if main:
            save(*args, tree=tree, **kwargs)
        mesh.barrier()
    return wrapped


class CheckpointManagers:
    def __init__(self, output_path: str, keep: int = 3):
        self.output_path = os.path.abspath(output_path)
        self.keep = keep

    @_on_main
    def save_periodic(self, state, tree=None) -> None:
        manager = os.path.join(self.output_path, "model")
        _write(manager, state.step, tree)
        for step in _steps(manager)[:-self.keep]:
            shutil.rmtree(os.path.join(manager, str(step)))

    @_on_main
    def save_best(self, name: str, state, score: float, tree=None) -> None:
        """Save under `best_<name>/` and keep the `keep` best scores (ties:
        the newer step stays). `score` must be the same on every rank
        (`mesh.broadcast_from_main`)."""
        manager = os.path.join(self.output_path, f"best_{name}")
        step_dir = _write(manager, state.step, tree)
        with open(os.path.join(step_dir, "score.json"), "w") as f:
            json.dump({name: float(score)}, f)
        scored = []
        for step in _steps(manager):
            with open(os.path.join(manager, str(step), "score.json")) as f:
                scored.append((json.load(f)[name], step))
        sign = 1.0 if _BEST_MODES[name] == "min" else -1.0
        scored.sort(key=lambda s: (sign * s[0], -s[1]))
        for _, step in scored[self.keep:]:
            shutil.rmtree(os.path.join(manager, str(step)))

    @_on_main
    def save_debug(self, state, extras: Optional[Dict[str, Any]] = None, tree=None) -> None:
        """The debug dump of an invalid loss: the state and `extras`."""
        if extras:
            tree["tensors"] = {k: (v.detach().cpu() if torch.is_tensor(v) else v)
                               for k, v in extras.items()}
        _write(os.path.join(self.output_path, "debug_state"), state.step, tree)
        LOGGER.error("debug state saved to %s/debug_state", self.output_path)


def _resolve_file(path: str, step: Optional[int] = None) -> str:
    """The checkpoint file for an experiment directory (its `model/`), a
    manager directory (its latest or given step), a step directory or a
    file."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        return path
    if os.path.isfile(os.path.join(path, FILE)):
        return os.path.join(path, FILE)
    manager = path
    if not _steps(path) and _steps(os.path.join(path, "model")):
        manager = os.path.join(path, "model")
    steps = _steps(manager)
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps under {path!r}")
    step = steps[-1] if step is None else int(step)
    return os.path.join(manager, str(step), FILE)


def load_tree(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The raw checkpoint dict (CPU tensors)."""
    return torch.load(_resolve_file(path, step), map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state, step: Optional[int] = None):
    """Restore `state` in place from a checkpoint (see `_resolve_file`)."""
    return state.load_tree(load_tree(path, step))

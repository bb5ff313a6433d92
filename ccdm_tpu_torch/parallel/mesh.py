"""Data parallelism on `torch.distributed` (port of the data-parallel half
of `ccdm_tpu/parallel/mesh.py`).

One process per card, as PyTorch runs it: every rank holds the whole model
and its fp32 masters, takes its slice of the global batch, and the train
step sums the gradients over the ranks (`train/step.py`). The evaluators
slice their images by rank and combine partial sums once at the end.

- `process_index()` / `process_count()`: the group's rank and size, or 0 /
  1 when no process group is initialized;
- `host_slice` and `pad_chunk`: a rank's strided share of globally indexed
  work, and a tail chunk padded to one batch shape;
- `allgather_f64`, `broadcast_from_main`, `any_rank` and `barrier`: the
  host-side collectives, on CPU tensors over a `gloo` group (the default
  group where it is `gloo`, else one made beside it), so they never wait on
  the card's queue;
- `init_distributed`: the process group of a `torchrun` launch.

Not ported, by decision: the `model` axis and its tensor-parallel rule, and
`mesh_for_eval`'s sharding of one process's generation batch over its local
chips (one process per card instead; the per-element noise streams make the
result the same either way).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_host_groups = {}  # the default group -> its gloo group for host collectives


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if _initialized() else 1


_rank, _size = process_index, process_count  # host_slice's parameters shadow the names


def host_slice(n: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List[int]:
    """This rank's strided share `[p, p + P, p + 2P, ...]` of `n` globally
    indexed work items (the group's rank and size by default). Each item's
    draws come from its global index, so any rank count scores the same
    items with the same noise."""
    p = _rank() if process_index is None else process_index
    c = _size() if process_count is None else process_count
    return list(range(n))[p::c]


def pad_chunk(chunk: List[int], batch_size: int):
    """Pad a tail chunk of global indices to `batch_size` by repeating its
    last one: `(indices, real)`; only the first `real` results count. The
    repeats draw the last image's noise again, so nothing real changes."""
    real = len(chunk)
    return chunk + [chunk[-1]] * (batch_size - real), real


def _host_group():
    """The group for host-side collectives: the default one where its
    backend is gloo, else a gloo group over the same ranks, made on first
    use (every rank reaches it at the same collective)."""
    if dist.get_backend() == "gloo":
        return None
    default = dist.group.WORLD
    if default not in _host_groups:
        _host_groups[default] = dist.new_group(backend="gloo")
    return _host_groups[default]


def allgather_f64(values: Sequence[float]) -> np.ndarray:
    """Every rank's `values` as float64 rows `[process_count, len]`, in rank
    order. Confusion counts pass 2^24, so they travel as float64, never
    float32. Callers reduce the rows by + (counts, sums) or max (wall
    clock). Returns only after every rank has contributed: also a barrier."""
    local = torch.as_tensor(np.asarray(values, dtype=np.float64).reshape(-1))
    if process_count() == 1:
        return local.numpy()[None]
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local, group=_host_group())
    return torch.stack(parts).numpy()


def broadcast_from_main(*scores: float) -> tuple:
    """Rank 0's `scores` on every rank, so every rank decides on a best
    checkpoint (or anything else) from the same numbers."""
    if process_count() == 1:
        return tuple(float(s) for s in scores)
    buf = torch.tensor([float(s) for s in scores], dtype=torch.float64)
    dist.broadcast(buf, src=0, group=_host_group())
    return tuple(buf.tolist())


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank (a max over the ranks)."""
    if process_count() == 1:
        return bool(flag)
    buf = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=_host_group())
    return bool(buf.item())


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if process_count() > 1:
        dist.barrier(group=_host_group())


def init_distributed(device=None) -> torch.device:
    """Join the process group of a `torchrun` launch and return this rank's
    device: `cuda:LOCAL_RANK` (made the current device) with `nccl`, or,
    only where the caller names the CPU as `device`, the CPU with `gloo`.
    Without a card and without that request it raises, as the trainer
    does: no rank falls back to the CPU. Ranks, world size and the
    rendezvous come from torchrun's `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR` and `MASTER_PORT`. A group the caller initialized already
    is used as it is, on the current card (or the CPU)."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA device; a rank runs on its card unless "
                           "the caller passes device='cpu'")
    if _initialized():
        return torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"init_distributed: {var} is not set; launch with torchrun "
                               f"(python -m torch.distributed.run)")
    if cpu:
        dist.init_process_group("gloo")
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")
    return torch.device("cuda", local)

"""The process grid on `torch.distributed` (port of
`ccdm_tpu/parallel/mesh.py`).

One process per card, as PyTorch runs it. The JAX package's 2-D
`Mesh(data, model)` becomes a grid over the ranks, laid out as its
`np.asarray(devices).reshape(data, model)`: rank `r` has data index
`r // model` and model index `r % model`.

- `data`: each data index takes its slice of the global batch, and the
  train step sums the gradients over the data indices (`train/step.py`).
  With `model == 1` this is plain data parallelism, every rank holding the
  whole model and its fp32 masters.
- `model`: tensor parallelism. The wide convs and linears keep only their
  share of the output channels on each rank of a model group
  (`parallel/tensor.py`), and `gather_channels` makes the activation whole
  again after each of them.

- `MeshConfig`, `make_mesh`, `current` and the accessors `data_index`,
  `data_count`, `model_index`, `model_count` (0 / 1 / 0 / 1 without a
  process group; a group without a mesh made is all data); each rank's
  model group (the `model` consecutive ranks of its data index) and data
  group (the ranks of its model index);
- `gather_channels` and `all_reduce_sum`: the tensor-parallel collectives,
  always in fp32 (the cast from bf16 and back is exact);
- `process_index()` / `process_count()`: the group's rank and size, or 0 /
  1 when no process group is initialized;
- `host_slice` and `pad_chunk`: a rank's strided share of globally indexed
  work, and a tail chunk padded to one batch shape;
- `allgather_f64`, `broadcast_from_main`, `any_rank` and `barrier`: the
  host-side collectives, on CPU tensors over a `gloo` group (the default
  group where it is `gloo`, else one made beside it), so they never wait on
  the card's queue;
- `init_distributed`: the process group of a `torchrun` launch.

Not ported, by decision: `mesh_for_eval`'s sharding of one process's
generation batch over its local chips (one process per card instead; the
per-element noise streams make the result the same either way).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the `data x model` grid and its two groups
    (None where the group is the whole world or this rank alone)."""

    config: MeshConfig
    data_index: int
    model_index: int
    model_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def data_count(self) -> int:
        return self.config.data

    @property
    def model_count(self) -> int:
        return self.config.model


_meshes = {}  # (the default group, MeshConfig) -> its Mesh: groups are made once
_current: Optional[Mesh] = None


def make_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The grid of `config` (default: all data) over the process group, made
    the current one. A layout whose size is not the world size raises a
    ValueError. Every rank must call it, in the same order: it makes the
    model and data groups, each over the default group's backend."""
    world, rank = process_count(), process_index()
    config = config or MeshConfig(data=world)
    if config.data < 1 or config.model < 1 or config.num_devices != world:
        raise ValueError(f"mesh data {config.data} x model {config.model} needs "
                         f"{config.num_devices} ranks; the process group has {world} (launch "
                         f"data * model processes, one per card, with torchrun)")
    key = (dist.group.WORLD if _initialized() else None, config)
    if key not in _meshes:
        m = config.model
        model_group = data_group = None
        if m > 1:  # every rank makes every group, its own or not
            for d in range(config.data):
                group = dist.new_group([d * m + j for j in range(m)])
                if d == rank // m:
                    model_group = group
            for j in range(m):
                group = dist.new_group([d * m + j for d in range(config.data)])
                if j == rank % m:
                    data_group = group
        _meshes[key] = Mesh(config, rank // m, rank % m, model_group, data_group)
    global _current
    _current = _meshes[key]
    return _current


def current() -> Mesh:
    """The mesh `make_mesh` made last in this process group, or the
    all-data one of the group (rank r at data index r)."""
    world = dist.group.WORLD if _initialized() else None
    if _current is not None and _meshes.get((world, _current.config)) is _current:
        return _current
    return Mesh(MeshConfig(data=process_count()), process_index(), 0)


def data_index() -> int:
    return current().data_index


def data_count() -> int:
    return current().data_count


def model_index() -> int:
    return current().model_index


def model_count() -> int:
    return current().model_count


def _group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def gather_channels(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from each rank's share `x` of dim `dim`, in the
    group's rank order: contiguous, in x's dtype. It travels in fp32, as an
    all-reduce of the share written into a zeroed buffer. That call runs
    under either backend: gloo's CUDA tensors take only broadcast and
    all-reduce, and on one card only gloo can hold two ranks."""
    n = _group_size(group)
    if n == 1:
        return x
    local = x.float()
    dim = dim % x.dim()
    shape = list(local.shape)
    shape[dim] *= n
    whole = local.new_zeros(shape)
    width = local.shape[dim]
    whole.narrow(dim, dist.get_rank(group) * width, width).copy_(local)
    dist.all_reduce(whole, group=group)
    return whole.to(x.dtype)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, in fp32, returned in x's dtype."""
    if _group_size(group) == 1:
        return x
    total = x.float().contiguous()
    if total is x:
        total = x.clone()
    dist.all_reduce(total, group=group)
    return total.to(x.dtype)


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

"""CUDA graph capture and the kernel wrappers' launch counts, shared by the
graphed train step (`train/step.GraphedTrainStep`) and the graphed sampler
(`diffusion/sampling.GraphedSampler`).

A capture records launches, which run only at a replay. Each wrapper
counts a launch where it enqueues its kernel (`launches`, `path_launches`
and the backward's), so a capture moves the counts although nothing ran:
the graph's owner takes the capture's launches back out
(`captured_launches`) and adds them again at every replay
(`count_launches`). The counts then read sites x steps whether a step ran
eagerly or as a replay.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict

import torch

from ccdm_tpu_torch.ops import flash_attention as fa
from ccdm_tpu_torch.ops import group_norm as gn
from ccdm_tpu_torch.ops import quant

WARMUP_STEPS = 2  # eager steps on the capture stream before a capture

# The kernel wrappers' launch counts, by module: K2 (forward and backward),
# K1 and K3
COUNTED = ((gn, ("launches", "path_launches", "layout_launches", "launches_bwd",
                 "path_launches_bwd")),
           (fa, ("launches", "path_launches")),
           (quant, ("launches", "path_launches")))


def launch_counts() -> Dict:
    """Every counter of `COUNTED`, copied: `{(module, name): int or dict}`."""
    counts = {}
    for module, names in COUNTED:
        for name in names:
            value = getattr(module, name)
            counts[module, name] = dict(value) if isinstance(value, dict) else value
    return counts


def count_launches(delta: Dict, sign: int = 1) -> None:
    """Add `sign` times `delta` (as `launch_counts` gives, differences) to
    the wrappers' counts."""
    for (module, name), d in delta.items():
        value = getattr(module, name)
        if isinstance(value, dict):
            for key in d:
                value[key] += sign * d[key]
        else:
            setattr(module, name, value + sign * d)


def captured_launches(before: Dict) -> Dict:
    """The launches counted since `before` (a `launch_counts()` taken just
    before a capture), taken back out of the counts: what each replay of
    the captured graph adds."""
    after = launch_counts()
    delta = {key: ({k: after[key][k] - v for k, v in value.items()}
                   if isinstance(value, dict) else after[key] - value)
             for key, value in before.items()}
    count_launches(delta, -1)
    return delta


def capture_graph(fn: Callable, stream: torch.cuda.Stream, pool, generators, what: str):
    """`(graph, fn())` with `fn`'s device work captured into a new CUDA graph
    on `stream` and memory `pool`, `generators` registered with the graph.
    A capture that fails (a host sync, a copy from pageable memory, an
    unregistered generator) raises a RuntimeError that names `what` and the
    cause; nothing runs eagerly in its place.

    Python's cyclic garbage collector is kept off during the capture: it
    could free an unreachable cycle that holds an earlier CUDA graph (a
    dropped run's step), and a graph's destructor makes a call that no
    capture permits, which would break this capture."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = fn()
    except Exception as e:
        # the capture's end reports a capture that an error inside it broke:
        # name that first error too
        first = e.__context__
        cause = f"{type(e).__name__}: {e}" + (
            f" (after {type(first).__name__}: {first})" if first is not None else "")
        raise RuntimeError(f"CUDA graph capture of {what} failed: {cause}") from e
    finally:
        if collecting:
            gc.enable()
    return graph, out

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its 700 W limit), and the least time a piece of work
could take on it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate of their kind."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])

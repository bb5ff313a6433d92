"""What the per-layer readers take from the program's own spans
(`ccdm_tpu_torch/utils/trace.py`): a `torch.profiler` session records each
span as a host operation of the span's name, which a traced run keeps
among its host operations (`common.read_profile`)."""

from __future__ import annotations

CALL = "sampler.call"
STEPS = ("sampler.steps", "sampler.capture")  # the reverse steps: replays, the eager loop


def call_host_ms(run):
    """Host milliseconds a traced sampler call spends outside its reverse
    steps (conditioning, prior and keys, loading the static buffers, the
    output's copy): each `sampler.call` span less the steps' spans inside
    it, averaged over the traced calls. None where the run traced nothing
    on a device (the CPU) or the program has no such span."""
    t = run.trace
    if t is None or not t.device_ops:
        return None
    calls = [(a, b) for name, a, b in t.host_ops if name == CALL]
    if not calls:
        return None
    steps = [(a, b) for name, a, b in t.host_ops if name in STEPS]
    outside = sum(b - a - sum(max(0.0, min(b, d) - max(a, c)) for c, d in steps)
                  for a, b in calls)
    return outside / len(calls) * 1e3

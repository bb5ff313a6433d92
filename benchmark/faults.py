"""Faults planted in the program underneath a run, each of which the check
has to find (`correct` false): in the CPU tests at the tiny size and, by
`readings.py --faults`, on the card at a cell's own size.

- `stuck_step`: a reverse step that returns its state unchanged;
- `half_batch`: the UNet runs on the first half of the batch, the rest
  gets the mean of its predictions;
- `posterior_late`: every step but the last draws from the posterior at
  t - 1 in place of t (the schedule read one step off);
- `answer_altered`: the first chain of each call has its classes
  reversed where the answer is produced.

`planted(name)` patches the program's class for the duration of a `with`
block; the cell has to be built inside it, so that the sampler's graphs
capture the patched step.
"""

from __future__ import annotations

import contextlib

import torch


def stuck_step():
    from ccdm_tpu_torch.diffusion import sampling

    step = sampling.StepBody.__call__

    def stuck(self, full, last):
        x = self.x.clone()
        out = step(self, full, last)
        self.x.copy_(x)
        return out
    return sampling.StepBody, "__call__", stuck


def half_batch():
    from ccdm_tpu_torch.models import builder

    call = builder.DenoisingModel._call

    def half(self, net, x, cond, t, fc=None, **kw):
        h = x.shape[0] // 2
        if kw.get("cached_skips") is not None:  # an encoder-reuse step: the kept half's skips
            kw["cached_skips"] = tuple(s[:h] for s in kw["cached_skips"])
        out = call(self, net, x[:h], cond[:h], t[:h], None if fc is None else fc[:h], **kw)
        p = out["diffusion_out"]
        out["diffusion_out"] = torch.cat([p, p.mean(0, keepdim=True).expand(
            x.shape[0] - h, *p.shape[1:])])
        return out
    return builder.DenoisingModel, "_call", half


def posterior_late():
    from ccdm_tpu_torch.diffusion import sampling

    posterior = sampling.ReverseStep.posterior

    def late(self, x, p0, t):
        return posterior(self, x, p0, (t - 1).clamp_min(1))
    return sampling.ReverseStep, "posterior", late


def answer_altered():
    from ccdm_tpu_torch.diffusion import sampling

    finish = sampling.ReverseStep.finish

    def altered(self, x, probs, drew):
        out = finish(self, x, probs, drew).clone()
        out[0] = out[0].flip(-1)
        return out
    return sampling.ReverseStep, "finish", altered


FAULTS = {f.__name__: f for f in (stuck_step, half_batch, posterior_late, answer_altered)}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place, restored on exit."""
    owner, attr, patched = FAULTS[name]()
    saved = owner.__dict__[attr]
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, saved)

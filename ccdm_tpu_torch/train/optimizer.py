"""Optimizers and learning-rate schedules (port of
`ccdm_tpu/train/optimizer.py`, which builds them with optax).

Schedules are host functions `step (int) -> lr (float)` with the JAX
package's semantics, warm restarts included:

- `polynomial`: `coeff = max(1 - step/(total-1), 0)**power`,
  `mult = (1 - min_ratio)*coeff + min_ratio`, floored at `min_ratio`
  (clamped past the end);
- `linear-warmup-polynomial`: `1 - (1 - (step+1)/warmup_iters) *
  (1 - warmup_rate)` for `step < warmup_iters`, then polynomial;
- `exponential`: `gamma**step`; `cosine`: `0.5 (1 + cos(pi min(step,
  total)/total))`; `static` / `piecewise_static` (`[phase_end, mult]` rows,
  `step <= phase_end`);
- `lr_restart_steps` (+ `lr_restart_vals`, a compounding scalar or a list):
  boundary 0 prepended, the total appended with multiplier 0, and each
  segment re-running static/exponential/polynomial/cosine from its start.

`Optimizer` updates fp32 parameter dicts in place with optax's arithmetic:
Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay), AdamW (weight decay
0.01 added to the Adam direction) and SGD (momentum 0.9, weight decay 5e-4
added to the gradient first). The learning rate of update n is the schedule
at the count before the increment, as optax's `scale_by_schedule` reads it.
Total steps = `steps_per_epoch * optim.epochs`.

The learning rate and Adam's bias corrections `1 - b**count` change every
update. They enter the update as device fp32 scalars that the optimizer
owns (`scalars`), written by `prepare` before each update with `fill_`, so
that the value travels as a kernel argument: the update (`apply`) then
launches the same kernels with the same arguments at every step, and a CUDA
graph of it (`train/step.py`) replays it at any count. The eager update runs
the same ops on the same tensors, so eager and graph do the same arithmetic.
optax computes these scalars in fp32 too. The ops are chosen to give on the
card the bits that the same update with host scalars gave: PyTorch's CUDA
foreach division by a host scalar multiplies by its reciprocal (so the
scalars hold `1 / (1 - b**count)`, computed on the host), and its add with
`alpha=-lr` is one fused multiply-add (so `addcmul` by tensors filled with
`-lr`: they have the parameters' shapes, because a 0-d tensor beside them
sends `_foreach_addcmul_` to one kernel a parameter). Ulp-level
changes of the masters move a later step's rounding-level gradients, and
Adam turns a sign flip there into a move of lr; keeping the bits keeps the
trajectory.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List

import torch

LOGGER = logging.getLogger(__name__)


def _polynomial_mult(min_ratio: float, power: float, total_steps: int) -> Callable:
    denom = max(total_steps - 1, 1)

    def fn(step):
        coeff = max(1.0 - step / denom, 0.0) ** power
        return max((1.0 - min_ratio) * coeff + min_ratio, min_ratio)

    return fn


def _restart_mult(name: str, p: Dict[str, Any], restarts_cfg: list, restart_vals,
                  total_steps: int, base_lr: float) -> Callable:
    """Warm-restart multiplier: boundary 0 prepended, the total appended with
    multiplier 0, a scalar `lr_restart_vals` compounding per restart (or an
    explicit list), each segment re-running the base schedule over its own
    length."""
    restarts = [int(r) for r in restarts_cfg]
    if 0 not in restarts:
        restarts.insert(0, 0)
    vals = [1.0]
    if isinstance(restart_vals, (int, float)):
        for _ in range(1, len(restarts)):
            vals.append(vals[-1] * float(restart_vals))
    else:
        if len(restart_vals) != len(restarts) - 1:
            raise ValueError("lr_restart_vals list must have one entry per restart boundary")
        vals.extend(float(v) for v in restart_vals)
    if total_steps not in restarts:
        restarts.append(total_steps)
        vals.append(0.0)
    lengths = [restarts[i + 1] - restarts[i] for i in range(len(restarts) - 1)] + [1]

    if name == "static":
        def seg_fn(base, since, seg_len):
            return base
    elif name == "exponential":
        gamma = float(p.get("gamma", 0.98))

        def seg_fn(base, since, seg_len):
            return base * gamma ** since
    elif name == "polynomial":
        power = float(p.get("power", 1.0))
        min_lr = float(p.get("min_lr", 0.0))
        min_ratio = min_lr / base_lr if min_lr > 0 else 0.0

        def seg_fn(base, since, seg_len):
            coeff = max(1.0 - since / max(seg_len - 1.0, 1.0), 0.0) ** power
            return max((base - min_ratio) * coeff + min_ratio, min_ratio)
    elif name == "cosine":
        def seg_fn(base, since, seg_len):
            return base * 0.5 * (1.0 + math.cos(math.pi * since / seg_len))
    else:
        raise ValueError(f"lr_function {name!r} does not support lr_restart_steps")

    def mult(step):
        seg = min(max(sum(step >= r for r in restarts) - 1, 0), len(restarts) - 1)
        return seg_fn(vals[seg], step - restarts[seg], lengths[seg])

    return mult


def build_lr_schedule(optim_params: Dict[str, Any], steps_per_epoch: int,
                      max_epochs: int = 1) -> Callable[[int], float]:
    """Return an absolute `step -> lr` schedule function."""
    base_lr = float(optim_params.get("learning_rate", 1e-4))
    name = optim_params.get("lr_function")
    p = dict(optim_params.get("lr_params") or {})
    epochs = int(optim_params.get("epochs", max_epochs))
    total_steps = max(steps_per_epoch * epochs, 1)

    restarts = list(optim_params.get("lr_restart_steps") or [])
    if restarts:
        mult = _restart_mult(name, p, restarts, optim_params.get("lr_restart_vals", 1),
                             total_steps, base_lr)
    elif name is None or name == "static":
        def mult(step):
            return 1.0
    elif name == "polynomial":
        min_lr = float(p.get("min_lr", 0.0))
        mult = _polynomial_mult(min_lr / base_lr if min_lr > 0 else 0.0,
                                float(p.get("power", 1.0)), total_steps)
    elif name == "cosine":
        def mult(step):
            return 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps) / total_steps))
    elif name == "exponential":
        gamma = float(p.get("gamma", 0.98))

        def mult(step):
            return gamma ** step
    elif name in ("linear-warmup-polynomial", "warmup_polynomial"):
        warmup_iters = int(p["warmup_iters"])
        warmup_rate = float(p["warmup_rate"])
        min_lr = float(p.get("min_lr", 0.0))
        poly = _polynomial_mult(min_lr / base_lr if min_lr > 0 else 0.0,
                                float(p.get("power", 1.0)), total_steps)

        def mult(step):
            if step <= warmup_iters - 1:
                return 1.0 - (1.0 - (step + 1.0) / warmup_iters) * (1.0 - warmup_rate)
            return poly(step)
    elif name == "piecewise_static":
        table = p["piecewise_static_schedule"]  # [[phase_end, mult], ...]

        def mult(step):
            idx = sum(step > row[0] for row in table)  # first phase_end >= step
            return float(table[min(idx, len(table) - 1)][1])
    else:
        raise ValueError(f"unknown lr_function {name!r}")

    return lambda step: base_lr * mult(float(step))


def _fill(tensors: List[torch.Tensor], value: torch.Tensor) -> List[torch.Tensor]:
    """`tensors`, each filled in place with the device scalar `value` (two
    multi-tensor launches)."""
    torch._foreach_zero_(tensors)
    # the Tensor overload by name: `torch._foreach_add_(tensors, value)` binds
    # a 0-d tensor to the Scalar overload, which reads it on the host
    torch.ops.aten._foreach_add_.Tensor(tensors, value)
    return tensors


class Optimizer:
    """In-place updates of a dict of fp32 parameters. `kind` is "Adam",
    "AdamW" or "SGD"; `state` is a dict: `count` (a host int) and the
    moments `mu`, `nu` (Adam, AdamW) or `trace` (SGD), each keyed like the
    parameters. `scalars` holds the device fp32 scalars of the next update
    (see `prepare`), on the device `prepare` was last given."""

    def __init__(self, kind: str, schedule: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum: float = 0.9):
        if kind not in ("Adam", "AdamW", "SGD"):
            raise ValueError(f"optimizer {kind!r} not recognized")
        self.kind, self.schedule = kind, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.momentum = weight_decay, momentum
        self.scalars: Dict[str, torch.Tensor] = {}

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        def zeros():
            return {k: torch.zeros_like(v) for k, v in params.items()}

        if self.kind == "SGD":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def prepare(self, count: int, device: torch.device) -> float:
        """Write the scalars of the update that follows update number
        `count` into `scalars` on `device`: `neg_lr`, minus the learning
        rate at `count`, and (Adam) `inv_bc1`, `inv_bc2`, the reciprocals of
        the bias corrections at `count + 1`. Returns the learning rate.
        Each is filled in place on the current stream: a replayed graph
        reads the tensor, and no host buffer is rewritten under a copy."""
        lr = self.schedule(count)
        values = {"neg_lr": -lr}
        if self.kind != "SGD":
            values.update(inv_bc1=1.0 / (1.0 - self.b1 ** (count + 1)),
                          inv_bc2=1.0 / (1.0 - self.b2 ** (count + 1)))
        for name, value in values.items():
            if name not in self.scalars or self.scalars[name].device != device:
                self.scalars[name] = torch.zeros((), dtype=torch.float32, device=device)
            self.scalars[name].fill_(value)
        return lr

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
              params: Dict[str, torch.Tensor]) -> None:
        """The update with the prepared scalars, on the device alone: no
        host value changes (`count` included), so a graph may capture it."""
        names = list(params)
        p: List[torch.Tensor] = [params[k] for k in names]
        g: List[torch.Tensor] = [grads[k] for k in names]
        neg_lr = self.scalars["neg_lr"]
        if self.kind == "SGD":
            trace = [state["trace"][k] for k in names]
            if self.weight_decay:
                g = torch._foreach_add(g, p, alpha=self.weight_decay)
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            torch._foreach_addcmul_(p, trace, _fill([torch.empty_like(t) for t in trace], neg_lr))
            return
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        denom = torch._foreach_mul(nu, self.scalars["inv_bc2"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_mul(mu, self.scalars["inv_bc1"])
        torch._foreach_div_(step, denom)
        if self.kind == "AdamW":
            torch._foreach_add_(step, p, alpha=self.weight_decay)
        torch._foreach_addcmul_(p, step, _fill(denom, neg_lr))

    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor]) -> float:
        """Apply one update to `params` and `state` in place (`prepare`,
        `apply`, then the count); returns the learning rate it used."""
        lr = self.prepare(state["count"], next(iter(params.values())).device)
        self.apply(grads, state, params)
        state["count"] += 1
        return lr


def build_optimizer(params: Dict[str, Any], steps_per_epoch: int):
    """`(Optimizer, schedule)` from a reference-format params dict."""
    if "optim" not in params:
        LOGGER.info("no optim config; defaulting to Adam(lr=1e-4)")
        return Optimizer("Adam", lambda step: 1e-4), (lambda step: 1e-4)
    p_opt = dict(params["optim"])
    name = p_opt["name"]
    schedule = build_lr_schedule(p_opt, steps_per_epoch, int(params.get("max_epochs", 1)))
    if name == "SGD":
        tx = Optimizer("SGD", schedule, momentum=float(p_opt.get("momentum", 0.9)),
                       weight_decay=float(p_opt.get("weight_decay", 0.0005)))
    elif name == "Adam":
        tx = Optimizer("Adam", schedule)
    elif name == "AdamW":
        betas = tuple(p_opt.get("betas", (0.9, 0.999)))
        tx = Optimizer("AdamW", schedule, b1=betas[0], b2=betas[1],
                       weight_decay=float(p_opt.get("weight_decay", 0.01)))
    else:
        raise ValueError(f"optimizer {name!r} not recognized")
    LOGGER.info("optimizer=%s lr_function=%s", name, p_opt.get("lr_function"))
    return tx, schedule

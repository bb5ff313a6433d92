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


class Optimizer:
    """In-place updates of a dict of fp32 parameters. `kind` is "Adam",
    "AdamW" or "SGD"; `state` is a dict: `count` and the moments `mu`, `nu`
    (Adam, AdamW) or `trace` (SGD), each keyed like the parameters."""

    def __init__(self, kind: str, schedule: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum: float = 0.9):
        if kind not in ("Adam", "AdamW", "SGD"):
            raise ValueError(f"optimizer {kind!r} not recognized")
        self.kind, self.schedule = kind, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.momentum = weight_decay, momentum

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        def zeros():
            return {k: torch.zeros_like(v) for k, v in params.items()}

        if self.kind == "SGD":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor]) -> float:
        """Apply one update to `params` and `state` in place; returns the
        learning rate it used."""
        names = list(params)
        p: List[torch.Tensor] = [params[k] for k in names]
        g: List[torch.Tensor] = [grads[k] for k in names]
        lr = self.schedule(state["count"])
        state["count"] += 1
        if self.kind == "SGD":
            trace = [state["trace"][k] for k in names]
            if self.weight_decay:
                g = torch._foreach_add(g, p, alpha=self.weight_decay)
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            torch._foreach_add_(p, trace, alpha=-lr)
            return lr
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state["count"]
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(step, denom)
        if self.kind == "AdamW":
            torch._foreach_add_(step, p, alpha=self.weight_decay)
        torch._foreach_add_(p, step, alpha=-lr)
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

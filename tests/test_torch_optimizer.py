"""Port parity of `train/optimizer.py`: every learning-rate schedule, step by
step, against the JAX package's `build_lr_schedule`, and the Adam, AdamW and
SGD updates against optax over 5 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.train.optimizer import build_lr_schedule as jax_schedule
from ccdm_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from ccdm_tpu_torch.train.optimizer import build_lr_schedule, build_optimizer

SCHEDULES = [
    ({"learning_rate": 1e-4, "lr_function": "polynomial",
      "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 10}, 100),
    ({"learning_rate": 1e-4, "lr_function": "polynomial",
      "lr_params": {"power": 0.9}, "epochs": 2}, 50),
    ({"learning_rate": 1e-4, "lr_function": "linear-warmup-polynomial",
      "lr_params": {"warmup_iters": 10, "warmup_rate": 1e-6, "power": 1.0}, "epochs": 1}, 100),
    ({"learning_rate": 3e-4, "lr_function": "warmup_polynomial",
      "lr_params": {"warmup_iters": 5, "warmup_rate": 0.1, "power": 2.0, "min_lr": 1e-5},
      "epochs": 1}, 40),
    ({"learning_rate": 0.5}, 10),
    ({"learning_rate": 0.5, "lr_function": "static"}, 10),
    ({"learning_rate": 1.0, "lr_function": "exponential", "lr_params": {"gamma": 0.9},
      "epochs": 1}, 10),
    ({"learning_rate": 1.0, "lr_function": "cosine", "epochs": 2}, 30),
    ({"learning_rate": 1.0, "lr_function": "piecewise_static",
      "lr_params": {"piecewise_static_schedule": [[40, 1.0], [50, 0.1]]}, "epochs": 1}, 50),
    # warm restarts: scalar restart_vals compounding, and an explicit list
    *[({"learning_rate": 1e-3, "lr_function": fct, "lr_params": lr_params, "epochs": 10,
        "lr_restart_steps": [40, 70], "lr_restart_vals": 0.5}, 10)
      for fct, lr_params in [("cosine", {}), ("polynomial", {"power": 1.0}),
                             ("polynomial", {"power": 1.0, "min_lr": 1e-5}),
                             ("static", {}), ("exponential", {"gamma": 0.9})]],
    ({"learning_rate": 1e-3, "lr_function": "cosine", "epochs": 10,
      "lr_restart_steps": [50], "lr_restart_vals": [0.25]}, 10),
]


@pytest.mark.parametrize("optim,steps_per_epoch", SCHEDULES,
                         ids=lambda v: v.get("lr_function", "none") if isinstance(v, dict) else v)
def test_schedule_matches_jax_step_by_step(optim, steps_per_epoch):
    ours = build_lr_schedule(optim, steps_per_epoch)
    ref = jax_schedule(optim, steps_per_epoch)
    total = steps_per_epoch * int(optim.get("epochs", 1))
    # the JAX schedule runs in fp32: a few ulps of the multiplier (cos near
    # pi, a power near 0), relative to the base rate
    atol = 1e-6 * optim["learning_rate"]
    for step in range(0, 2 * total + 2):  # past the end too: the clamp
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=2e-6, atol=atol,
                                   err_msg=f"step {step}")


def test_bad_restart_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="lr_restart_steps"):
        build_lr_schedule({"learning_rate": 1e-3, "lr_function": "piecewise_static",
                           "lr_restart_steps": [10], "epochs": 1}, 10)
    with pytest.raises(ValueError, match="not recognized"):
        build_optimizer({"optim": {"name": "Lion"}}, 10)
    tx, sched = build_optimizer({}, 10)
    assert tx.kind == "Adam" and sched(0) == 1e-4


@pytest.mark.parametrize("name,extra", [
    ("Adam", {}),
    ("AdamW", {"weight_decay": 0.05, "betas": [0.8, 0.99]}),
    ("SGD", {}),
    ("SGD", {"momentum": 0.5, "weight_decay": 0.0}),
])
def test_updates_match_optax_over_5_steps(name, extra):
    params = {"optim": {"name": name, "learning_rate": 1e-2, "lr_function": "polynomial",
                        "lr_params": {"power": 1.0, "min_lr": 1e-4}, "epochs": 1, **extra},
              "max_epochs": 1}
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    tx, _ = jax_build_optimizer(params, steps_per_epoch=8)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jp)
    ptx, _ = build_optimizer(params, steps_per_epoch=8)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pstate = ptx.init(pp)
    for step, g in enumerate(grads):
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        lr = ptx.update({k: torch.from_numpy(v) for k, v in g.items()}, pstate, pp)
        assert pstate["count"] == step + 1
        for k in p0:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} step {step} {k}")
    assert lr < 1e-2


@pytest.mark.parametrize("kind", ["Adam", "AdamW", "SGD"])
def test_the_update_reads_nothing_on_the_host_and_keeps_to_multi_tensor_ops(kind):
    """`Optimizer.apply` is what a CUDA graph of the train step captures: it
    must not read a device value on the host (a capture refuses the sync),
    and each op must be a foreach op whose tensor lists match pairwise in
    shape, so that on the card it takes the multi-tensor kernels and not
    one kernel a parameter."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ccdm_tpu_torch.train.optimizer import Optimizer

    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            calls.append((func, args))
            return func(*args, **(kwargs or {}))

    gen = torch.Generator().manual_seed(0)
    params = {str(i): torch.randn(s, generator=gen)
              for i, s in enumerate([(4, 3, 3), (5,), (2, 6)])}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    tx = Optimizer(kind, lambda c: 1e-3, weight_decay=0.01)
    state = tx.init(params)
    for count in range(2):
        tx.prepare(count, torch.device("cpu"))
        calls.clear()
        with Record():
            tx.apply(grads, state, params)
        names = [str(func) for func, _ in calls]
        assert "aten._local_scalar_dense.default" not in names
        assert all(n.startswith(("aten._foreach_", "aten.empty")) for n in names), names
        for func, args in calls:
            lists = [a for a in args if isinstance(a, (list, tuple)) and a
                     and all(torch.is_tensor(t) for t in a)]
            for other in lists[1:]:
                assert [t.shape for t in other] == [t.shape for t in lists[0]], func

"""Launches of K train steps (`steps_per_launch`) in the port against the
JAX package's `make_multi_step`, on the CPU in fp32, and the trainer's
grouping of an epoch into launches against its K = 1 trajectory.

The JAX draws are re-derived per step from the JAX step's key as
`tests/test_torch_train_step.py` derives them (`fold_in(rng, step)`) and
injected into the port's steps."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccdm_tpu_torch.data.synthetic as syn
from ccdm_tpu.diffusion.categorical import q_xt_given_x0_probs as jax_q
from ccdm_tpu.diffusion.categorical import sample_onehot as jax_sample_onehot
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from ccdm_tpu.train.state import create_train_state as jax_create_train_state
from ccdm_tpu.train.step import make_multi_step as jax_make_multi_step
from ccdm_tpu.train.step import make_train_step as jax_make_train_step
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.convert import flax_train_state_to_tree
from ccdm_tpu_torch.train.optimizer import build_optimizer
from ccdm_tpu_torch.train.state import create_train_state, master_params
from ccdm_tpu_torch.train.step import make_multi_step, make_train_step
from ccdm_tpu_torch.train.trainer import TrainingRun, launch_groups
from torch_port_util import TINY_PARAMS, load_port_weights, unzero

torch.set_num_threads(4)

B, H, W, C = 3, 32, 32, 2
# as tests/test_torch_train_step.py: base 64 (2-4 channels a GroupNorm
# group) and the flagship's learning rate
PARAMS = dict(TINY_PARAMS, polyak_alpha=0.9, max_epochs=1,
              unet_openai=dict(TINY_PARAMS["unet_openai"], base_channels=64,
                               num_head_channels=32),
              optim={"name": "Adam", "learning_rate": 1e-4, "lr_function": "polynomial",
                     "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 1})
# the trainer's runs: 12 images at batch 4, 3 steps an epoch (an odd count:
# a launch of 2 and a tail of 1)
RUN_PARAMS = {
    "dataset_file": "ccdm_tpu.data.synthetic", "batch_size": 4, "samples": 2,
    "max_epochs": 100, "time_steps": 4, "beta_schedule": "cosine", "polyak_alpha": 0.9,
    "compute_dtype": "float32",
    "optim": {"name": "Adam", "learning_rate": 1e-3, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1e-5}, "epochs": 4},
    "unet_openai": {"base_channels": 8, "channel_mult": [1, 2],
                    "attention_resolutions": [4], "num_head_channels": 4},
    "display_freq": 10 ** 9, "save_freq": 10 ** 9, "validation_freq": 10 ** 9,
    "dataset_val_max_size": 4, "validation_max_batches": 1, "progress_bar": False,
}


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(PARAMS, num_classes=C, image_channels=1)
    jparams = unzero(jax.jit(lambda key: jmodel.init(key, (H, W, 1)))(jax.random.PRNGKey(0)))
    pmodel = build_model(PARAMS, C, 1, device="cpu")
    load_port_weights(pmodel.unet, jparams)
    return jmodel, jparams, pmodel


@pytest.fixture
def small_synthetic(monkeypatch):
    monkeypatch.setattr(syn, "training_dataset",
                        lambda: syn.synthetic_training_dataset(n=12, resolution=32))
    monkeypatch.setattr(syn, "validation_dataset",
                        lambda max_size=4: syn.synthetic_test_dataset(n=4, resolution=32))


def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    masks = [(yy - rng.uniform(8, 24)) ** 2 + (xx - rng.uniform(8, 24)) ** 2
             < rng.uniform(20, 60) for _ in range(B)]
    x0 = np.eye(C, dtype=np.float32)[np.stack(masks).astype(np.int64)]
    return {"image": image, "x0": x0}


def _draws(model, batch, rng):
    """`t` and `x_t` as `ccdm_tpu.train.step.train_loss` draws them from `rng`."""
    t_key, q_key, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_key, (B,), 1, model.diffusion.time_steps + 1)
    xt = jax_sample_onehot(q_key, jax_q(model.diffusion, jnp.asarray(batch["x0"]), t))
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(xt))


def _tree(state):
    return flax_train_state_to_tree(*jax.device_get(
        (state.params, state.ema_params, state.opt_state, state.step)))


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _equal_trees(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _port_state(pmodel, tree):
    net = copy.deepcopy(pmodel.unet)  # the steps update it in place
    ptx, psched = build_optimizer(PARAMS, steps_per_epoch=20)
    state = create_train_state(master_params(net), ptx, polyak_alpha=0.9).load_tree(tree)
    return net, state, psched


@pytest.fixture(scope="module")
def jax_start(models):
    """The JAX step and its state after one step, so the converted Adam
    moments and EMA are not trivial."""
    jmodel, jparams, _ = models
    tx, sched = jax_build_optimizer(PARAMS, steps_per_epoch=20)
    jstep = jax_make_train_step(jmodel, jnp.asarray(np.ones(C, np.float32)), sched)
    state = jax_create_train_state(jparams, tx, polyak_alpha=0.9)
    rng = jax.random.PRNGKey(3)
    state, _ = jax.jit(jstep)(state, jax.tree.map(jnp.asarray, _batch(10)), rng)
    return jstep, state, rng


@pytest.mark.parametrize("k", [2, 3])
def test_multi_step_matches_jax(models, jax_start, k):
    jmodel, _, pmodel = models
    jstep, state, rng = jax_start
    net, pstate, psched = _port_state(pmodel, _tree(state))
    pstep = make_train_step(pmodel, torch.ones(C), psched)

    batches = [_batch(20 + i) for i in range(k)]
    draws = {1 + i: _draws(jmodel, b, jax.random.fold_in(rng, 1 + i))
             for i, b in enumerate(batches)}

    def injected(state, net, batch, seed, encoder_net=None):
        t, xt = draws[state.step]
        return pstep(state, net, batch, seed, encoder_net, t=t, xt=xt)

    stacked = {key: jnp.asarray(np.stack([b[key] for b in batches])) for key in batches[0]}
    state, jm = jax.jit(jax_make_multi_step(jstep))(state, stacked, rng)
    pm = make_multi_step(injected)(
        pstate, net, [{key: torch.from_numpy(v) for key, v in b.items()} for b in batches], 0)

    np.testing.assert_allclose(float(pm["loss_mean"]), float(jm["loss_mean"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(pm["lr"], float(jm["lr"]), rtol=1e-6)
    assert bool(pm["invalid"]) == bool(jm["invalid"]) is False
    assert pstate.step == int(state.step) == 1 + k
    ref, ours = _tree(state), pstate.tree()
    assert ours["opt_state"]["count"] == ref["opt_state"]["count"] == 1 + k
    for key, sub in (("model", None), ("average_model", None), ("opt_state", "mu"),
                     ("opt_state", "nu")):
        want = ref[key] if sub is None else ref[key][sub]
        got = ours[key] if sub is None else ours[key][sub]
        for name, v in want.items():
            g, v = got[name].numpy(), v.numpy()
            if name.endswith("qkv.bias") and sub is None:
                # the key bias's gradient is rounding noise in both packages
                # (tests/test_torch_train_step.py): Adam moves it by up to lr
                # a step
                keys = (np.arange(v.shape[0]) // 32) % 3 == 1
                assert np.abs(g[keys] - v[keys]).max() <= k * 2 * 1e-4, name
                g, v = g[~keys], v[~keys]
            np.testing.assert_allclose(g, v, atol=1e-5, rtol=1e-5,
                                       err_msg=f"K={k} {key} {sub or ''} {name}")
    # `invalid` is any step's: a NaN loss in the first step of a launch
    # flags the launch, though its last step is finite
    calls = []

    def first_invalid(state, net, batch, seed, encoder_net=None):
        calls.append(1)
        m = injected(state, net, batch, seed, encoder_net)
        return dict(m, invalid=torch.tensor(len(calls) == 1))

    net, pstate, _ = _port_state(pmodel, ref)
    draws.update({1 + k + i: draws[1 + i] for i in range(k)})
    pm = make_multi_step(first_invalid)(
        pstate, net, [{key: torch.from_numpy(v) for key, v in b.items()} for b in batches], 0)
    assert bool(pm["invalid"]) and len(calls) == k


def test_a_launch_of_k_equals_k_single_steps_bit_for_bit(models):
    _, _, pmodel = models
    batches = [{k: torch.from_numpy(v) for k, v in _batch(30 + i).items()} for i in range(3)]
    ptx, psched = build_optimizer(PARAMS, steps_per_epoch=20)
    runs = []
    for grouped in (False, True):
        net = copy.deepcopy(pmodel.unet)
        state = create_train_state(master_params(net), copy.deepcopy(ptx), polyak_alpha=0.9)
        step = make_train_step(pmodel, torch.ones(C), psched)
        if grouped:
            m = make_multi_step(step)(state, net, batches, 4)
            losses = [m["loss"]]
        else:
            losses = [step(state, net, b, 4)["loss"] for b in batches]
        runs.append((state.tree(), losses[-1]))
    assert _equal_trees(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def _run(tmp_path, name, max_steps, k, **overrides):
    params = dict(RUN_PARAMS, output_path=str(tmp_path / name), steps_per_launch=k,
                  **overrides)
    run = TrainingRun(params, device="cpu")
    launches = []
    launch = run._launch

    def recorded(batches):
        m = launch(batches)
        launches.append((run.state.step, len(batches), m))
        return m

    run._launch = recorded
    return run, run.run(max_steps=max_steps), launches


def test_k2_trains_the_k1_trajectory_with_a_tail_and_a_mid_epoch_resume(tmp_path,
                                                                     small_synthetic):
    # 9 steps = 3 epochs of 3 batches: at K = 2 each epoch is a launch of 2
    # and a tail of 1
    _, ref, ref_launches = _run(tmp_path, "k1", 9, 1)
    run, grouped, launches = _run(tmp_path, "k2", 9, 2)
    assert run.steps_per_epoch == 3
    assert [(s, n) for s, n, _ in launches] == [(2, 2), (3, 1), (5, 2), (6, 1), (8, 2), (9, 1)]
    assert _equal_trees(ref.tree(), grouped.tree())
    # what the launches returned: the last step's loss, the mean over the
    # launch, and nothing a later launch wrote
    losses = {s: m["loss"] for s, _, m in ref_launches}
    for s, n, m in launches:
        assert torch.equal(m["loss"], losses[s])
        if n > 1:
            assert torch.equal(m["loss_mean"], torch.stack([losses[s - i] for i in
                                                            reversed(range(n))]).mean())
    # the same run stopped in the middle of an epoch (step 4 = epoch 1,
    # batch 1) and resumed at K = 2: the remaining 2 batches are one launch
    _run(tmp_path, "first", 4, 1)
    _, resumed, launches = _run(tmp_path, "resumed", 5, 2, load_from=str(tmp_path / "first"))
    assert [(s, n) for s, n, _ in launches] == [(6, 2), (8, 2), (9, 1)]
    assert _equal_trees(ref.tree(), resumed.tree())
    from ccdm_tpu_torch.train.checkpoint import load_tree

    assert _equal_trees(load_tree(str(tmp_path / "k1")), load_tree(str(tmp_path / "resumed")))


def _crossed_at(ends, freq):
    """The launch ends at which the JAX loop's `crossed(freq)` fires: the
    launch `(prev, step]` crosses a multiple of `freq`."""
    return [s for prev, s in zip([0] + ends[:-1], ends) if prev // freq != s // freq]


def test_cadence_fires_at_the_launch_that_crosses_its_multiple(tmp_path, small_synthetic):
    run = TrainingRun(dict(RUN_PARAMS, output_path=str(tmp_path / "run"), steps_per_launch=2,
                           display_freq=4, save_freq=3, validation_freq=5), device="cpu")
    events = []
    run.validate = lambda: events.append(("validate", run.state.step))
    run.save_qualitative = lambda: None
    save = run.checkpoints.save_periodic
    run.checkpoints.save_periodic = lambda state: events.append(("save", state.step)) or save(
        state)
    log = run.metrics.log
    run.metrics.log = lambda step, values, tag: (
        events.append(("display", step)) if tag == "train" else None) or log(step, values, tag)
    run.run(max_steps=9)
    ends = [2, 3, 5, 6, 8, 9]  # launches of 2 and tails of 1 over epochs of 3
    assert _crossed_at(ends, 4) == [5, 8] and _crossed_at(ends, 3) == [3, 6, 9]
    assert [s for e, s in events if e == "display"] == _crossed_at(ends, 4)
    assert [s for e, s in events if e == "validate"] == _crossed_at(ends, 5) == [5]
    # the periodic saves, then the run end's
    assert [s for e, s in events if e == "save"] == _crossed_at(ends, 3) + [9]


def test_max_steps_stops_at_the_first_launch_boundary_past_it(tmp_path, small_synthetic):
    # 12 images at batch 3: 4 steps an epoch, whole launches of 2
    run, state, launches = _run(tmp_path, "run", 5, 2, batch_size=3)
    assert run.steps_per_epoch == 4
    assert state.step == 6 and [s for s, _, _ in launches] == [2, 4, 6]
    from ccdm_tpu_torch.train.checkpoint import load_tree

    assert load_tree(str(tmp_path / "run"))["step"] == 6


def test_an_invalid_launch_is_read_two_launches_later_and_dumps_its_batches(
        tmp_path, small_synthetic):
    # batch 1: an epoch of 12 steps, so no epoch end drains the launches
    run = TrainingRun(dict(RUN_PARAMS, output_path=str(tmp_path / "bad"), steps_per_launch=2,
                           batch_size=1), device="cpu")
    step_fn = run.step_fn

    def poisoned(state, net, batch, seed, encoder_net=None):
        m = step_fn(state, net, batch, seed, encoder_net)
        # step 3, the first step of the second launch
        return dict(m, invalid=torch.tensor(state.step == 3))

    run.step_fn = poisoned
    launched = []
    launch = run._launch
    run._launch = lambda batches: launched.append(run.state.step) or launch(batches)
    with pytest.raises(ValueError, match="at step 4"):
        run.run(max_steps=20)
    # the launch ending at step 4 was drained once two more were queued
    assert launched == [0, 2, 4, 6]
    from ccdm_tpu_torch.train.checkpoint import load_tree

    tree = load_tree(str(tmp_path / "bad" / "debug_state"))
    assert set(tree["tensors"]) == {"image", "x0", "loss"}
    assert tree["tensors"]["x0"].shape == (2, 1, 32, 32, 2)  # [K, B, ...]


@pytest.mark.parametrize("count,k,want", [
    (5, 2, [2, 2, 1]), (3, 2, [2, 1]), (4, 2, [2, 2]), (7, 3, [3, 3, 1]), (2, 3, [1, 1]),
    (3, 1, [1, 1, 1]),
])
def test_launch_groups_are_the_jax_trainers(count, k, want):
    groups = list(launch_groups(range(count), count, k))
    assert [len(g) for g in groups] == want
    assert [b for g in groups for b in g] == list(range(count))

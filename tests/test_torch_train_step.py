"""Port parity of the training step: `categorical_kl`, one step's loss and
gradients, and three full steps (Adam and EMA) from one converted
`TrainState`, against the JAX package on the CPU in fp32.

The draws are the JAX package's: `t` and `x_t` are re-derived from the JAX
step's key exactly as `ccdm_tpu/train/step.py` splits it, and injected into
the port's `train_loss`."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.diffusion.categorical import categorical_kl as jax_kl
from ccdm_tpu.diffusion.categorical import q_xt_given_x0_probs as jax_q
from ccdm_tpu.diffusion.categorical import sample_onehot as jax_sample_onehot
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from ccdm_tpu.train.state import create_train_state as jax_create_train_state
from ccdm_tpu.train.step import make_train_step as jax_make_train_step
from ccdm_tpu.train.step import train_loss as jax_train_loss
from ccdm_tpu_torch.diffusion.categorical import categorical_kl
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.convert import flax_params_to_state_dict, flax_train_state_to_tree
from ccdm_tpu_torch.train.optimizer import build_optimizer
from ccdm_tpu_torch.train.state import create_train_state, master_params
from ccdm_tpu_torch.train.step import make_train_step, train_loss
from torch_port_util import TINY_PARAMS, load_port_weights, unzero

torch.set_num_threads(4)

B, H, W, C = 3, 32, 32, 2
# base 64: every GroupNorm group holds 2-4 channels. With one channel a
# group (narrower widths) the time-embedding add in front of a GroupNorm is
# removed by its mean, and that branch's gradients are rounding noise.
PARAMS = dict(TINY_PARAMS, polyak_alpha=0.9, max_epochs=1,
              unet_openai=dict(TINY_PARAMS["unet_openai"], base_channels=64,
                               num_head_channels=32),
              # the flagship's LR: Adam moves every weight by up to ~lr a step,
              # also where the gradient is at the rounding floor and the two
              # packages' float sums give it different signs
              optim={"name": "Adam", "learning_rate": 1e-4, "lr_function": "polynomial",
                     "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 1})


def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    # a blob of class 1, so both classes carry pixels
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


def _key_rows(width: int, dh: int) -> np.ndarray:
    """The key rows of a qkv projection's `width` = heads x [q|k|v] x dh
    outputs (the reference's legacy packing)."""
    return (np.arange(width) // dh) % 3 == 1


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(PARAMS, num_classes=C, image_channels=1)
    jparams = unzero(jax.jit(lambda key: jmodel.init(key, (H, W, 1)))(jax.random.PRNGKey(0)))
    pmodel = build_model(PARAMS, C, 1, device="cpu")
    load_port_weights(pmodel.unet, jparams)
    return jmodel, jparams, pmodel


def _close(ours, ref, rel, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(ours) - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


def test_categorical_kl_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.dirichlet(np.ones(5), size=(2, 4, 4)).astype(np.float32)
    target = rng.dirichlet(np.ones(5), size=(2, 4, 4)).astype(np.float32)
    target[0, 0, 0] = [1, 0, 0, 0, 0]  # exact zeros add 0 (xlogy), as at t == 1
    pred[0, 0, 1] = [1, 0, 0, 0, 0]    # a zero prediction hits the 1e-12 clamp
    ours = categorical_kl(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    ref = np.asarray(jax_kl(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


def test_train_loss_and_grads_match_jax(models):
    jmodel, jparams, pmodel = models
    batch, rng = _batch(1), jax.random.PRNGKey(5)
    cw = np.ones(C, np.float32)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_train_loss(jmodel, p, jax.tree.map(jnp.asarray, batch), rng,
                                 jnp.asarray(cw)), has_aux=True))(jparams)
    t, xt = _draws(jmodel, batch, rng)
    net = pmodel.unet
    net.zero_grad()
    loss, aux = train_loss(pmodel, net, _torch_batch(batch), None, torch.from_numpy(cw),
                           t=t, xt=xt)
    loss.backward()
    loss = float(loss.detach())
    assert loss > 0 and not bool(aux["invalid"])
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["kl_min"]), float(ref_aux["kl_min"]), atol=1e-6)
    ref = flax_params_to_state_dict(jax.device_get(ref_grads))
    grads = dict(net.named_parameters())
    assert set(ref) == set(grads)
    for name, g in ref.items():
        _close(grads[name].grad.numpy(), g.numpy(), 1e-4, name)


def test_three_steps_from_a_converted_state_match_jax(models):
    jmodel, jparams, pmodel = models
    cw = np.ones(C, np.float32)
    tx, sched = jax_build_optimizer(PARAMS, steps_per_epoch=20)
    step_fn = jax.jit(jax_make_train_step(jmodel, jnp.asarray(cw), sched))
    state = jax_create_train_state(jparams, tx, polyak_alpha=0.9)
    rng = jax.random.PRNGKey(3)
    # one JAX step first, so the converted Adam moments and EMA are not trivial
    state, _ = step_fn(state, jax.tree.map(jnp.asarray, _batch(10)), rng)

    tree = flax_train_state_to_tree(*jax.device_get(
        (state.params, state.ema_params, state.opt_state, state.step)))
    net = copy.deepcopy(pmodel.unet)  # the steps update it in place
    ptx, psched = build_optimizer(PARAMS, steps_per_epoch=20)
    pstate = create_train_state(master_params(net), ptx, polyak_alpha=0.9).load_tree(tree)
    assert pstate.step == pstate.opt_state["count"] == 1
    pstep = make_train_step(pmodel, torch.from_numpy(cw), psched)
    for i in range(3):
        batch = _batch(11 + i)
        t, xt = _draws(jmodel, batch, jax.random.fold_in(rng, state.step))
        state, jm = step_fn(state, jax.tree.map(jnp.asarray, batch), rng)
        pm = pstep(pstate, net, _torch_batch(batch), 0, t=t, xt=xt)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(pm["lr"], float(jm["lr"]), rtol=1e-6)
    assert pstate.step == int(state.step) == 4
    ref = flax_train_state_to_tree(*jax.device_get(
        (state.params, state.ema_params, state.opt_state, state.step)))
    ours = pstate.tree()
    assert ours["opt_state"]["count"] == ref["opt_state"]["count"] == 4
    for key, sub in (("model", None), ("average_model", None), ("opt_state", "mu"),
                     ("opt_state", "nu")):
        want = ref[key] if sub is None else ref[key][sub]
        got = ours[key] if sub is None else ours[key][sub]
        for name, v in want.items():
            g, v = got[name].numpy(), v.numpy()
            if name.endswith("qkv.bias") and sub is None:
                # the key bias adds q·b_k to every logit of a query, which the
                # softmax removes: its gradient is 0 in exact arithmetic and
                # rounding noise in both packages, which Adam's normalised
                # step turns into moves of up to ~lr. Held to that bound; the
                # query and value biases are held as everything else.
                keys = _key_rows(v.shape[0], PARAMS["unet_openai"]["num_head_channels"])
                assert np.abs(g[keys] - v[keys]).max() <= 3 * 2 * 1e-4, name
                g, v = g[~keys], v[~keys]
            np.testing.assert_allclose(g, v, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{key} {sub or ''} {name}")
    # the module holds the new masters
    for name, p in net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ours["model"][name].numpy())


def test_class_weight_masking(models):
    """A zero weight removes a class's pixels from the loss, as in JAX."""
    jmodel, jparams, pmodel = models
    batch, rng = _batch(4), jax.random.PRNGKey(6)
    t, xt = _draws(jmodel, batch, rng)
    losses = {}
    jax_loss = jax.jit(lambda cw: jax_train_loss(
        jmodel, jparams, jax.tree.map(jnp.asarray, batch), rng, cw)[0])
    for name, cw in (("full", [1.0, 1.0]), ("masked", [1.0, 0.0])):
        cw = np.asarray(cw, np.float32)
        ref = jax_loss(jnp.asarray(cw))
        with torch.no_grad():
            ours, _ = train_loss(pmodel, pmodel.unet, _torch_batch(batch), None,
                                 torch.from_numpy(cw), t=t, xt=xt)
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
        losses[name] = float(ours)
    assert losses["masked"] < losses["full"]


def test_the_step_and_the_sampler_compute_fp32_convolutions_in_fp32(models):
    """PyTorch lets cuDNN run fp32 convolutions in TF32 by default. Trained
    that way on the card, the LIDC gate's model lost 0.086 GED_16 and 0.12
    HM-IoU_16 (PERF.md). The train step (forward and backward) and the
    sampler turn TF32 off for fp32 convolutions and matrix products while
    they run, and restore the caller's settings: every conv of the UNet,
    forward and backward, sees both flags off."""
    jmodel, jparams, pmodel = models
    net = copy.deepcopy(pmodel.unet)
    seen = []

    def record(*_):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    convs = [m for m in net.modules() if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))]
    hooks = [h for m in convs for h in (m.register_forward_pre_hook(record),
                                        m.register_full_backward_hook(record))]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tx, schedule = build_optimizer(PARAMS, steps_per_epoch=4)
        state = create_train_state(master_params(net), tx, polyak_alpha=0.9)
        step = make_train_step(pmodel, torch.ones(C), schedule)
        step(state, net, _torch_batch(_batch(7)), seed=3)
        assert len(seen) == 2 * len(convs) and not any(any(s) for s in seen), seen[:4]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == \
            (True, True)
        seen.clear()
        from ccdm_tpu_torch.diffusion import random

        with torch.no_grad():
            pmodel.sample(net, torch.from_numpy(_batch(8)["x0"][:1]),
                          torch.from_numpy(_batch(8)["image"][:1]), num_steps=2,
                          element_keys=random.element_keys(0, torch.arange(1), random.CHAIN))
        assert seen and not any(any(s) for s in seen)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        for h in hooks:
            h.remove()


def test_the_init_draws_flax_lecun_normal():
    """The port's own init draws what the JAX package's flax modules draw:
    lecun normal, a normal truncated at 2 sigma with variance 1/fan_in (no
    weight past 2 / (0.8796 sqrt(fan_in))), not an untruncated N(0,
    1/fan_in). Held on the flagship's widths against flax's initializer."""
    from flax import linen as nn

    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS

    model = build_model(dict(DEMO_TRAIN_PARAMS, compute_dtype="float32"), 2, 1, 128,
                        device="cpu", generator=torch.Generator().manual_seed(0))
    flax_draw = np.asarray(nn.initializers.lecun_normal()(jax.random.PRNGKey(0),
                                                         (3, 3, 64, 64)))
    flax_scaled = flax_draw.ravel() * np.sqrt(576)
    checked = 0
    for name, p in model.unet.named_parameters():
        if p.dim() < 2 or not p.any():
            continue
        fan_in = p[0].numel()
        scaled = p.detach().numpy().ravel() * np.sqrt(fan_in)
        assert np.abs(scaled).max() <= 2 / 0.87962566103423978 + 1e-5, name
        if scaled.size >= 36864:
            assert abs(scaled.std() - 1) < 0.03, (name, scaled.std())
            # the same distribution as flax's: quantiles within sampling noise
            q = np.linspace(0.05, 0.95, 7)
            np.testing.assert_allclose(np.quantile(scaled, q), np.quantile(flax_scaled, q),
                                       atol=0.06)
            checked += 1
    assert checked >= 10

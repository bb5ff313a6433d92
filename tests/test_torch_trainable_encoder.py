"""A trainable DINO encoder in the port, against the JAX package on the CPU:
three Adam steps of the joint `{"unet", "encoder"}` state from a converted
JAX state, and the trainer's frozen and trainable runs (the encoder's EMA,
its checkpoint keys, and the evaluator that loads them)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.data import cityscapes as jcs
from ccdm_tpu.models.dino import DinoFeatureEncoder as JaxEncoder
from ccdm_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from ccdm_tpu.train.state import create_train_state as jax_create_train_state
from ccdm_tpu.train.step import make_train_step as jax_make_train_step
from ccdm_tpu_torch.models.convert import flax_train_state_to_tree
from ccdm_tpu_torch.models.dino import DinoFeatureEncoder
from ccdm_tpu_torch.train.checkpoint import load_tree
from ccdm_tpu_torch.train.optimizer import build_optimizer
from ccdm_tpu_torch.train.state import ENCODER, UNET, create_train_state, master_params, prefixed
from ccdm_tpu_torch.train.step import make_train_step
from ccdm_tpu_torch.train.trainer import TrainingRun
from test_torch_cityscapes_train import CS_PARAMS, TINY_DINO, cs_batch, cs_models, jax_draws

torch.set_num_threads(4)

LR = 1e-4  # the flagship's: the bound on a move whose gradient is rounding noise
OPT_PARAMS = dict(CS_PARAMS, max_epochs=1, optim={
    "name": "Adam", "learning_rate": LR, "lr_function": "polynomial",
    "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 1})


def _noise_rows(name: str, width: int) -> np.ndarray:
    """The rows of a qkv bias whose gradient is 0 in exact arithmetic: the
    key bias adds q·b_k to every logit of a query, which the softmax removes.
    The UNet packs heads x [q|k|v] x 32; the ViT packs [q|k|v] x 16, and the
    key rows of its source block (1) are the output itself."""
    if name.startswith("blocks.0.attn.qkv.bias"):
        return (np.arange(width) // 16) == 1
    if name.endswith("qkv.bias") and not name.startswith("blocks."):
        return (np.arange(width) // 32) % 3 == 1
    return np.zeros(width, bool)


def test_three_adam_steps_with_a_trainable_encoder_match_jax():
    """Adam and the EMA over both trees, from a JAX state after one step
    (so the moments and the EMA are not trivial), then three steps each."""
    jmodel, jparams, jenc_params, pmodel = cs_models()
    cw = jcs.get_weights()
    fce = dict(TINY_DINO, train=True)
    jenc = JaxEncoder(fce)
    tx, sched = jax_build_optimizer(OPT_PARAMS, steps_per_epoch=20)
    step_fn = jax.jit(jax_make_train_step(jmodel, jnp.asarray(cw), sched,
                                          encoder_apply=lambda p, img: jenc(p, img)))
    state = jax_create_train_state({"unet": jparams, "encoder": jenc_params}, tx,
                                   polyak_alpha=0.9)
    rng = jax.random.PRNGKey(3)
    state, _ = step_fn(state, jax.tree.map(jnp.asarray, cs_batch(10)), rng)

    tree = flax_train_state_to_tree(*jax.device_get(
        (state.params, state.ema_params, state.opt_state, state.step)))
    assert {"feature_cond_encoder", "average_feature_cond_encoder"} <= set(tree)
    enc = DinoFeatureEncoder(fce)
    net, vit = copy.deepcopy(pmodel.unet), enc.init(device="cpu")
    ptx, psched = build_optimizer(OPT_PARAMS, steps_per_epoch=20)
    masters = {**prefixed(UNET, master_params(net)), **prefixed(ENCODER, master_params(vit))}
    pstate = create_train_state(masters, ptx, polyak_alpha=0.9).load_tree(tree)
    assert pstate.step == pstate.opt_state["count"] == 1
    pstep = make_train_step(pmodel, torch.from_numpy(cw), psched, encoder_apply=enc)
    for i in range(3):
        batch = cs_batch(11 + i)
        t, xt = jax_draws(jmodel, batch["x0"], jax.random.fold_in(rng, state.step))
        state, jm = step_fn(state, jax.tree.map(jnp.asarray, batch), rng)
        pm = pstep(pstate, net, {k: torch.from_numpy(v) for k, v in batch.items()}, 0, vit,
                   t=t, xt=xt)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ref = flax_train_state_to_tree(*jax.device_get(
        (state.params, state.ema_params, state.opt_state, state.step)))
    ours = pstate.tree()
    assert ours["step"] == ref["step"] == ours["opt_state"]["count"] == 4
    keys = ("model", "average_model", "feature_cond_encoder", "average_feature_cond_encoder")
    assert set(ours) == set(ref) == {*keys, "opt_state", "step"}
    moved = 0
    for key in keys:
        for name, want in ref[key].items():
            got, want = ours[key][name].numpy(), want.numpy()
            if want.ndim == 1:
                # a move driven by rounding noise: Adam's normalised step is
                # up to ~lr a step either way
                rows = _noise_rows(name, want.shape[0])
                assert np.abs(got[rows] - want[rows]).max(initial=0) <= 3 * 2 * LR, name
                got, want = got[~rows], want[~rows]
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=f"{key} {name}")
        moved += key == "feature_cond_encoder" and any(
            not torch.equal(v, torch.from_numpy(np.asarray(tree[key][n])))
            for n, v in ours[key].items())
    assert moved, "the encoder did not train"
    # the moments average gradients (and their squares): held to the
    # gradients' 1e-4 of the tensor's largest magnitude (2e-4 squared)
    for sub, rel in (("mu", 1e-4), ("nu", 2e-4)):
        for name, want in ref["opt_state"][sub].items():
            err = (ours["opt_state"][sub][name] - want).abs().max()
            assert err <= rel * want.abs().max(), f"{sub} {name}: {err}"
    # the modules hold the new masters
    for prefix, module in ((UNET, net), (ENCODER, vit)):
        for name, p in module.named_parameters():
            assert torch.equal(p.detach(), pstate.params[prefix + name]), name


@pytest.fixture
def tree(tmp_path, cityscapes_tree_factory, monkeypatch):
    root = cityscapes_tree_factory(tmp_path / "cs", splits={"train": 4, "val": 2},
                                   size=(32, 64), classes=(7, 8, 26, 0))
    monkeypatch.setenv("CCDM_CITYSCAPES_PATH", root)
    return root


# tests/test_trainable_encoder.py's run
RUN_PARAMS = {
    "dataset_file": "datasets.cityscapes",
    "dataset_pipeline_train": ["resize", "torchvision_normalise"],
    "dataset_pipeline_train_settings": {"target_size": [32, 64]},
    "dataset_pipeline_val": ["resize", "torchvision_normalise"],
    "dataset_pipeline_val_settings": {"target_size": [32, 64]},
    "dataset_val_max_size": 2,
    "batch_size": 4,
    "max_epochs": 2,
    "time_steps": 3,
    "polyak_alpha": 0.9,
    "compute_dtype": "float32",
    "optim": {"name": "Adam", "learning_rate": 1e-3},
    "unet_openai": {"base_channels": 8, "channel_mult": [1, 1, 2],
                    "attention_resolutions": [], "num_head_channels": 4},
    "display_freq": 10,
    "save_freq": 2,
    "validation_freq": 100,
    "progress_bar": False,
}


@pytest.mark.parametrize("trainable", [False, True])
def test_trainer_runs_frozen_and_trainable_encoders(tree, tmp_path, trainable):
    """Frozen: the encoder's weights stay bit for bit and stay out of the
    checkpoint. Trainable: they move, the EMA after one step is exactly
    `a p0 + (1 - a) p1`, the checkpoint holds both encoder keys, a resume
    restores them, and `CityscapesEvaluator` loading the run samples with
    the EMA encoder."""
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator

    params = dict(RUN_PARAMS, feature_cond_encoder=dict(TINY_DINO, train=trainable))
    out = tmp_path / "run"
    run = TrainingRun(dict(params, output_path=str(out)), device="cpu")
    before = {k: v.clone() for k, v in run.encoder_net.state_dict().items()}
    assert run.trainable_encoder == trainable
    state1 = run.run(max_steps=1)
    if trainable:
        a = 0.9
        for name, p0 in before.items():
            torch.testing.assert_close(state1.ema_params[ENCODER + name],
                                       a * p0 + (1 - a) * state1.params[ENCODER + name],
                                       rtol=2e-5, atol=1e-6)
    state = run.run(max_steps=1)
    assert state.step == 2
    after = run.encoder_net.state_dict()
    saved = load_tree(str(out))
    if not trainable:
        assert all(torch.equal(before[k], after[k]) for k in before)
        assert set(saved) == {"model", "average_model", "opt_state", "step"}
        assert not any(k.startswith(ENCODER) for k in state.params)
        return
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert {"feature_cond_encoder", "average_feature_cond_encoder"} <= set(saved)
    for name, value in saved["average_feature_cond_encoder"].items():
        assert torch.equal(value, state.ema_params[ENCODER + name]), name

    resumed = TrainingRun(dict(params, output_path=str(tmp_path / "r"), load_from=str(out)),
                          device="cpu")
    assert resumed.state.step == 2
    for name, p in resumed.encoder_net.named_parameters():
        assert torch.equal(p.detach(), state.params[ENCODER + name]), name

    ev = CityscapesEvaluator(dict(params, output_path=str(tmp_path / "eval"), load_from=str(out),
                                  evaluation={"resolution": "dataloader", "evaluations": 1,
                                              "evaluation_vote_strategy": "confidence"}))
    ev.build((32, 64, 3), 1, device="cpu")
    for name, p in ev.feature_net.named_parameters():
        assert torch.equal(p.detach(), state.ema_params[ENCODER + name]), name
    for name, p in ev.model.unet.named_parameters():
        assert torch.equal(p.detach(), state.ema_params[UNET + name]), name
    image = torch.from_numpy(run.val_ds.get(0)["image"][None])
    probs = ev.predict_batch(image)
    assert probs.shape == (1, 32, 64, 20) and bool(torch.isfinite(probs).all())


"""Cityscapes training in the port against the JAX package on the CPU: the
dataset dispatch, the 20-class loss and gradients with the class weights
(no encoder, a frozen tiny DINO, a trainable one), the mIoU validation, a
2-step run, and the config's copy.

The draws are the JAX package's: `t` and `x_t` are re-derived from the JAX
step's key as `ccdm_tpu/train/step.py` splits it, and injected into the
port's `train_loss`."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.data import cityscapes as jcs
from ccdm_tpu.diffusion.categorical import q_xt_given_x0_probs as jax_q
from ccdm_tpu.diffusion.categorical import sample_onehot as jax_sample_onehot
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu.models.dino import DinoFeatureEncoder as JaxEncoder
from ccdm_tpu.train.step import train_loss as jax_train_loss
from ccdm_tpu_torch.data import cityscapes as tcs
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.convert import flax_dino_to_state_dict, flax_params_to_state_dict
from ccdm_tpu_torch.models.dino import DinoFeatureEncoder
from ccdm_tpu_torch.train.step import train_loss
from ccdm_tpu_torch.train.trainer import TrainingRun, _build_datasets
from torch_port_util import load_port_weights, unzero

torch.set_num_threads(4)
REPO = Path(__file__).resolve().parents[1]


# the parity model (test_torch_trainable_encoder.py shares it): 20 classes
# at 32x64. Base 64 gives every
# GroupNorm group 2 channels; with one channel a group the time-embedding
# add in front of a GroupNorm is removed by its mean, and that branch's
# gradients are rounding noise in both packages.
CS_B, CS_H, CS_W, CS_C = 2, 32, 64, 20
CS_UNET = {"base_channels": 64, "channel_mult": [1, 1], "attention_resolutions": [2],
           "num_head_channels": 32}
# a tiny DINO (as tests/test_trainable_encoder.py) injected before input
# block 4 (ds 2): stride 2 gives a 13x29 grid, upsampled to 16x32
TINY_DINO = {"type": "dino", "model": "dino_vits8", "output_stride": 2, "target_layer": 4,
             "source_layer": 1, "channels": 16,
             "vit_config": {"embed_dim": 16, "depth": 2, "num_heads": 2, "patch_size": 8}}
CS_PARAMS = {"beta_schedule": "cosine", "beta_schedule_params": {"s": 0.008}, "time_steps": 3,
             "compute_dtype": "float32", "unet_openai": CS_UNET}
CS_FEATURE_SHAPE = (CS_H // 2, CS_W // 2, 16)


def cs_batch(seed: int):
    """A batch of CS_B noise images with 20-class labels that include the
    ignore class 19."""
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((CS_B, CS_H, CS_W, 3)).astype(np.float32)
    labels = rng.choice([0, 2, 7, 13, 19], size=(CS_B, CS_H, CS_W))
    return {"image": image, "x0": np.eye(CS_C, dtype=np.float32)[labels]}


def jax_draws(model, x0: np.ndarray, rng):
    """`t` and `x_t` as `ccdm_tpu.train.step.train_loss` draws them from
    `rng`, as torch tensors."""
    t_key, q_key, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_key, (x0.shape[0],), 1, model.diffusion.time_steps + 1)
    xt = jax_sample_onehot(q_key, jax_q(model.diffusion, jnp.asarray(x0), t))
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(xt))


def cs_models():
    """The JAX UNet (with the tiny DINO's concat) and the DINO's weights,
    zero leaves redrawn, and the port's UNet holding the same weights."""
    params = dict(CS_PARAMS, feature_cond_encoder=TINY_DINO)
    jmodel = jax_build_model(params, num_classes=CS_C, image_channels=3)
    jparams = unzero(jax.jit(lambda key: jmodel.init(
        key, (CS_H, CS_W, 3), feature_shape=CS_FEATURE_SHAPE))(jax.random.PRNGKey(0)))
    jenc = unzero(JaxEncoder(TINY_DINO).init(jax.random.PRNGKey(7), (CS_H, CS_W, 3)), seed=2)
    pmodel = build_model(params, CS_C, 3, device="cpu")
    load_port_weights(pmodel.unet, jparams)
    return jmodel, jparams, jenc, pmodel


# the trainer on a fake tree: 32x64 images, 16x32 training crops
TREE_PARAMS = {
    "dataset_file": "datasets.cityscapes",
    "dataset_pipeline_train": ["flip", "resize", "colorjitter", "torchvision_normalise"],
    "dataset_pipeline_train_settings": {"target_size": [16, 32]},
    "dataset_pipeline_val": ["resize", "torchvision_normalise"],
    "dataset_pipeline_val_settings": {"target_size": [16, 32]},
    "dataset_val_max_size": 3,
    "batch_size": 4,
    "max_epochs": 1,
    "time_steps": 3,
    "polyak_alpha": 0.9,
    "compute_dtype": "float32",
    "optim": {"name": "Adam", "learning_rate": 1e-3},
    "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [4],
                    "num_head_channels": 4},
    "display_freq": 1,
    "save_freq": 10,
    "validation_freq": 2,
    "n_validation_images": 1,
    "n_validation_predictions": 1,
    "progress_bar": False,
}


@pytest.fixture
def tree(tmp_path, cityscapes_tree_factory, monkeypatch):
    root = cityscapes_tree_factory(tmp_path / "cs", splits={"train": 8, "val": 3},
                                   size=(32, 64), classes=(7, 8, 11, 26, 0))
    monkeypatch.setenv("CCDM_CITYSCAPES_PATH", root)
    return root


def _close(ours, ref, what):
    """Within 1e-4 of the reference tensor's largest magnitude."""
    ref = np.asarray(ref)
    err = np.abs(np.asarray(ours) - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= 1e-4 * scale, f"{what}: max err {err} > 1e-4 x {scale}"


@pytest.fixture(scope="module")
def models():
    """The UNet without and with the tiny DINO's concat, JAX and port, the
    same weights in both; and the DINO's weights."""
    jmodel, jparams, jenc, pmodel = cs_models()
    plain = jax_build_model(CS_PARAMS, num_classes=CS_C, image_channels=3)
    plain_params = unzero(jax.jit(lambda key: plain.init(key, (CS_H, CS_W, 3)))(
        jax.random.PRNGKey(0)))
    pplain = build_model(CS_PARAMS, CS_C, 3, device="cpu")
    load_port_weights(pplain.unet, plain_params)
    return {"none": (plain, plain_params, pplain), "dino": (jmodel, jparams, pmodel),
            "encoder": jenc}


def test_build_datasets_match_jax(tree):
    from ccdm_tpu.train.trainer import _build_datasets as jax_build_datasets

    params = dict(TREE_PARAMS)
    module, train, val = _build_datasets(params)
    jmodule, jtrain, jval = jax_build_datasets(params)
    assert module is tcs and jmodule is jcs
    for ours, ref in ((train, jtrain), (val, jval)):
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            a, b = ours.get(i, np.random.default_rng(i)), ref.get(i, np.random.default_rng(i))
            assert a["image"].shape == (16, 32, 3)  # the pipeline ran: resized
            for key in ("image", "x0", "label"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} {i}")


@pytest.mark.parametrize("mode", ["none", "frozen", "trainable"])
def test_loss_and_grads_at_20_classes_match_jax(models, mode):
    """`train_loss` at C=20 with `get_weights()` (the ignore class zeroed),
    and its gradients, against `jax.value_and_grad` of the JAX loss: with no
    encoder, a frozen DINO (no encoder gradient) and a trainable one."""
    jmodel, jparams, pmodel = models["none" if mode == "none" else "dino"]
    jenc_params = models["encoder"]
    batch, rng = cs_batch(1), jax.random.PRNGKey(5)
    cw = tcs.get_weights()
    assert cw[19] == 0 and np.array_equal(cw, jcs.get_weights())
    jbatch = jax.tree.map(jnp.asarray, batch)
    fce = dict(TINY_DINO, train=mode == "trainable")
    jenc = JaxEncoder(fce)

    def jax_loss(tree):
        fc = None if mode == "none" else jenc(tree["encoder"], jbatch["image"])
        return jax_train_loss(jmodel, tree["unet"], jbatch, rng, jnp.asarray(cw), fc)

    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {"unet": jparams, "encoder": jenc_params})

    net, fc, vit = pmodel.unet, None, None
    net.zero_grad()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mode != "none":
        enc = DinoFeatureEncoder(fce)
        vit = enc.init(device="cpu")
        vit.load_state_dict(flax_dino_to_state_dict(jenc_params), strict=True)
        fc = enc(vit, tbatch["image"])
        assert fc.shape == (CS_B, *CS_FEATURE_SHAPE) and fc.requires_grad == (mode == "trainable")
    t, xt = jax_draws(jmodel, batch["x0"], rng)
    loss, aux = train_loss(pmodel, net, tbatch, None, torch.from_numpy(cw), fc, t=t, xt=xt)
    loss.backward()
    assert not bool(aux["invalid"])
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ref = flax_params_to_state_dict(jax.device_get(ref_grads["unet"]))
    params = dict(net.named_parameters())
    assert set(ref) == set(params)
    for name, g in ref.items():
        _close(params[name].grad.numpy(), g.numpy(), name)
    if mode == "frozen":
        assert all(p.grad is None and not p.requires_grad for p in vit.parameters())
    if mode == "trainable":
        ref = flax_dino_to_state_dict(jax.device_get(ref_grads["encoder"]))
        grads = {n: p.grad for n, p in vit.named_parameters()}
        assert set(ref) == set(grads)
        assert any(float(g.abs().max()) > 0 for g in ref.values())
        for name, g in ref.items():
            got = grads[name] if grads[name] is not None else torch.zeros_like(g)
            _close(got.numpy(), g.numpy(), f"encoder {name}")


def _stub(net, images, key=0, indices=None, **_):
    """A sampler stand-in: a fixed map of the image, [B, 1, H, W] classes."""
    images = np.asarray(images)
    return np.floor((images[..., 0] + 3) * 4).astype(np.int64)[:, None] % CS_C


def test_validate_miou_matches_jax(tree, tmp_path):
    """The val and train-split mIoU of both trainers on one tree, their
    samplers stubbed to return the same maps."""
    from ccdm_tpu.train.trainer import TrainingRun as JaxRun

    params = dict(TREE_PARAMS, dataset_val_max_size=None)
    ours = TrainingRun(dict(params, output_path=str(tmp_path / "ours")), device="cpu")
    ref = JaxRun(dict(params, output_path=str(tmp_path / "ref")))
    ours._sampler = lambda *a: (lambda *s, **k: torch.from_numpy(_stub(*s, **k)))
    ref._val_sampler = lambda *a: (lambda *s, **k: jnp.asarray(_stub(*s, **k)))
    pairs = [(ours.validate_miou(), ref.validate_miou()),
             (ours.validate_miou(max_images=6, dataset=ours.train_ds),
              ref.validate_miou(max_images=6, dataset=ref.train_ds))]
    for got, want in pairs:
        assert 0 < want < 1
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert pairs[0][0] != pairs[1][0]


def test_run_train_writes_best_miou(tree, tmp_path, capsys):
    """Two steps through the train CLI and a validation at step 2 (as
    tests/test_trainer_cityscapes.py): `best_miou/2` and a val line with
    `mIoU` and `mIoU_train`."""
    from ccdm_tpu_torch.cli import train as cli

    out = tmp_path / "run"
    path = tmp_path / "params.json"
    path.write_text(json.dumps(dict(TREE_PARAMS, output_path=str(out))))
    cli.main([str(path), "--max-steps", "2", "--device", "cpu"])
    assert "trained to step 2" in capsys.readouterr().out
    assert (out / "best_miou" / "2" / "state.pt").is_file()
    score = json.loads((out / "best_miou" / "2" / "score.json").read_text())["miou"]
    events = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    val = [e for e in events if e["tag"] == "val"]
    assert len(val) == 1 and val[0]["mIoU"] == score
    assert all(0 <= val[0][k] <= 1 for k in ("mIoU", "mIoU_train"))
    assert (out / "images_000002.png").is_file()  # the grid of a label-keyed set


def test_cityscapes_train_params_match_the_yaml():
    from ccdm_tpu.config import load_params, with_defaults
    from ccdm_tpu_torch import CITYSCAPES_DINO_TRAIN_PARAMS, CITYSCAPES_TRAIN_PARAMS

    want = with_defaults(load_params(str(REPO / "configs/params_cityscapes.yml")))
    assert CITYSCAPES_TRAIN_PARAMS == want
    want["feature_cond_encoder"] = dict(want["feature_cond_encoder"], type="dino")
    assert CITYSCAPES_DINO_TRAIN_PARAMS == want
    assert CITYSCAPES_DINO_TRAIN_PARAMS["feature_cond_encoder"]["train"] is False

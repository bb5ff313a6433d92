"""Checkpoints in and out of the reference's schema: `{"model",
"average_model"}` fp32 UNet state dicts in the reference's key names (what
`scripts/export_torch_checkpoint.py` writes from JAX params through
`flax_unet_to_torch`).

In: such a `.pt` written from JAX params loads through
`eval/lidc_uncertainty.load_eval_params`, `build_eval_feature_fn` and
`train/checkpoint.load_tree`, and the port's forward on it equals the JAX
UNet's within 2e-5 (fp32, the port's UNet parity bound); a file that also
carries the reference trainer's other entries and a UNet entry the model
does not build loads with a warning, and one that lacks a UNet entry is
refused. Out: `tools/export_torch_checkpoint.py` writes what the JAX
package's `scripts/export_torch_checkpoint.py` writes from the same train
state (a JAX state saved by the JAX package and carried into the port by
`flax_train_state_to_tree`; array for array, exact, a joint UNet + DINO
state's UNet alone in both); on a port run it writes that schema, which
reloads bit for bit, and the LIDC harness gives the same results from the
`.pt` as from the run directory (exact, on the CPU)."""

import logging
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccdm_tpu_torch.data.synthetic as syn
from ccdm_tpu.models.torch_convert import flax_unet_to_torch
from ccdm_tpu.models.unet import create_unet as jax_create_unet
from ccdm_tpu_torch.eval.lidc_uncertainty import build_eval_feature_fn, load_eval_params
from ccdm_tpu_torch.models.unet import create_unet
from ccdm_tpu_torch.train.checkpoint import _resolve_file, _write, load_tree
from torch_port_util import TINY_UNET

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

B, H, W, C = 2, 32, 32, 2
KW = dict(image_size=TINY_UNET["image_size"], base_channels=TINY_UNET["base_channels"],
          out_channels=C, num_res_blocks=2, channel_mult=TINY_UNET["channel_mult"],
          attention_resolutions=TINY_UNET["attention_resolutions"],
          num_head_channels=TINY_UNET["num_head_channels"])


def _draw(shape, name, rng):
    """A weight of the Flax tree: kernels N(0, 1/fan_in), GroupNorm scales
    near 1, biases small (no init to compile)."""
    if len(shape) >= 2:
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    base = 1.0 if name == "scale" else 0.0
    return (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def _drawn(shapes, rng):
    """A Flax tree of `jax.eval_shape`'s shapes, each leaf from `_draw`."""
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _draw(s.shape, str(getattr(path[-1], "key", path[-1])), rng), shapes)


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    """JAX params (drawn with NumPy in the Flax tree's shapes), and the `.pt`
    the JAX export script would write from them (`average_model` the
    params, `model` the params halved)."""
    flax_unet = jax_create_unet(**KW, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    xt = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))]
    cond = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    shapes = jax.eval_shape(lambda: flax_unet.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(xt), jnp.asarray(cond),
        jnp.ones((B,), jnp.int32)))["params"]
    params = _drawn(shapes, rng)
    other = jax.tree.map(lambda x: x * 0.5 + 0.01, params)
    path = tmp_path_factory.mktemp("ref") / "best_model.pt"
    torch.save({key: {k: torch.from_numpy(np.array(v)) for k, v in flax_unet_to_torch(p).items()}
                for key, p in (("model", other), ("average_model", params))}, path)
    return flax_unet, params, path, xt, cond


def test_a_reference_pt_loads_and_runs_as_the_jax_unet(reference_pt):
    flax_unet, params, path, xt, cond = reference_pt
    assert _resolve_file(str(path)) == str(path)
    tree = load_tree(str(path))
    assert set(tree) == {"model", "average_model"}
    net = load_eval_params({"load_from": str(path)}, create_unet(**KW, dtype=torch.float32))
    for name, value in net.state_dict().items():
        assert torch.equal(value, tree["average_model"][name]), name
    t = np.array([7, 201], dtype=np.int32)
    ref = jax.jit(flax_unet.apply)({"params": params}, jnp.asarray(xt), jnp.asarray(cond),
                                   jnp.asarray(t))
    with torch.no_grad():
        ours = net.eval()(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(t))
    np.testing.assert_allclose(ours["diffusion_out"].numpy(), np.asarray(ref["diffusion_out"]),
                               atol=2e-5, rtol=0)
    # the bf16 torso takes the fp32 file too, each tensor rounded once
    bf16 = load_eval_params({"load_from": str(path)}, create_unet(**KW, dtype=torch.bfloat16))
    for name, value in bf16.state_dict().items():
        assert torch.equal(value, tree["average_model"][name].to(value.dtype)), name


def test_the_encoder_of_a_reference_pt_comes_from_weights(reference_pt, tmp_path):
    """The reference's file holds no encoder: `build_eval_feature_fn` takes
    the `weights:` `.npz` (here the encoder's own random draw, saved)."""
    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder

    *_, path, _, _ = reference_pt
    vit_config = dict(embed_dim=16, depth=2, num_heads=2, patch_size=8, pretrain_size=32)
    fce = {"type": "dino", "model": "dino_vits8", "vit_config": vit_config, "source_layer": 1,
           "output_stride": 8}
    vit = DinoFeatureEncoder(fce).init(torch.Generator().manual_seed(3), device="cpu")
    from ccdm_tpu_torch.tools.convert_dino_checkpoint import convert

    np.savez(tmp_path / "w.npz", **convert({k: v.numpy() for k, v in vit.state_dict().items()}))
    encoder, shape, net = build_eval_feature_fn(
        {"load_from": str(path), "feature_cond_encoder": dict(fce, weights=str(tmp_path / "w.npz"))},
        (32, 64, 3), device="cpu")
    assert shape == (4, 8, 16)
    for name, value in net.state_dict().items():
        assert torch.equal(value, vit.state_dict()[name]), name


def test_extra_entries_warn_and_a_missing_one_is_refused(reference_pt, tmp_path, caplog):
    *_, path, _, _ = reference_pt
    tree = torch.load(path, weights_only=True)
    extra = dict(tree, optimizer={"state": {}, "param_groups": []}, epoch=3)
    extra["average_model"] = dict(tree["average_model"],
                                  **{"out_ce.2.weight": torch.zeros(2, 16, 3, 3)})
    torch.save(extra, tmp_path / "extra.pt")
    with caplog.at_level(logging.WARNING):
        net = load_eval_params({"load_from": str(tmp_path / "extra.pt")},
                               create_unet(**KW, dtype=torch.float32))
    assert "out_ce.2.weight" in caplog.text
    assert torch.equal(net.state_dict()["out.2.weight"], tree["average_model"]["out.2.weight"])
    short = {"average_model": {k: v for k, v in tree["average_model"].items()
                               if k != "out.2.bias"}}
    torch.save(short, tmp_path / "short.pt")
    with pytest.raises(KeyError, match="out.2.bias"):
        load_eval_params({"load_from": str(tmp_path / "short.pt")},
                         create_unet(**KW, dtype=torch.float32))


@pytest.mark.parametrize("kind", ["unet", "joint"])
def test_export_equals_the_jax_scripts(reference_pt, tmp_path, monkeypatch, kind):
    import optax

    from ccdm_tpu.models.dino import DinoFeatureEncoder as JaxEncoder
    from ccdm_tpu.train.checkpoint import CheckpointManagers
    from ccdm_tpu.train.state import create_train_state as jax_create_train_state
    from ccdm_tpu_torch.models.convert import flax_train_state_to_tree
    from ccdm_tpu_torch.tools import export_torch_checkpoint

    _, params, *_ = reference_pt
    ema = jax.tree.map(lambda x: x * 0.5 + 0.01, params)
    if kind == "joint":  # a trainable encoder's state: {"unet", "encoder"} trees
        dino = {"type": "dino", "model": "dino_vits8", "output_stride": 2, "source_layer": 1,
                "vit_config": {"embed_dim": 16, "depth": 2, "num_heads": 2, "patch_size": 8}}
        enc = _drawn(jax.eval_shape(lambda: JaxEncoder(dino).init(jax.random.PRNGKey(7),
                                                                  (H, W, 3))),
                     np.random.default_rng(7))
        params, ema = {"unet": params, "encoder": enc}, {"unet": ema, "encoder": enc}
    state = jax_create_train_state(params, optax.adam(1e-3), ema_params=ema).replace(
        step=jnp.asarray(3, jnp.int32))
    managers = CheckpointManagers(str(tmp_path / "jax_run"))
    managers.save_periodic(state)
    managers.close()
    _write(str(tmp_path / "port_run" / "model"), 3, flax_train_state_to_tree(*jax.device_get(
        (state.params, state.ema_params, state.opt_state, state.step))))

    assert export_torch_checkpoint.main([str(tmp_path / "port_run"),
                                         str(tmp_path / "port.pt")]) == 0
    monkeypatch.setattr(sys, "argv", ["export_torch_checkpoint.py", str(tmp_path / "jax_run"),
                                      str(tmp_path / "jax.pt")])
    runpy.run_path(str(REPO / "scripts" / "export_torch_checkpoint.py"), run_name="__main__")
    ours = torch.load(tmp_path / "port.pt", weights_only=True)
    ref = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert set(ours) == set(ref) == {"model", "average_model"}
    for key in ref:
        assert set(ours[key]) == set(ref[key]) and len(ref[key]) > 100, key
        for name, want in ref[key].items():
            got = ours[key][name]
            assert got.dtype == want.dtype == torch.float32, (key, name)
            assert torch.equal(got, want), (key, name)
    assert not torch.equal(ours["model"]["out.2.bias"], ours["average_model"]["out.2.bias"])


SMOKE = {
    "dataset_file": "ccdm_tpu.data.synthetic", "batch_size": 4, "samples": 2, "max_epochs": 1,
    "time_steps": 4, "beta_schedule": "cosine", "polyak_alpha": 0.9,
    "compute_dtype": "float32",
    "optim": {"name": "Adam", "learning_rate": 1e-3, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1e-5}, "epochs": 1},
    "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [4],
                    "num_head_channels": 4},
    "display_freq": 2, "save_freq": 2, "validation_freq": 10 ** 6, "progress_bar": False,
    "mesh": {"model": 1}, "dataset_val_max_size": 2,
}


def test_export_writes_the_reference_schema_and_evaluates_the_same(tmp_path, monkeypatch):
    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty
    from ccdm_tpu_torch.tools import export_torch_checkpoint
    from ccdm_tpu_torch.train.trainer import run_train

    monkeypatch.setattr(syn, "training_dataset",
                        lambda: syn.synthetic_training_dataset(n=8, resolution=32))
    monkeypatch.setattr(syn, "test_dataset", lambda max_size=2: syn.synthetic_test_dataset(
        n=2, resolution=32))
    run = tmp_path / "run"
    state = run_train(dict(SMOKE, output_path=str(run)), max_steps=2, device="cpu")
    out = tmp_path / "exported.pt"
    assert export_torch_checkpoint.main([str(run), str(out), "--step", "2"]) == 0
    written = torch.load(out, weights_only=True)
    assert set(written) == {"model", "average_model"}
    for key, ref in (("model", state.params), ("average_model", state.ema_params)):
        assert set(written[key]) == set(ref)
        for name, value in written[key].items():
            assert value.dtype == torch.float32 and torch.equal(value, ref[name]), (key, name)
    results = []
    for source in (run, out):
        params = dict(SMOKE, load_from=str(source), evaluations=[1, 2], batch_size=2,
                      evaluation_path=str(tmp_path / f"eval_{source.name}"),
                      evaluation_vote_strategy="confidence")
        res = eval_lidc_uncertainty(params, device="cpu")
        results.append({k: v for k, v in res.items() if not k.endswith(("seconds", "_per_sec"))})
    assert results[0] == results[1]

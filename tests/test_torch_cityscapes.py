"""Port parity: the Cityscapes inference path.

The configuration copy against the YAML file; the UNet with the DINO
feature concat and with `return_skips`/`cached_skips` against the Flax UNet
at a narrow Cityscapes structure (base 16, 64x128 images, image_size 256:
six levels, attention at ds {8,16,32}, the concat before input block 10);
and `CityscapesEvaluator` end to end — DINO, the index-state sampler, the
vote mean, the upsample and the argmax — against the JAX evaluator, with
the JAX sampler's noise injected.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.config import load_params
from ccdm_tpu.config import with_defaults as jax_with_defaults
from ccdm_tpu.diffusion.sampling import sample_prior_per_key
from ccdm_tpu.eval.cityscapes_eval import CityscapesEvaluator as JaxEvaluator
from ccdm_tpu.models.unet import create_unet as jax_create_unet
from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS
from ccdm_tpu_torch.config import with_defaults
from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator
from ccdm_tpu_torch.models.convert import flax_dino_to_state_dict, flax_params_to_state_dict
from ccdm_tpu_torch.models.unet import create_unet
from torch_port_util import load_port_weights, unzero

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
B, H, W, C, CF = 2, 64, 128, 20, 48
VIT = dict(embed_dim=CF, depth=2, num_heads=2, patch_size=8, pretrain_size=32)


def test_cityscapes_params_match_the_yaml():
    raw = load_params(str(REPO / "configs/params_cityscapes_eval.yml"))
    assert CITYSCAPES_EVAL_PARAMS == jax_with_defaults(raw)
    assert with_defaults(raw) == jax_with_defaults(raw)
    for params in ({}, {"evaluation_vote_strategy": "confidence"},
                   {"evaluation_vote_strategy": "confidence", "step_T_sample": "majority"},
                   {"feature_cond_encoder": None}):
        assert with_defaults(params) == jax_with_defaults(params)


def _params(tmp_path, reuse):
    """The Cityscapes eval config at base 16, with a tiny DINO (embed 48,
    depth 2), 2 votes and T = 3, in fp32."""
    p = copy.deepcopy(CITYSCAPES_EVAL_PARAMS)
    p["unet_openai"]["base_channels"] = 16
    p["feature_cond_encoder"].update(vit_config=VIT, source_layer=1)
    p["evaluation"]["evaluations"] = 2
    p.update(compute_dtype="float32", time_steps=3, encoder_reuse=reuse,
             output_path=str(tmp_path))
    return p


class _Images:
    """The one call the JAX evaluator's `build` makes of a dataset: a
    256x512 image, so image_size = 256 picks the Cityscapes structure; the
    evaluators then run on 64x128 images."""

    def get(self, index, rng=None):
        return {"image": np.zeros((256, 512, 3), np.float32)}


def _evaluators(tmp_path, reuse):
    """Both evaluators built from one config, the port's with the JAX
    evaluator's weights (every zero leaf redrawn)."""
    params = _params(tmp_path, reuse)
    jev = JaxEvaluator(params)
    jev.build(_Images(), batch_size=1)
    jev.model_params = unzero(jev.model_params)
    jev.feature_params = unzero(jev.feature_params, seed=2)
    ev = CityscapesEvaluator(params)
    ev.build((256, 512, 3), 1, device="cpu")
    load_port_weights(ev.model.unet, jev.model_params)
    ev.feature_net.load_state_dict(flax_dino_to_state_dict(jev.feature_params), strict=True)
    return jev, ev


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    return _evaluators(tmp_path_factory.mktemp("cs_eval"), 1)


def test_unet_feature_concat_and_skips_match_flax(evaluators):
    """The narrow Cityscapes UNet of the evaluators (base 16, image_size 256:
    six levels, attention at ds {8,16,32}, 48 DINO channels concatenated
    before input block 10) on 64x128 inputs, full and replayed."""
    jev, ev = evaluators
    flax_unet, params, port = jev.model.unet, jev.model_params, ev.model.unet
    rng = np.random.default_rng(0)
    xt = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))]
    cond = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    feats = rng.standard_normal((B, H // 8, W // 8, CF)).astype(np.float32)
    t = np.array([3, 240], dtype=np.int32)
    apply = jax.jit(flax_unet.apply, static_argnames="return_skips")
    ref = apply({"params": params}, jnp.asarray(xt), jnp.asarray(cond), jnp.asarray(t),
                jnp.asarray(feats), return_skips=True)
    with torch.no_grad():
        ours = port(*map(torch.from_numpy, (xt, cond, t, feats)), return_skips=True)
    assert port.feature_block == 10
    assert port.input_blocks[10][0].in_layers[0].weight.shape == (32 + CF,)
    # fp32 through ~60 layers: the bound of the flagship UNet's parity test
    np.testing.assert_allclose(ours["diffusion_out"].numpy(), np.asarray(ref["diffusion_out"]),
                               atol=2e-5, rtol=0)
    assert len(ours["skips"]) == len(ref["skips"]) == 1 + 6 * 2 + 5
    for a, b in zip(ours["skips"], ref["skips"]):  # NCHW against NHWC
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   atol=2e-5, rtol=0)
    # the replay: middle and decoder only, with another step's embedding
    t2 = np.array([2, 239], dtype=np.int32)
    ref2 = apply({"params": params}, jnp.asarray(xt), jnp.asarray(cond), jnp.asarray(t2),
                 cached_skips=ref["skips"])
    with torch.no_grad():
        ours2 = port(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(t2),
                     cached_skips=ours["skips"])
    np.testing.assert_allclose(ours2["diffusion_out"].numpy(),
                               np.asarray(ref2["diffusion_out"]), atol=2e-5, rtol=0)
    assert np.abs(ours2["diffusion_out"].numpy() - ours["diffusion_out"].numpy()).max() > 1e-4


def test_unet_refuses_a_missing_feature_map(evaluators):
    _, ev = evaluators
    with pytest.raises(ValueError, match="feature_condition"):
        ev.model.unet(torch.zeros(1, H, W, C), torch.zeros(1, H, W, 3),
                      torch.ones(1, dtype=torch.int32))


def test_converter_at_full_width():
    """The full-width Cityscapes UNet's input block 10 takes 256 + 384 = 640
    channels: the converter maps the Flax `down_10_res` leaves (shapes from
    `jax.eval_shape`, nothing computed) onto the port's module shapes."""
    kw = dict(image_size=256, base_channels=128, out_channels=C,
              attention_resolutions=(32, 16, 8), num_head_channels=32,
              feature_cond_block_idx=10, feature_cond_stride=8)
    flax_unet = jax_create_unet(**kw)
    shapes = jax.eval_shape(
        flax_unet.init, {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 256, 512, C)),
        jnp.zeros((1, 256, 512, 3)), jnp.ones((1,), jnp.int32), jnp.zeros((1, 32, 64, 384)))
    block = {name: jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                shapes["params"][name])
             for name in ("down_10_res", "down_10_attn")}
    with torch.device("meta"):
        port = create_unet(**kw, in_channels=C + 3, feature_channels=384)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()
            if k.startswith("input_blocks.10.")}
    got = {k: tuple(v.shape) for k, v in flax_params_to_state_dict(block).items()}
    assert got == want
    assert got["input_blocks.10.0.in_layers.2.weight"] == (256, 640, 3, 3)
    assert got["input_blocks.10.0.skip_connection.weight"] == (256, 640, 1, 1)


@pytest.mark.parametrize("reuse", [1, 3])
def test_evaluator_matches_jax(evaluators, tmp_path, reuse):
    """One 64x128 image, 2 votes, 3 steps (T = 3), DINO on, fp32: the vote
    mean of both evaluators under the same noise, then labels at 128x256."""
    jev, ev = evaluators if reuse == 1 else _evaluators(tmp_path, reuse)

    images = np.random.default_rng(3).standard_normal((1, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jev.predict_batch(images, key, [0]))
    # the noise JAX's make_prob_sampler draws: one key per (image, vote)
    # folded on its id, the prior from one half of `key`, step s's uniforms
    # from the other folded on the id and then s
    gid = jnp.arange(2, dtype=jnp.int32)
    k_prior, k_chain = jax.random.split(key)
    prior = sample_prior_per_key(jax.vmap(jax.random.fold_in, (None, 0))(k_prior, gid), H, W, C)
    uniforms = np.stack([np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(k_chain, g), s), (H, W), jnp.float32))
        for g in range(2)]) for s in range(3)])
    ours = ev.predict_batch(torch.from_numpy(images), prior=torch.from_numpy(np.array(prior)),
                            uniforms=torch.from_numpy(uniforms)).numpy()
    assert ours.shape == ref.shape == (1, H, W, C)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)
    agree = ours.argmax(-1) == ref.argmax(-1)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(ours[agree], ref[agree], atol=1e-4, rtol=0)
    assert np.abs(ours - 1.0 / C).max() > 1e-2

    # labels at twice the resolution, from the same probabilities on both sides
    up = jax.image.resize(jnp.asarray(ref), (1, 2 * H, 2 * W, C), method="bilinear")
    want = np.asarray(jnp.argmax(up[..., :C - 1], axis=-1))
    labels = ev.predict_labels(torch.from_numpy(ref.copy()), (2 * H, 2 * W)).numpy()
    assert labels.shape == want.shape == (1, 2 * H, 2 * W)
    assert (labels == want).mean() >= 0.999
    assert labels.max() <= C - 2  # the ignore class is never predicted


def test_evaluator_settings_and_refusals(tmp_path):
    ev = CityscapesEvaluator(CITYSCAPES_EVAL_PARAMS)
    assert (ev.num_classes, ev.ignore, ev.eval_resolution, ev.vote_strategy,
            ev.num_evaluations) == (20, 19, "original", "confidence", 1)
    # `load_from` names a checkpoint of the port's; a missing one raises
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        CityscapesEvaluator(dict(_params(tmp_path, 1), load_from=str(tmp_path / "ckpt"))).build(
            (H, W, 3), 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CityscapesEvaluator(_params(tmp_path, 1)).build((H, W, 3), 1)

"""Port parity: the index-state sampler and encoder reuse.

`theta_post_prob_from_idx` and `sample_categorical_icdf` against the JAX
package's on the same numpy inputs and the same uniforms; then the whole
reverse process, `ancestral_sampler` of the port against the JAX one on a
small UNet with C=20 classes, in the index state and in both states with
encoder reuse R = 2 and R = 3, with the JAX sampler's own noise (rebuilt
from its key) injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.diffusion import categorical as jcat
from ccdm_tpu.diffusion import sampling as jsamp
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu_torch.diffusion import categorical as tcat
from ccdm_tpu_torch.diffusion import sampling as tsamp
from ccdm_tpu_torch.models.builder import build_model
from torch_port_util import TINY_PARAMS, load_port_weights, unzero

torch.set_num_threads(2)


def _probs(shape, seed, normalised=True):
    logits = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True) if normalised else p).astype(np.float32)


@pytest.mark.parametrize("c", [2, 20])
def test_theta_post_prob_from_idx_matches_jax(c):
    td = tcat.CategoricalDiffusion.create("cosine", 250, c)
    jd = jcat.CategoricalDiffusion.create("cosine", 250, c)
    rng = np.random.default_rng(c)
    idx = rng.integers(0, c, (3, 6, 5)).astype(np.int32)
    p0 = _probs((3, 6, 5, c), c)
    t = np.array([1, 250, 117], dtype=np.int32)
    ours = tcat.theta_post_prob_from_idx(td, torch.from_numpy(idx), torch.from_numpy(p0),
                                         torch.from_numpy(t)).numpy()
    ref = np.asarray(jcat.theta_post_prob_from_idx(jd, jnp.asarray(idx), jnp.asarray(p0),
                                                   jnp.asarray(t)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    # the generic posterior of the one-hot state, up to reassociation
    generic = tcat.theta_post_prob(td, torch.from_numpy(np.eye(c, dtype=np.float32)[idx]),
                                   torch.from_numpy(p0), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(ours, generic, atol=1e-6, rtol=0)


@pytest.mark.parametrize("normalised", [True, False])
def test_icdf_draw_matches_jax_from_its_uniforms(normalised):
    """Fed the uniforms `jax.random.uniform` drew, the port draws the JAX
    indices, except where the target lies within 1e-6 of a cdf boundary:
    there the two prefix sums (fp32 cumsum here, a triangular product in
    JAX) may round to either side."""
    shape = (2, 32, 32, 20)
    probs = _probs(shape, 7, normalised) * (1.0 if normalised else 3.0)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jcat.sample_categorical_icdf(key, jnp.asarray(probs)))
    u = np.asarray(jax.random.uniform(key, shape[:-1], jnp.float32))
    ours = tcat.sample_categorical_icdf(torch.from_numpy(probs),
                                        uniforms=torch.from_numpy(u.copy())).numpy()
    cdf = np.cumsum(probs.astype(np.float64), axis=-1)
    target = u[..., None] * cdf[..., -1:]
    near = (np.abs(cdf - target) / cdf[..., -1:] < 1e-6).any(-1)
    assert near.mean() < 1e-3
    np.testing.assert_array_equal(ours[~near], ref[~near])
    assert len(np.unique(ours)) == 20  # every class drawn somewhere


def test_icdf_counts_ties_below_and_clamps():
    probs = torch.tensor([[0.5, 0.5, 0.0, 0.0]] * 4)
    u = torch.tensor([0.0, 0.5, 0.75, 1.0])
    # u=0: cdf[0] = 0.5 > 0 -> class 0; u=0.5 sits on cdf[0]: a tie counts
    # below -> class 1; u=1: every cdf entry <= target -> 4, clamped to C-1
    np.testing.assert_array_equal(
        tcat.sample_categorical_icdf(probs, uniforms=u).numpy(), [0, 1, 1, 3])


def test_icdf_generator_draws_follow_probs():
    probs = torch.tensor([0.1, 0.2, 0.0, 0.7]).expand(100_000, 4)
    from ccdm_tpu_torch.diffusion import random

    u = random.uniform(random.element_keys(0, torch.arange(1), random.CHAIN), 0, (100_000,))
    idx = tcat.sample_categorical_icdf(probs, u[0])
    freq = np.bincount(idx.numpy(), minlength=4) / 100_000
    # binomial std <= 0.0015 at 1e5 draws; 5 of them
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.0, 0.7], atol=0.0075)


B, H, W, C, K = 2, 16, 16, 20, 5


@pytest.fixture(scope="module")
def models():
    params = dict(TINY_PARAMS, time_steps=40)
    jmodel = jax_build_model(params, num_classes=C, image_channels=1, image_size=32)
    jparams = unzero(jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0), (H, W, 1)))
    tmodel = build_model(params, num_classes=C, image_channels=1, image_size=32, device="cpu")
    load_port_weights(tmodel.unet, jparams)
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    prior = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))]
    return jmodel, jparams, tmodel, cond, prior


def _jax_chain_noise(key, state, k):
    """The noise `ancestral_sampler` draws at step s from `fold_in(key, s)`:
    one uniform a pixel (index state) or a Gumbel tensor (one-hot state,
    `jax.random.categorical` is argmax(logits + gumbel))."""
    if state == "index":
        return np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(key, s), (B, H, W), jnp.float32)) for s in range(k)])
    return np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, s), (B, H, W, C), jnp.float32)) for s in range(k)])


@pytest.mark.parametrize("state,reuse,k,mode", [
    ("index", 1, K, "confidence"),
    ("index", 2, K, "confidence"),   # final step (4 % 2 == 0): a full call
    ("index", 3, K, "majority"),     # final step (4 % 3 == 1): a replay
    ("index", 1, 1, "confidence"),   # K == 1 < T: the single step draws
    ("onehot", 2, K, "confidence"),
    ("onehot", 3, K, "confidence"),
])
def test_sampler_matches_jax_under_injected_noise(models, state, reuse, k, mode):
    jmodel, jparams, tmodel, cond, prior = models
    cfg = dict(num_steps=k, step_T_sample=mode, encoder_reuse=reuse, state=state)
    key = jax.random.PRNGKey(11)
    jpair = (jmodel.denoise_fns_cached(jparams, jnp.asarray(cond)) if reuse > 1 else None)
    ref = np.asarray(jsamp.ancestral_sampler(
        jmodel.diffusion, jmodel.denoise_fn(jparams, jnp.asarray(cond)), jnp.asarray(prior),
        key, jsamp.SamplerConfig(**cfg), denoise_pair=jpair))
    noise = torch.from_numpy(_jax_chain_noise(key, state, k))
    tcond = torch.from_numpy(cond)
    with torch.inference_mode():
        tpair = (tmodel.denoise_fns_cached(tmodel.unet, tcond) if reuse > 1 else None)
        ours = tsamp.ancestral_sampler(
            tmodel.diffusion, tmodel.denoise_fn(tmodel.unet, tcond), torch.from_numpy(prior),
            tsamp.SamplerConfig(**cfg), denoise_pair=tpair,
            **{"uniforms" if state == "index" else "gumbel": noise}).numpy()
    assert ours.shape == ref.shape == (B, H, W, C)
    # fp32 on both sides: a 1e-6 difference in p0 can move a draw across a
    # boundary, so the maps may differ at a few pixels; where they agree,
    # the probabilities agree to 1e-4
    agree = ours.argmax(-1) == ref.argmax(-1)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(ours[agree], ref[agree], atol=1e-4, rtol=0)
    if mode == "confidence" and k > 1:
        np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)
        assert np.abs(ours - 1.0 / C).max() > 1e-2  # not a uniform map
    else:  # one-hot maps
        assert set(np.unique(ours)) <= {0.0, 1.0}


def test_reuse_replays_the_encoder(models):
    """With R = 3 over 5 steps the encoder runs at steps 0 and 3 only:
    2 full calls (`return_skips`) and 3 replays (`cached_skips`)."""
    _, _, tmodel, cond, prior = models
    calls = []
    full, reuse = tmodel.denoise_fns_cached(tmodel.unet, torch.from_numpy(cond))

    def count_full(x, t):
        calls.append("full")
        return full(x, t)

    def count_reuse(x, t, skips):
        calls.append("reuse")
        assert len(skips) == len(tmodel.unet.input_blocks)
        return reuse(x, t, skips)

    with torch.inference_mode():
        tsamp.ancestral_sampler(tmodel.diffusion, None, torch.from_numpy(prior),
                                tsamp.SamplerConfig(K, encoder_reuse=3),
                                element_keys=torch.zeros(B, 2, dtype=torch.int64),
                                denoise_pair=(count_full, count_reuse))
    assert calls == ["full", "reuse", "reuse", "full", "reuse"]


def test_state_resolution_matches_jax():
    for c in (2, 7, 8, 20):
        for state in ("auto", "index", "onehot"):
            assert (tsamp._resolve_state(tsamp.SamplerConfig(1, state=state), c)
                    == jsamp._resolve_state(jsamp.SamplerConfig(1, state=state), c))

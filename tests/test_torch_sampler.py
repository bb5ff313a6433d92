"""Port parity for the whole slice: `make_prob_sampler` of the port against
the JAX package's, with the JAX sampler's own noise injected into the port.

JAX draws the prior and the chain's Gumbel noise from keys folded on each
(image, sample) id; the test rebuilds exactly that noise from the same key
and hands it to the port, so both run the same trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.diffusion.sampling import sample_prior_per_key
from ccdm_tpu.diffusion.sampling import subsampled_t_values as jax_t_values
from ccdm_tpu.eval.lidc_uncertainty import make_prob_sampler as jax_make_prob_sampler
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu_torch.diffusion.sampling import SamplerConfig, ancestral_sampler, subsampled_t_values
from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
from ccdm_tpu_torch.models.builder import build_model
from torch_port_util import TINY_PARAMS, load_port_weights, unzero

torch.set_num_threads(2)

B, S, K, H, W, C = 2, 2, 4, 32, 32, 2


def _jax_noise(key, indices):
    """The prior and per-step Gumbel noise JAX's `make_prob_sampler` draws."""
    gid = (indices[:, None] * S + np.arange(S)).reshape(-1)
    k_prior, k_chain = jax.random.split(key)
    prior = sample_prior_per_key(
        jax.vmap(jax.random.fold_in, (None, 0))(k_prior, jnp.asarray(gid)), H, W, C)
    gumbel = np.stack([
        np.stack([np.asarray(jax.random.gumbel(
            jax.random.fold_in(jax.random.fold_in(k_chain, int(g)), s), (H, W, C),
            jnp.float32)) for g in gid])
        for s in range(K)])
    return np.array(prior), gumbel


@pytest.fixture(scope="module")
def slice_pair():
    jmodel = jax_build_model(TINY_PARAMS, num_classes=C, image_channels=1, image_size=H)
    params = unzero(jmodel.init(jax.random.PRNGKey(0), (H, W, 1)))
    tmodel = build_model(TINY_PARAMS, num_classes=C, image_channels=1, image_size=H,
                         device="cpu")
    load_port_weights(tmodel.unet, params)
    images = np.random.default_rng(0).standard_normal((B, H, W, 1)).astype(np.float32)
    return jmodel, params, tmodel, images


def test_sampler_matches_jax_under_injected_noise(slice_pair):
    jmodel, params, tmodel, images = slice_pair
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_make_prob_sampler(jmodel, num_samples=S, num_steps=K)(
        params, jnp.asarray(images), key))
    prior, gumbel = _jax_noise(key, np.arange(B))
    run = make_prob_sampler(tmodel, num_samples=S, num_steps=K)
    ours = run(tmodel.unet, torch.from_numpy(images),
               prior=torch.from_numpy(prior), gumbel=torch.from_numpy(gumbel)).numpy()

    assert ours.shape == ref.shape == (B, S, H, W, C)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)
    # fp32 on both sides: a 1e-6 difference in p0 can flip a Gumbel argmax
    # at a near-tie, so the maps may differ at a few pixels; where they
    # agree, the probabilities agree to 1e-4
    agree = ours.argmax(-1) == ref.argmax(-1)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(ours[agree], ref[agree], atol=1e-4, rtol=0)
    # the run is not degenerate: the samples differ from each other
    assert np.abs(ours[:, 0] - ours[:, 1]).max() > 1e-2


def test_generator_run_majority_is_onehot(slice_pair):
    _, _, tmodel, images = slice_pair
    majority = build_model(dict(TINY_PARAMS, step_T_sample="majority"), C, 1, H,
                           device="cpu")
    majority.unet.load_state_dict(tmodel.unet.state_dict())
    run = make_prob_sampler(majority, num_samples=S, num_steps=3)
    out = run(majority.unet, torch.from_numpy(images), 0)
    assert out.shape == (B, S, H, W, C)
    np.testing.assert_array_equal(out.sum(-1).numpy(), 1.0)
    assert set(np.unique(out.numpy())) <= {0.0, 1.0}
    again = run(majority.unet, torch.from_numpy(images), 0)
    torch.testing.assert_close(out, again, rtol=0, atol=0)


def test_denoising_model_sample_is_the_sampler(slice_pair):
    """`DenoisingModel.sample` on pre-repeated inputs is what
    `make_prob_sampler` runs, draw for draw under the same noise."""
    _, _, tmodel, images = slice_pair
    rng = np.random.default_rng(9)
    prior = torch.from_numpy(np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))])
    gumbel = torch.from_numpy(rng.gumbel(size=(K, B, H, W, C)).astype(np.float32))
    with torch.no_grad():
        ours = tmodel.sample(tmodel.unet, prior, torch.from_numpy(images), num_steps=K,
                             gumbel=gumbel)
    ref = make_prob_sampler(tmodel, num_samples=1, num_steps=K)(
        tmodel.unet, torch.from_numpy(images), prior=prior, gumbel=gumbel)
    torch.testing.assert_close(ours, ref[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("steps,k", [(250, 250), (250, 4), (250, 1), (1000, 37)])
def test_subsampled_t_values_match_jax(steps, k):
    np.testing.assert_array_equal(subsampled_t_values(steps, k), jax_t_values(steps, k))


def test_build_model_defaults_to_the_card():
    """Without `device`, the model builds on the card; with no card that
    raises instead of handing back a CPU model."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(TINY_PARAMS, num_classes=C, image_channels=1, image_size=H)


def test_unported_sampler_paths_raise(slice_pair):
    _, _, tmodel, _ = slice_pair
    xt = torch.zeros(1, 4, 4, C)
    fn = tmodel.denoise_fn(tmodel.unet, torch.zeros(1, 4, 4, 1))
    # the draws need per-element keys or injected noise
    with pytest.raises(ValueError, match="element_keys"):
        ancestral_sampler(tmodel.diffusion, fn, xt, SamplerConfig(2), element_keys=None)
    # encoder reuse needs the (full, reuse) pair; a state must be known
    with pytest.raises(ValueError, match="denoise_pair"):
        ancestral_sampler(tmodel.diffusion, fn, xt, SamplerConfig(2, encoder_reuse=2))
    with pytest.raises(ValueError, match="state"):
        ancestral_sampler(tmodel.diffusion, fn, xt, SamplerConfig(2, state="dense"))

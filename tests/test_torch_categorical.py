"""Port parity: `ccdm_tpu_torch.diffusion.categorical` against the JAX
package's categorical diffusion math, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.diffusion import categorical as jcat
from ccdm_tpu_torch.diffusion import categorical as tcat

torch.set_num_threads(2)

# float32 chains of a few ops on values in [0, 1]: both sides round alike
# up to reassociation, a few ulps of 1
ATOL = 1e-6


def _inputs(c, seed=0, b=3, h=5, w=4, steps=250):
    rng = np.random.default_rng(seed)
    xt = np.eye(c, dtype=np.float32)[rng.integers(0, c, (b, h, w))]
    x0 = np.eye(c, dtype=np.float32)[rng.integers(0, c, (b, h, w))]
    logits = rng.standard_normal((b, h, w, c)).astype(np.float32) * 2
    p0 = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    t = np.array([1, steps, rng.integers(2, steps)][:b], dtype=np.int32)
    return xt, x0, p0.astype(np.float32), t


def _pair(c, steps=250):
    return (tcat.CategoricalDiffusion.create("cosine", steps, c),
            jcat.CategoricalDiffusion.create("cosine", steps, c))


@pytest.mark.parametrize("c", [2, 5])
@pytest.mark.parametrize("fn,args", [
    ("q_xt_given_xtm1_probs", "xt"),
    ("q_xt_given_x0_probs", "x0"),
    ("theta_post", "xt,x0"),
    ("theta_post_prob", "xt,p0"),
    ("theta_post_prob_naive", "xt,p0"),
])
def test_matches_jax(c, fn, args):
    td, jd = _pair(c)
    xt, x0, p0, t = _inputs(c)
    named = {"xt": xt, "x0": x0, "p0": p0}
    arrays = [named[a] for a in args.split(",")]
    ours = getattr(tcat, fn)(td, *map(torch.from_numpy, arrays), torch.from_numpy(t))
    ref = getattr(jcat, fn)(jd, *map(jnp.asarray, arrays), jnp.asarray(t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("c", [2, 3, 20])
def test_theta_post_prob_matches_naive(c):
    td, _ = _pair(c)
    xt, _, p0, t = _inputs(c, seed=c)
    args = (torch.from_numpy(xt), torch.from_numpy(p0), torch.from_numpy(t))
    fast = tcat.theta_post_prob(td, *args)
    naive = tcat.theta_post_prob_naive(td, *args)
    np.testing.assert_allclose(fast.numpy(), naive.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(fast.sum(-1).numpy(), 1.0, atol=ATOL)


def test_sample_onehot_with_injected_gumbel():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0, 0] = [1.0, 0.0, 0.0, 0.0]  # exercises the 1e-12 clip
    g = rng.gumbel(size=probs.shape).astype(np.float32)
    ours = tcat.sample_onehot(torch.from_numpy(probs), gumbel=torch.from_numpy(g))
    want = np.argmax(np.log(np.clip(probs, 1e-12, None)) + g, axis=-1)
    np.testing.assert_array_equal(ours.numpy(), np.eye(4, dtype=np.float32)[want])


def test_sample_onehot_reproduces_jax_draw_from_its_gumbel():
    """`jax.random.categorical(key, logits)` is argmax(logits + gumbel(key)):
    fed the same Gumbel tensor, the port draws what JAX draws."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jcat.sample_onehot(key, jnp.asarray(probs)))
    g = np.array(jax.random.gumbel(key, probs.shape, jnp.float32))
    ours = tcat.sample_onehot(torch.from_numpy(probs), gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_max_prob_onehot_matches_jax_including_ties():
    rng = np.random.default_rng(5)
    probs = rng.random((2, 4, 4, 3)).astype(np.float32)
    probs[0, 0, 0] = [0.4, 0.4, 0.2]  # tie: both pick the first maximum
    ours = tcat.max_prob_onehot(torch.from_numpy(probs))
    ref = jcat.max_prob_onehot(jnp.asarray(probs))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_generator_draws_are_seeded_and_distributed():
    """Torch (Philox) and JAX (threefry) streams differ, so the generator
    path is checked by distribution: Gumbel mean is Euler's gamma 0.5772
    (std pi/sqrt(6) = 1.28, so 200k draws give a standard error of 0.003;
    the limit is 5 of them), and the prior, drawn from per-element streams,
    is uniform over classes and repeats under the same seed."""
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.diffusion.sampling import sample_prior_per_key

    g = tcat.gumbel_noise((200_000,), torch.Generator().manual_seed(0))
    assert abs(float(g.mean()) - 0.5772157) < 0.015
    keys = random.element_keys(1, torch.arange(4), random.PRIOR)
    prior = sample_prior_per_key(keys, 64, 64, 4)
    assert prior.shape == (4, 64, 64, 4)
    np.testing.assert_array_equal(prior.sum(-1).numpy(), 1.0)
    # 65536 pixels: a class's share has binomial std 0.0017 about 0.25
    np.testing.assert_allclose(prior.mean((0, 1, 2)).numpy(), 0.25, atol=0.015)
    again = sample_prior_per_key(random.element_keys(1, torch.arange(4), random.PRIOR), 64, 64, 4)
    torch.testing.assert_close(prior, again, rtol=0, atol=0)

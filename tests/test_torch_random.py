"""The port's per-element noise streams (`ccdm_tpu_torch/diffusion/random.py`):
Threefry-2x32-20 against its published test vectors and JAX's own
implementation, the streams' independence of batch position and size, and
their distributions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from ccdm_tpu_torch.diffusion import random
from ccdm_tpu_torch.diffusion.sampling import SamplerConfig, ancestral_sampler, sample_prior_per_key
from ccdm_tpu_torch.models.builder import build_model
from torch_port_util import TINY_PARAMS


def _t(v):
    return torch.tensor(v, dtype=torch.int64)


# Random123's known-answer vectors for threefry2x32_20 (key, counter, output),
# the same JAX's random tests hold its generator to
@pytest.mark.parametrize("key,ctr,out", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_published_vectors(key, ctr, out):
    y = random.threefry2x32((_t(key[0]), _t(key[1])), _t(ctr[0]), _t(ctr[1]))
    assert (int(y[0]), int(y[1])) == out


def test_threefry_equals_jax():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    ctr = rng.integers(0, 2 ** 32, (2, 257), dtype=np.uint64).astype(np.uint32)
    ref = jax_prng.threefry_2x32(jnp.asarray(key), jnp.asarray(ctr))
    ours = random.threefry2x32((int(key[0]), int(key[1])),
                               torch.from_numpy(ctr[0].astype(np.int64)),
                               torch.from_numpy(ctr[1].astype(np.int64)))
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), o.numpy())


def test_draws_do_not_depend_on_batch_position_or_size():
    """Element 7's draws are the same alone, at the end of a batch of 8 and
    in the middle of a shuffled batch of 12; other elements' differ."""
    ids = torch.arange(12)
    alone = random.element_keys(5, torch.tensor([7]), random.CHAIN)
    small = random.element_keys(5, ids[:8], random.CHAIN)
    shuffled = ids[torch.randperm(12, generator=torch.Generator().manual_seed(0))]
    big = random.element_keys(5, shuffled, random.CHAIN)
    pos = int((shuffled == 7).nonzero())
    for step in (0, 3):
        g = random.gumbel(alone, step, (6, 5, 2))
        torch.testing.assert_close(random.gumbel(small, step, (6, 5, 2))[7], g[0], rtol=0, atol=0)
        torch.testing.assert_close(random.gumbel(big, step, (6, 5, 2))[pos], g[0], rtol=0, atol=0)
        u = random.uniform(small, step, (6, 5))
        assert not torch.equal(u[6], u[7])
    # steps, streams and seeds give other words
    words = random.bits(alone, 0, 64)
    assert not torch.equal(words, random.bits(alone, 1, 64))
    assert not torch.equal(words, random.bits(
        random.element_keys(5, torch.tensor([7]), random.PRIOR), 0, 64))
    assert not torch.equal(words, random.bits(
        random.element_keys(6, torch.tensor([7]), random.CHAIN), 0, 64))
    # an odd count is the prefix of the next even one
    torch.testing.assert_close(random.bits(small, 2, 9), random.bits(small, 2, 10)[:, :9])


def test_distributions():
    """Uniforms on [0, 1) with 24-bit resolution, Gumbel moments, and
    unbiased categorical draws (chi-square)."""
    keys = random.element_keys(0, torch.arange(16), random.CHAIN)
    u = random.uniform(keys, 0, (100_000,)).reshape(-1)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert bool(((u * 2 ** 24) == torch.round(u * 2 ** 24)).all())
    hist = torch.histc(u, bins=20, min=0.0, max=1.0).numpy()
    expected = u.numel() / 20
    assert ((hist - expected) ** 2 / expected).sum() < 45.3  # chi-square, 19 dof, p = 1e-3
    g = random.gumbel(keys, 1, (50_000,)).double()
    assert abs(float(g.mean()) - 0.5772) < 0.01  # Euler-Mascheroni
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
    draws = random.randint(keys, 2, (20_000,), 20).reshape(-1)
    assert int(draws.min()) == 0 and int(draws.max()) == 19
    counts = torch.bincount(draws, minlength=20).double().numpy()
    expected = draws.numel() / 20
    assert ((counts - expected) ** 2 / expected).sum() < 43.8  # 19 dof, p = 1e-3
    prior = sample_prior_per_key(keys[:2], 8, 8, 3)
    assert prior.shape == (2, 8, 8, 3) and bool((prior.sum(-1) == 1).all())


def test_element_keys_validate_the_seed():
    with pytest.raises(ValueError, match="seed"):
        random.element_keys(-1, torch.arange(2), random.PRIOR)
    keys = random.element_keys(2 ** 64 - 1, torch.arange(3), random.PRIOR)
    assert keys.shape == (3, 2) and int(keys.max()) < 2 ** 32


@pytest.mark.parametrize("state", ["onehot", "index"])
def test_sampler_trajectory_does_not_depend_on_the_batch(state):
    """A sampler run of one element equals its row in a batch of three,
    in both states, with the streams keyed on the elements' ids."""
    c = 3
    model = build_model(dict(TINY_PARAMS, unet_openai=dict(TINY_PARAMS["unet_openai"],
                                                           base_channels=8, image_size=8)),
                        c, 1, 8, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():  # zero-initialised heads would make every map uniform
        for p in model.unet.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    cond = torch.randn(3, 8, 8, 1, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([4, 9, 2])
    prior = sample_prior_per_key(random.element_keys(1, ids, random.PRIOR), 8, 8, c)
    cfg = SamplerConfig(num_steps=3, step_T_sample="confidence", state=state)

    def run(rows):
        with torch.inference_mode():
            return ancestral_sampler(model.diffusion, model.denoise_fn(model.unet, cond[rows]),
                                     prior[rows], cfg, element_keys=random.element_keys(
                                         1, ids[rows], random.CHAIN))

    batch = run([0, 1, 2])
    torch.testing.assert_close(run([1]), batch[1:2], rtol=1e-6, atol=1e-7)
    assert not torch.allclose(batch[0], batch[1])

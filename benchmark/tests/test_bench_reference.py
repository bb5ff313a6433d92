"""The plain reference against the program's CPU path at a tiny width: the
same weights and inputs give the same numbers where the program computes
in fp32 (its bf16 torso is what the cells' limits measure)."""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.reference import diffusion, dino, noise
from benchmark.reference.sampler import run_chains
from benchmark.reference.unet import UNet
from benchmark.tests import tiny


def _model(cfg, dtype="float32"):
    from ccdm_tpu_torch.models.builder import build_model

    params = dict(cfg, compute_dtype=dtype, step_T_sample="confidence")
    h = cfg["image_shape"][0]
    return build_model(params, num_classes=cfg["num_classes"],
                       image_channels=cfg["image_channels"], image_size=h, device="cpu")


def test_noise_and_posterior_equal_the_programs():
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.diffusion.categorical import CategoricalDiffusion, theta_post_prob

    seed, ids = 2 ** 31 + 12345, torch.arange(6)
    for stream in (noise.PRIOR, noise.CHAIN):
        assert torch.equal(random.element_keys(seed, ids, stream), noise.keys(seed, ids, stream))
    k = noise.keys(seed, ids, noise.CHAIN)
    assert torch.equal(random.randint(k, 0, (4, 4), 20), noise.integers(k, 0, (4, 4), 20))
    assert torch.equal(random.uniform(k, 9, (4, 4)).double(), noise.uniforms(k, 9, (4, 4)))
    assert torch.allclose(random.gumbel(k, 9, (4, 4, 2)).double(), noise.gumbels(k, 9, (4, 4, 2)),
                          atol=1e-6)
    d, r = CategoricalDiffusion.create("cosine", 250, 3), diffusion.Diffusion(250, 3, "cpu")
    x = torch.nn.functional.one_hot(torch.randint(0, 3, (2, 4, 4)), 3).float()
    p0 = torch.softmax(torch.randn(2, 4, 4, 3), -1)
    for t in (250, 100, 3, 1):
        assert torch.allclose(theta_post_prob(d, x, p0, torch.full((2,), t)).double(),
                              r.posterior(x, p0, t), atol=1e-4)


def test_unet_and_chain_equal_the_programs_fp32_path():
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler

    _, cfg, _ = tiny.cut("lidc_sample_bf16")
    model = _model(cfg)
    w = weights.draw(model.unet, 5, "cpu")
    weights.load(model.unet, w)
    ref = UNet(cfg, w)
    x = torch.nn.functional.one_hot(torch.randint(0, 2, (3, 32, 32)), 2).float()
    img, t = torch.randn(3, 32, 32, 1), torch.tensor([20, 7, 1])
    with torch.no_grad():
        assert torch.allclose(model.unet(x, img, t)["diffusion_out"], ref(x, img, t), atol=1e-5)
        got = make_prob_sampler(model, 2)(model.unet, img[:2], 77).reshape(4, 32, 32, 2)
        want = run_chains(ref, diffusion.Diffusion(20, 2, "cpu"), 77, torch.arange(4),
                          img[:2].repeat_interleave(2, 0), None, vote="confidence")
    assert (got.double() - want).abs().max() < 1e-3


def test_dino_keys_and_feature_concat_equal_the_programs():
    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder

    _, cfg, _ = tiny.cut("cs_eval_sample")
    fce = cfg["feature_cond_encoder"]
    enc = DinoFeatureEncoder(fce)
    vit = enc.init(device="cpu")
    w = weights.draw(vit, 3, "cpu")
    weights.load(vit, w)
    img = torch.randn(2, 64, 128, 3)
    with torch.no_grad():
        feats = enc(vit, img)
        ref = dino.key_features(w, img, heads=6, patch=8, stride=8, source_layer=2)
        assert torch.allclose(feats, ref, atol=1e-4)
        model = _model(cfg)
        uw = weights.draw(model.unet, 4, "cpu")
        weights.load(model.unet, uw)
        x = torch.nn.functional.one_hot(torch.randint(0, 20, (2, 64, 128)), 20).float()
        t = torch.tensor([3, 11])
        assert torch.allclose(model.unet(x, img, t, feats)["diffusion_out"],
                              UNet(cfg, uw)(x, img, t, ref), atol=1e-5)

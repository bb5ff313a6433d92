"""The graphed sampler's step body on the CPU (`diffusion/sampling.py`).

On the card `make_prob_sampler` replays CUDA graphs of `StepBody`
(`GraphedSampler`); what the graphs replay is the body, so it is held here:

- the body over static buffers, driven as the graphs drive it (the state,
  keys and conditioning copied in, k reset, the steps of `step_plan`), and
  `ancestral_sampler`, against the loop as it was written before the body
  (host timesteps, integer steps), bit for bit, over both states, R = 1
  and 3, K == T, K < T and K == 1 < T, "majority" and "confidence";
- the body fed the JAX sampler's own noise against
  `ccdm_tpu.diffusion.sampling.ancestral_sampler`;
- the host's side: the cache key, the full/reuse order, which calls take
  the eager loop, the int8 state made before a capture, the launch counts
  a capture takes back out (K3 among them).

The graphs themselves run only on the card: `tests/test_torch_kernels_gpu.py`
and `chip_smoke.py` phase 29.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.diffusion import sampling as jsamp
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu_torch.diffusion import random
from ccdm_tpu_torch.diffusion import sampling as tsamp
from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler, sampler_route
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.ops import flash_attention as fa
from ccdm_tpu_torch.ops import graphs
from ccdm_tpu_torch.ops import group_norm as gn
from ccdm_tpu_torch.ops import quant
from torch_port_util import TINY_PARAMS, load_port_weights, unzero

torch.set_num_threads(2)

B, H, W, T = 2, 16, 16, 6


def _model(c: int, **params):
    model = build_model(dict(TINY_PARAMS, time_steps=T, **params), num_classes=c,
                        image_channels=1, image_size=32, device="cpu",
                        generator=torch.Generator().manual_seed(c))
    gen = torch.Generator().manual_seed(100 + c)
    with torch.no_grad():  # the zero-initialised leaves redrawn: a non-uniform softmax
        for p in model.unet.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


@pytest.fixture(scope="module")
def models():
    return {2: _model(2), 9: _model(9)}


def _inputs(c: int, seed: int, batch: int = B):
    gen = torch.Generator().manual_seed(seed)
    cond = torch.randn(batch, H, W, 1, generator=gen)
    keys = random.element_keys(seed, torch.arange(batch), random.CHAIN)
    xt = tsamp.sample_prior_per_key(random.element_keys(seed, torch.arange(batch),
                                                        random.PRIOR), H, W, c)
    return cond, keys, xt


def _reference_loop(model, net, cond, xt, keys, cfg):
    """The reverse loop as written before the step body: the timestep a
    host number, the draw's step a Python int, the state rebound."""
    d = model.diffusion
    t_grid = tsamp.subsampled_t_values(d.time_steps, cfg.num_steps)
    rs = tsamp.ReverseStep(d, tsamp._resolve_state(cfg, xt.shape[-1]), cfg.step_T_sample,
                           element_keys=keys)
    fn = model.denoise_fn(net, cond)
    full_fn, reuse_fn = model.denoise_fns_cached(net, cond)
    x, skips = rs.initial(xt), None
    for step, t_scalar in enumerate(t_grid.tolist()):
        t = torch.full((xt.shape[0],), t_scalar, dtype=torch.int32)
        xin = rs.unet_input(x)
        if cfg.encoder_reuse == 1:
            p0 = fn(xin, t)
        elif step % cfg.encoder_reuse == 0:
            p0, skips = full_fn(xin, t)
        else:
            p0 = reuse_fn(xin, t, skips)
        probs = rs.posterior(x, p0, t)
        if t_scalar > 1:
            x = rs.draw(step, probs)
    return rs.finish(x, probs, drew=int(t_grid[-1]) > 1)


@pytest.mark.parametrize("state,c,reuse,k,mode", [
    ("onehot", 2, 1, T, "confidence"),   # K == T
    ("onehot", 2, 1, 3, "majority"),     # K < T
    ("onehot", 2, 1, 1, "confidence"),   # K == 1 < T: the single step draws
    ("onehot", 2, 3, T, "majority"),
    ("onehot", 2, 3, 4, "confidence"),   # the last step (3 % 3 == 0) a full call
    ("onehot", 2, 3, 1, "majority"),
    ("index", 9, 1, T, "majority"),
    ("index", 9, 1, 4, "confidence"),
    ("index", 9, 1, 1, "majority"),
    ("index", 9, 3, T, "confidence"),    # the last step (5 % 3 == 2) a replay
    ("index", 9, 3, 5, "majority"),
    ("index", 9, 3, 1, "confidence"),
])
def test_step_body_replays_the_eager_loop_bit_for_bit(models, state, c, reuse, k, mode):
    model = models[c]
    net = model.unet
    cfg = tsamp.SamplerConfig(num_steps=k, step_T_sample=mode, encoder_reuse=reuse,
                              state=state)
    t_grid = tsamp.subsampled_t_values(T, k)
    with torch.inference_mode():
        refs, calls = [], []
        for seed in (1, 2):  # two calls through one set of static buffers
            cond, keys, xt = _inputs(c, seed)
            refs.append(_reference_loop(model, net, cond, xt, keys, cfg))
            calls.append((cond, keys, xt))
        # ancestral_sampler: the body called K times
        cond, keys, xt = calls[0]
        pair = model.denoise_fns_cached(net, cond) if reuse > 1 else None
        eager = tsamp.ancestral_sampler(model.diffusion, model.denoise_fn(net, cond), xt, cfg,
                                        element_keys=keys, denoise_pair=pair)
        torch.testing.assert_close(eager, refs[0], rtol=0, atol=0)

        # the graphs' buffers and order, eagerly: one entry, two calls
        def make_denoise(static):
            return (model.denoise_fn(net, static["cond"]),
                    model.denoise_fns_cached(net, static["cond"]) if reuse > 1 else None)

        entry = tsamp._Captured(model.diffusion, cfg, state, t_grid, xt, keys,
                                {"cond": cond}, make_denoise)
        assert entry.plan == tsamp.step_plan(k, reuse)
        for (cond, keys, xt), ref in zip(calls, refs):
            xt_before = xt.clone()
            entry.load(xt, keys, {"cond": cond})
            outs = [entry.body(full, last) for full, last in entry.plan]
            assert all(o is None for o in outs[:-1])
            torch.testing.assert_close(outs[-1], ref, rtol=0, atol=0)
            assert int(entry.body.k) == k
            torch.testing.assert_close(xt, xt_before, rtol=0, atol=0)  # the prior is read only
    if mode == "majority" or k == 1:
        assert set(torch.unique(refs[0]).tolist()) <= {0.0, 1.0}
    else:
        assert (refs[0] - 1.0 / c).abs().max() > 1e-2  # not a uniform map
    assert not torch.equal(refs[0], refs[1])


JC, JK = 8, 3


@pytest.fixture(scope="module")
def jax_models():
    params = dict(TINY_PARAMS, time_steps=40)
    jmodel = jax_build_model(params, num_classes=JC, image_channels=1, image_size=32)
    jparams = unzero(jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0), (H, W, 1)))
    tmodel = build_model(params, num_classes=JC, image_channels=1, image_size=32, device="cpu")
    load_port_weights(tmodel.unet, jparams)
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    prior = np.eye(JC, dtype=np.float32)[rng.integers(0, JC, (B, H, W))]
    return jmodel, jparams, tmodel, cond, prior


@pytest.mark.parametrize("state,reuse", [("onehot", 1), ("index", 3)])
def test_step_body_matches_jax_under_injected_noise(jax_models, state, reuse):
    """The body, reading the JAX sampler's noise as `noise[k]` with k a
    0-d tensor, against `ccdm_tpu`'s `ancestral_sampler` on the same
    weights: maps >= 99.9%, probabilities 1e-4 where they agree."""
    jmodel, jparams, tmodel, cond, prior = jax_models
    cfg = dict(num_steps=JK, step_T_sample="confidence", encoder_reuse=reuse, state=state)
    key = jax.random.PRNGKey(5)
    jpair = jmodel.denoise_fns_cached(jparams, jnp.asarray(cond)) if reuse > 1 else None
    ref = np.asarray(jsamp.ancestral_sampler(
        jmodel.diffusion, jmodel.denoise_fn(jparams, jnp.asarray(cond)), jnp.asarray(prior),
        key, jsamp.SamplerConfig(**cfg), denoise_pair=jpair))
    shape = (B, H, W) if state == "index" else (B, H, W, JC)
    draw = jax.random.uniform if state == "index" else jax.random.gumbel
    noise = torch.from_numpy(np.stack([np.asarray(draw(jax.random.fold_in(key, s), shape,
                                                       jnp.float32)) for s in range(JK)]))
    tcond = torch.from_numpy(cond)
    tcfg = tsamp.SamplerConfig(**cfg)
    with torch.inference_mode():
        rs = tsamp.ReverseStep(tmodel.diffusion, state, "confidence",
                               **{"uniforms" if state == "index" else "gumbel": noise})
        pair = tmodel.denoise_fns_cached(tmodel.unet, tcond) if reuse > 1 else None
        body = tsamp.StepBody(
            rs, tsamp._Denoiser(tmodel.denoise_fn(tmodel.unet, tcond), tcfg, pair),
            tsamp.subsampled_t_values(40, JK), rs.initial(torch.from_numpy(prior)).clone())
        ours = [body(full, last) for full, last in tsamp.step_plan(JK, reuse)][-1].numpy()
    assert ours.shape == ref.shape == (B, H, W, JC)
    agree = ours.argmax(-1) == ref.argmax(-1)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(ours[agree], ref[agree], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)


def test_graph_cache_key_follows_shapes_and_weight_versions(models):
    model = models[2]
    net = model.unet
    sampler = tsamp.GraphedSampler(model.diffusion, tsamp.SamplerConfig(3))
    cond, keys, xt = _inputs(2, 1)
    key = sampler.key(net, xt, keys, {"cond": cond})
    assert sampler.key(net, xt.clone(), keys.clone(), {"cond": cond.clone()}) == key
    cond1, keys1, xt1 = _inputs(2, 1, batch=1)  # a short last batch: a second key
    assert sampler.key(net, xt1, keys1, {"cond": cond1}) != key
    assert sampler.key(net, xt, keys, {"cond": cond.double()}) != key
    assert sampler.key(net, xt, keys, {"cond": cond, "fc": cond}) != key
    weight = next(net.parameters())
    with torch.no_grad():
        weight.mul_(1.0)  # the same values, written in place: a new version
    moved = sampler.key(net, xt, keys, {"cond": cond})
    assert moved != key and moved[:2] == key[:2]  # the same shapes and storage

    # a key whose weights were written since is dropped; past max_keys, the oldest
    def make_denoise(static):
        return model.denoise_fn(net, static["cond"]), None

    sampler._add(key, xt, keys, {"cond": cond}, make_denoise)
    sampler._add(moved, xt, keys, {"cond": cond}, make_denoise)
    assert list(sampler._cache) == [moved]
    short = sampler.key(net, xt1, keys1, {"cond": cond1})
    sampler._add(short, xt1, keys1, {"cond": cond1}, make_denoise)
    other = (short[0] + ("other",), *short[1:])
    sampler._add(other, xt1, keys1, {"cond": cond1}, make_denoise)
    assert list(sampler._cache) == [moved, short, other]
    sampler._add(other[:1] + (("x",), ("y",), ()), xt1, keys1, {"cond": cond1}, make_denoise)
    assert list(sampler._cache)[0] == short  # the oldest went

    # int8: the codes are buffers, derived before the key; a weight written
    # in place moves the key and the codes follow it
    q = _model(2, quantized_inference=True)
    quant.prepare_capture(q.unet, torch.device("cpu"))
    qkey = sampler.key(q.unet, xt, keys, {"cond": cond})
    quant.prepare_capture(q.unet, torch.device("cpu"))
    assert sampler.key(q.unet, xt, keys, {"cond": cond}) == qkey
    site = quant.quant_sites(q.unet)[0][1]
    codes = site.w_q
    with torch.no_grad():
        site.weight.mul_(-1.0)
    quant.prepare_capture(q.unet, torch.device("cpu"))
    qmoved = sampler.key(q.unet, xt, keys, {"cond": cond})
    assert qmoved[1] == qkey[1] and qmoved[2] != qkey[2] and qmoved[3] != qkey[3]
    torch.testing.assert_close(site.w_q, -codes, rtol=0, atol=0)
    # the codes were made anew: the old key is stale by its weights' versions
    sampler._add(qkey, xt, keys, {"cond": cond}, make_denoise)
    sampler._add(qmoved, xt, keys, {"cond": cond}, make_denoise)
    assert qkey not in sampler._cache and qmoved in sampler._cache


@pytest.mark.parametrize("reuse", [1, 2, 3])
def test_replay_order_is_the_denoisers(models, reuse):
    """`step_plan`, the order the graphs are enqueued in, is the order in
    which the eager loop calls the full UNet and the replays."""
    model = models[2]
    net = model.unet
    cond, keys, xt = _inputs(2, 3)
    for k in range(1, T + 1):
        calls = []
        full_fn, reuse_fn = model.denoise_fns_cached(net, cond)
        fn = model.denoise_fn(net, cond)

        def full(x, t):
            calls.append(True)
            return full_fn(x, t)

        def replay(x, t, skips):
            calls.append(False)
            return reuse_fn(x, t, skips)

        def plain(x, t):
            calls.append(True)
            return fn(x, t)

        with torch.inference_mode():
            tsamp.ancestral_sampler(model.diffusion, plain, xt,
                                    tsamp.SamplerConfig(k, encoder_reuse=reuse),
                                    element_keys=keys,
                                    denoise_pair=(full, replay) if reuse > 1 else None)
        plan = tsamp.step_plan(k, reuse)
        assert [full for full, _ in plan] == calls
        assert [last for _, last in plan] == [False] * (k - 1) + [True]


def test_eager_routes(models, caplog):
    """Only a call on a CUDA device, with the streams' noise, of a whole net
    whose sites do not record, replays graphs; every other call takes the
    eager loop, and on the CPU `make_prob_sampler` with graphs is the eager
    sampler bit for bit."""
    model = models[2]
    net, cuda, cpu = model.unet, torch.device("cuda"), torch.device("cpu")
    assert sampler_route(net, cuda, graphs=True, injected=False) == "graphs"
    assert sampler_route(net, cuda, graphs=False, injected=False) == "asked"
    assert sampler_route(net, cpu, graphs=True, injected=False) == "cpu"
    assert sampler_route(net, cuda, graphs=True, injected=True) == "injected noise"
    q = _model(2, quantized_inference=True)
    with quant.recording_absmax(q.unet):
        assert sampler_route(q.unet, cuda, graphs=True, injected=False) == "calibration"
        with pytest.raises(RuntimeError, match="recording"):
            quant.prepare_capture(q.unet, cpu)
    assert sampler_route(q.unet, cuda, graphs=True, injected=False) == "graphs"
    # a layer split over a model axis, as parallel.tensor.shard_modules marks it
    split = _model(2)
    conv = next(m for m in split.unet.modules() if isinstance(m, torch.nn.Conv2d))
    conv.tp_group = None
    assert sampler_route(split.unet, cuda, graphs=True, injected=False) == "model axis"

    images = _inputs(2, 4)[0]
    run = make_prob_sampler(model, num_samples=2, num_steps=3)
    out = run(net, images, 7)
    assert run.graphed is not None and run.graphed.captures == run.graphed.replays == 0
    eager = make_prob_sampler(model, num_samples=2, num_steps=3, graphs=False)
    assert eager.graphed is None
    torch.testing.assert_close(out, eager(net, images, 7), rtol=0, atol=0)


def test_prepare_capture_makes_the_int8_state_first(models, monkeypatch):
    """The device state a capture must not create: every site's codes, the
    fixed activation scale's scalar and the divisor."""
    q = _model(2, quantized_inference=True)
    sites = quant.quant_sites(q.unet)
    assert sites and all(m.w_q is None for _, m in sites)
    quant._fixed_scale.cache_clear()
    monkeypatch.setattr(quant, "STATIC_ACTIVATION_SCALE", 0.02)
    quant.prepare_capture(q.unet, torch.device("cpu"))
    assert all(m.w_q is not None and m.s_w is not None for _, m in sites)
    assert quant._fixed_scale.cache_info().currsize == 1
    assert torch.device("cpu") in quant._DIVISORS
    quant.prepare_capture(models[2].unet, torch.device("cpu"))  # no sites: nothing to make


def test_captured_launches_come_out_and_replays_add_them(monkeypatch):
    """A capture's launches (K1, K2 and its backward, K3 and their paths)
    are taken back out of the wrappers' counts and added at each replay."""
    for module, names in graphs.COUNTED:
        for name in names:
            value = getattr(module, name)
            monkeypatch.setattr(module, name, dict(value) if isinstance(value, dict) else value)
    assert {m for m, _ in graphs.COUNTED} == {gn, fa, quant}
    start = graphs.launch_counts()
    before = graphs.launch_counts()
    gn.launches += 66
    gn.path_launches["M"] += 15
    fa.launches += 11
    quant.launches += 81
    quant.path_launches["ring"] += 70
    delta = graphs.captured_launches(before)
    assert graphs.launch_counts() == start
    assert delta[gn, "launches"] == 66 and delta[fa, "launches"] == 11
    assert delta[quant, "launches"] == 81 and delta[quant, "path_launches"]["ring"] == 70
    for _ in range(3):
        graphs.count_launches(delta)
    assert quant.launches == start[quant, "launches"] + 3 * 81
    assert gn.path_launches["M"] == start[gn, "path_launches"]["M"] + 45
    from ccdm_tpu_torch.train import step

    assert step.capture_graph is graphs.capture_graph and step.WARMUP_STEPS == graphs.WARMUP_STEPS

"""Port parity: int8 quantized inference (`ccdm_tpu_torch/ops/quant.py` and the
`quantized_inference` UNet) against the JAX package (`ccdm_tpu/ops/quant.py`),
on the CPU, with inputs made from a numpy seed.

On the CPU the port's `quant_conv` runs its plain version (the same codes, an
exact integer convolution, the same fp32 epilogue); the card's kernel is held
to that plain version bit for bit by `tests/test_torch_kernels_gpu.py` and
`chip_smoke.py`.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ccdm_tpu.diffusion.sampling import sample_prior
from ccdm_tpu.eval.lidc_uncertainty import make_prob_sampler as jax_make_prob_sampler
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu.ops import quant as jq
from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS, FLAGSHIP_PARAMS
from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.convert import flax_params_to_state_dict
from ccdm_tpu_torch.ops import quant as tq
from torch_port_util import TINY_PARAMS, load_port_weights, unzero

torch.set_num_threads(2)

B, H, W, C = 2, 32, 32, 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each value (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)


def _port_site_names(params):
    """Flax module path -> the port's module name, for every conv of `params`,
    through the converter itself: each leaf is replaced by its number, a
    0-d value the converter carries to its torch name unchanged."""
    paths = []

    def number(tree, prefix=()):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = number(value, prefix + (key,))
            else:
                out[key] = np.float32(len(paths))
                paths.append(prefix + (key,))
        return out

    converted = flax_params_to_state_dict(number(params))
    return {paths[int(v)][:-1]: name.rsplit(".", 1)[0] for name, v in converted.items()
            if paths[int(v)][-1] == "kernel"}


def _jax_stats_to_port(stats, params):
    """A JAX `quant_stats`/`quant_scales` tree -> {port module name: value}."""
    names = _port_site_names(params)
    flat = {}

    def walk(tree, prefix=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
            else:
                flat[names[prefix]] = np.asarray(value, np.float32)

    walk(stats)
    return flat


@contextlib.contextmanager
def _jax_int8_convs(net, jparams, table, static):
    """The port's float parts with JAX's int8 convolutions: every site of
    JAX's `quant_stats` `table` (port name -> calibrated absmax), found in
    `net` by the converter's names (so a site the port left in float is
    replaced too), returns JAX's eager `quantized_conv` on the port's own
    input, with JAX's weights and, if `static`, the scale `QuantConv` derives
    from the table; eager, op by op, each rounding on its own as in the
    port's epilogue (under jit XLA may fuse the scale's multiply and the
    bias add). Yields {name: [calls, calls whose port output equalled JAX's]}."""
    weights = {}
    for path, name in _port_site_names(jparams).items():
        if name not in table:
            continue
        node = jparams
        for key in path:
            node = node[key]
        weights[name] = (jnp.asarray(node["kernel"]), jnp.asarray(node["bias"]))
    seen = {name: [0, 0] for name in weights}

    def replace(mod, args, out, name):
        pad = ((1, 1), (1, 1)) if mod.kernel_size[0] == 3 else ((0, 0), (0, 0))
        scale = jnp.maximum(jnp.float32(table[name]), 1e-8) / 127.0 if static else None
        ref = jq.quantized_conv(jnp.asarray(args[0].permute(0, 2, 3, 1).numpy()),
                                *weights[name], mod.stride, pad, act_scale=scale)
        # in the port's own memory layout, which the float parts' sums follow
        ref = torch.empty_like(out).copy_(torch.from_numpy(np.array(ref)).permute(0, 3, 1, 2))
        seen[name][0] += 1
        seen[name][1] += int(torch.equal(out, ref))
        return ref

    hooks = [net.get_submodule(name).register_forward_hook(
        lambda mod, args, out, n=name: replace(mod, args, out, n)) for name in weights]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


# ---- the conv ----------------------------------------------------------------

def test_quantize_symmetric_codes_equal():
    rng = np.random.default_rng(0)
    scale = np.float32(0.037)
    # ties at k + 1/2 (half to even), values past +-127, and plain draws
    x = np.concatenate([(np.arange(-130, 130) + 0.5).astype(np.float32) * scale,
                        rng.standard_normal(5000).astype(np.float32) * 3]).reshape(-1, 10)
    ref = np.asarray(jq.quantize_symmetric(jnp.asarray(x), jnp.float32(scale)))
    ours = tq.quantize_symmetric(torch.from_numpy(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.min() == -127 and ours.max() == 127
    # per-output-channel weight codes and scales
    w = (rng.standard_normal((3, 3, 5, 7)) * 0.2).astype(np.float32)  # HWIO
    s_w = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(w)), axis=(0, 1, 2)) / 127.0, 1e-12)
    w_q, ours_s = tq.weight_codes(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(ours_s.numpy(), np.asarray(s_w))
    np.testing.assert_array_equal(
        tq.unpack_codes(w_q, 5, 3).permute(2, 3, 1, 0).numpy(),
        np.asarray(jq.quantize_symmetric(jnp.asarray(w), s_w)))
    assert w_q.shape == (7, 9 * 32) and not w_q.reshape(7, 9, 32)[..., 5:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("cin,cout,k,stride", [
    (8, 16, 3, 1), (8, 16, 3, 2), (12, 16, 1, 1),
    (3, 8, 3, 1),    # K = 27: the flagship in_conv's ragged depth
])
def test_quantized_conv_matches_jax(dtype, static, cin, cout, k, stride):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(cin * 100 + k * 10 + stride)
    x = (rng.standard_normal((2, 9, 11, cin)) * 2).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    pad = ((1, 1), (1, 1)) if k == 3 else ((0, 0), (0, 0))
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    absmax = np.float32(np.abs(x).max() * 0.8)  # a calibrated table clips the largest inputs
    if static:
        # as QuantConv runs it: the scale from the absmax, a constant under jit
        j_sx = jnp.maximum(jnp.float32(absmax), 1e-8) / 127.0
        t_sx = tq.static_act_scale(torch.tensor(absmax))
    else:
        j_sx = jnp.maximum(jnp.max(jnp.abs(jx.astype(jnp.float32))) / 127.0, 1e-8)
        t_sx = tq.dynamic_act_scale(tx)
    assert float(t_sx) == float(j_sx)

    # the codes and the int32 sums; the scale as QuantConv's jitted call has
    # it: computed in the graph (dynamic) or a constant (static)
    if static:
        j_q = np.asarray(jax.jit(lambda v: jq.quantize_symmetric(v, j_sx))(jx))
    else:
        j_q = np.asarray(jax.jit(lambda v: jq.quantize_symmetric(v, jnp.maximum(
            jnp.max(jnp.abs(v.astype(jnp.float32))) / 127.0, 1e-8)))(jx))
    t_q = tq.quantize_symmetric(tx, t_sx).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(t_q, j_q)
    w_q, s_w = tq.weight_codes(tw)
    j_wq = jq.quantize_symmetric(jnp.asarray(w), jnp.maximum(
        jnp.max(jnp.abs(jnp.asarray(w)), axis=(0, 1, 2)) / 127.0, 1e-12))
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    j_acc = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(j_q), j_wq, (stride, stride), pad, dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    t_acc = torch.nn.functional.conv2d(
        torch.from_numpy(t_q).permute(0, 3, 1, 2).double(),
        tq.unpack_codes(w_q, cin, k).double(), stride=stride, padding=(k - 1) // 2)
    np.testing.assert_array_equal(t_acc.permute(0, 2, 3, 1).numpy().astype(np.int64),
                                  j_acc.astype(np.int64))

    # the outputs: QuantConv's own call, jitted, against the port's wrapper
    variables = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    if static:
        variables["quant_scales"] = {"act_absmax": jnp.float32(absmax)}
    conv = jq.QuantConv(cout, (k, k), strides=(stride, stride), padding=pad)
    ref = np.asarray(jax.jit(lambda v: conv.apply(variables, v))(jx).astype(jnp.float32))
    ours = tq.quant_conv(tx, w_q, s_w, torch.from_numpy(b), t_sx, k, stride, (k - 1) // 2)
    assert ours.dtype == tdt
    ours = ours.float().permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape
    if dtype == "float32":
        # the same fp32 products and sums; XLA may fuse the scale's multiply
        # and the bias add into one rounding: 1e-6 of the largest output
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    else:
        # both round the fp32 result to bf16 once; where the two fp32 values
        # straddle a rounding boundary they land one bf16 ulp apart
        assert (np.abs(ours - ref) <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_activation_scale_matches_jax(dtype, monkeypatch):
    """`STATIC_ACTIVATION_SCALE` set to the same constant in both packages:
    a `QuantConv2d` with no static scale of its own quantizes its input with
    it, as JAX's `quantized_conv` does without an `act_scale` (the codes
    equal, the outputs as the conv parity above holds them); a site's own
    static scale still wins; unset, the scale is dynamic again."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 9, 11, 8)) * 2).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    conv = tq.QuantConv2d(8, 16, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))

    def both():
        ref = jq.quantized_conv(jx, jnp.asarray(w), jnp.asarray(b))
        with torch.no_grad():
            ours = conv(tx)
        assert ours.dtype == tdt
        return np.asarray(ref.astype(jnp.float32)), ours.float().permute(0, 2, 3, 1).numpy()

    def close(ours, ref):
        if dtype == "float32":
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
        else:
            assert (np.abs(ours - ref) <= _bf16_ulp(ref)).all()

    dynamic = both()
    scale = 0.0213  # clips the largest inputs (max|x| / 127 is about 0.05)
    monkeypatch.setattr(jq, "STATIC_ACTIVATION_SCALE", scale)
    monkeypatch.setattr(tq, "STATIC_ACTIVATION_SCALE", scale)
    ref, ours = both()
    close(ours, ref)
    assert not np.allclose(ref, dynamic[0])  # the constant changed JAX's result
    j_q = np.asarray(jq.quantize_symmetric(jx, jnp.float32(scale)))
    t_q = tq.quantize_symmetric(tx, torch.tensor(scale, dtype=torch.float32))
    np.testing.assert_array_equal(t_q.permute(0, 2, 3, 1).numpy(), j_q)
    # a site's own static scale wins over the constant, in both packages
    own = np.float32(np.abs(x).max() * 0.5)
    j_own = jq.quantized_conv(jx, jnp.asarray(w), jnp.asarray(b),
                              act_scale=jnp.maximum(jnp.float32(own), 1e-8) / 127.0)
    conv.act_scale = tq.static_act_scale(torch.tensor(own))
    with torch.no_grad():
        close(conv(tx).float().permute(0, 2, 3, 1).numpy(), np.asarray(j_own.astype(jnp.float32)))
    conv.act_scale = None
    monkeypatch.setattr(jq, "STATIC_ACTIVATION_SCALE", None)
    monkeypatch.setattr(tq, "STATIC_ACTIVATION_SCALE", None)
    ref, ours = both()
    close(ours, ref)
    np.testing.assert_array_equal(ref, dynamic[0])


def test_quant_conv_wrapper_rejects_bad_inputs():
    x = torch.randn(1, 4, 5, 5)
    w_q, s_w = tq.weight_codes(torch.randn(8, 4, 3, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quant_conv(x.to("meta"), w_q, s_w, torch.zeros(8), torch.tensor(0.1), 3, 1, 1)
    # the plain version on the CPU, with the kernel's layout of the codes
    out = tq.quant_conv(x, w_q, s_w, torch.zeros(8), torch.tensor(0.1), 3, 2, 1)
    assert out.shape == (1, 8, 3, 3)


# ---- the module ----------------------------------------------------------------

def test_quant_conv2d_state_dict_is_conv2d_and_float_checkpoints_load():
    params = dict(TINY_PARAMS, compute_dtype="bfloat16")
    float_model = build_model(params, C, 1, H, device="cpu")
    int8_model = build_model(dict(params, quantized_inference="static"), C, 1, H, device="cpu")
    sites = tq.quant_sites(int8_model.unet)
    assert sites and all(m.weight.dtype == m.bias.dtype == torch.float32 for _, m in sites)
    fsd, qsd = float_model.unet.state_dict(), int8_model.unet.state_dict()
    assert list(fsd) == list(qsd)
    for name, m in sites:
        plain = float_model.unet.get_submodule(name)
        assert type(plain) is nn.Conv2d and isinstance(m, nn.Conv2d)
        assert [k for k, _ in m.named_parameters()] == [k for k, _ in plain.named_parameters()]
        assert (m.stride, m.padding, m.kernel_size) == (plain.stride, plain.padding,
                                                        plain.kernel_size)
    # a float (bf16) checkpoint loads strictly and unchanged into fp32 masters
    int8_model.unet.load_state_dict(fsd, strict=True)
    for name, m in sites:
        assert torch.equal(m.weight, float_model.unet.get_submodule(name).weight.float())
    # init_weights_ draws the same weights for both (fp32 torso: bit for bit)
    f32 = dict(params, compute_dtype="float32")
    a = build_model(f32, C, 1, H, device="cpu").unet.state_dict()
    b = build_model(dict(f32, quantized_inference=True), C, 1, H, device="cpu").unet.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_codes_follow_the_weights():
    conv = tq.QuantConv2d(4, 8, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(8, 4, 3, 3))
    first = conv.codes()[0].clone()
    assert conv.codes()[0] is conv.codes()[0]  # derived once
    conv.load_state_dict({"weight": torch.randn(8, 4, 3, 3), "bias": torch.zeros(8)})
    assert not torch.equal(conv.codes()[0], first)
    assert torch.equal(conv.codes()[0], tq.weight_codes(conv.weight)[0])


@pytest.mark.parametrize("value,quantized", [
    (False, False), (None, False), (True, True), ("static", True), ("yes", True)])
def test_the_switch_reads_as_the_jax_builder_reads_it(value, quantized):
    params = dict(TINY_PARAMS, quantized_inference=value)
    model = build_model(params, C, 1, H, device="cpu")
    assert bool(tq.quant_sites(model.unet)) == quantized


def _count_sites(params, classes, channels, size):
    with torch.device("meta"):
        from ccdm_tpu_torch.models.unet import create_unet

        bb = params["unet_openai"]
        fce = params.get("feature_cond_encoder") or {}
        unet = create_unet(size, bb["base_channels"], classes, in_channels=classes + channels,
                           channel_mult=bb.get("channel_mult"),
                           attention_resolutions=bb["attention_resolutions"],
                           num_head_channels=bb["num_head_channels"],
                           feature_cond_block_idx=int(fce.get("target_layer", -1))
                           if fce.get("type") == "dino" else -1,
                           feature_channels=384 if fce.get("type") == "dino" else 0,
                           quantize_convs=True)
    replayed = [unet.middle_block, *unet.output_blocks, unet.out]
    convs = sum(isinstance(m, nn.Conv2d) for m in unet.modules())
    return (len(tq.quant_sites(unet)), convs,
            sum(isinstance(m, tq.QuantConv2d) for mod in replayed for m in mod.modules()))


def test_quantized_sites_of_the_flagship_and_cityscapes():
    """81 quantized sites a flagship UNet call (82 convs less the fp32 head),
    53 of them in an encoder-reuse replay (the middle and the decoder); 96 at
    Cityscapes (97 less the head), 63 in a replay."""
    assert _count_sites(FLAGSHIP_PARAMS, 2, 1, 128) == (81, 82, 53)
    assert _count_sites(CITYSCAPES_EVAL_PARAMS, 20, 3, 256) == (96, 97, 63)


# ---- the UNet and its calibration against the JAX package -----------------------

@pytest.fixture(scope="module")
def int8_pair():
    params = dict(TINY_PARAMS, quantized_inference=True)
    jmodel = jax_build_model(params, num_classes=C, image_channels=1, image_size=H)
    jparams = unzero(jax.jit(lambda key: jmodel.init(key, (H, W, 1)))(jax.random.PRNGKey(0)))
    tmodel = build_model(params, num_classes=C, image_channels=1, image_size=H, device="cpu")
    load_port_weights(tmodel.unet, jparams)  # a flax tree of QuantConvs converts as is
    rng = np.random.default_rng(0)
    xt = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))]
    cond = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    t = np.array([7, 201], np.int32)
    _, stats = jax.jit(lambda *a: jmodel.apply(jparams, *a, mutable=["quant_stats"]))(
        jnp.asarray(xt), jnp.asarray(cond), jnp.asarray(t))
    table = _jax_stats_to_port(jax.device_get(stats["quant_stats"]), jparams)
    return jmodel, jparams, tmodel, xt, cond, t, jax.device_get(stats["quant_stats"]), table


def test_calibration_absmax_matches_jax_quant_stats(int8_pair):
    """One forward's per-site input absmax (the float conv running in fp32),
    site by site through the converter's names."""
    _, _, tmodel, xt, cond, t, _, table = int8_pair
    with torch.no_grad(), tq.recording_absmax(tmodel.unet) as stats:
        tmodel.unet(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(t))
    assert set(stats) == set(table) == {n for n, _ in tq.quant_sites(tmodel.unet)}
    for name, ref in table.items():
        np.testing.assert_allclose(float(stats[name]), ref, rtol=1e-5, err_msg=name)
    assert all(m.absmax is None and not m.recording for _, m in tq.quant_sites(tmodel.unet))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_unet_matches_jax(int8_pair, static):
    """The whole forward, where codes cannot move: the port's forward with
    JAX's `quantized_conv` (JAX's weights, JAX's scale table) in place of
    every conv JAX quantizes equals the port's own forward bit for bit, each
    site called once and equal to JAX's on the port's input. A site left in
    float, a wrong scale or a wrong weight code fails it.

    Then against JAX's own jitted forward. There the float parts (GroupNorm's
    sums, attention, the fp32 head) differ from XLA's by an ulp, which moves
    an int8 code by one step wherever an activation sits at a rounding
    boundary; each moved code changes a conv output by s_x * |W| at 9
    pixels, which moves further codes downstream, so over the 34 sites two
    correct int8 forwards drift apart by about as much as int8 differs from
    float (measured: mean |dp| 3.1e-3 against JAX, 3.6e-3 against the float
    path; largest 1.7e-2). That comparison is held on the mean, mean |dp|
    <= 5e-3, and the maps agree on >= 98% of pixels: it checks that the
    ported float parts carry the int8 path, not the int8 arithmetic, which
    the first check holds exactly."""
    jmodel, jparams, tmodel, xt, cond, t, jstats, table = int8_pair
    model = tmodel.with_quant_scales({k: torch.tensor(v) for k, v in table.items()}) \
        if static else tmodel
    jm = jmodel.with_quant_scales(jstats) if static else jmodel
    args = [torch.from_numpy(a) for a in (xt, cond, t)]
    with torch.no_grad():
        ours = model.apply(tmodel.unet, *args)["diffusion_out"]
        with _jax_int8_convs(tmodel.unet, jparams, table, static) as seen:
            hybrid = model.apply(tmodel.unet, *args)["diffusion_out"]
    assert set(seen) == set(table) == {n for n, _ in tq.quant_sites(tmodel.unet)}
    assert all(calls == equal == 1 for calls, equal in seen.values()), seen
    torch.testing.assert_close(ours, hybrid, rtol=0, atol=0)
    ours = ours.numpy()

    ref = np.asarray(jax.jit(lambda a, b, c: jm.apply(jparams, a, b, c)["diffusion_out"])(
        jnp.asarray(xt), jnp.asarray(cond), jnp.asarray(t)))
    assert ours.shape == ref.shape == (B, H, W, C)
    assert np.abs(ours - ref).mean() <= 5e-3, np.abs(ours - ref).mean()
    assert (ours.argmax(-1) == ref.argmax(-1)).mean() >= 0.98
    # the int8 path is not the float path
    float_model = build_model(TINY_PARAMS, C, 1, H, device="cpu")
    float_model.unet.load_state_dict(tmodel.unet.state_dict())
    with torch.no_grad():
        fl = float_model.apply(float_model.unet, *args)["diffusion_out"].numpy()
    assert np.abs(ours - fl).mean() > 1e-3


def test_calibrate_sampler_matches_jax_under_injected_noise(int8_pair):
    """The calibration rollout (8 subsampled steps, the real posterior and
    draw) with JAX's prior and Gumbel draws injected: the same table."""
    jmodel, jparams, tmodel, _, cond, _, _, _ = int8_pair
    key = jax.random.PRNGKey(0)
    images = jnp.asarray(cond)
    ref = _jax_stats_to_port(jax.device_get(
        jq.calibrate_sampler(jmodel, jparams, images, key)), jparams)
    prior = np.asarray(sample_prior(key, B, H, W, C))
    gumbel = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(key, i), (B, H, W, C),
                                                    jnp.float32)) for i in range(8)])
    ours = tq.calibrate_sampler(tmodel, tmodel.unet, torch.from_numpy(cond),
                                prior=torch.from_numpy(prior), gumbel=torch.from_numpy(gumbel))
    assert set(ours) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(float(ours[name]), value, rtol=1e-5, err_msg=name)


def test_static_reuse_sampler_matches_jax_under_injected_noise(int8_pair):
    """`quantized_inference: static` with encoder reuse 2 (the fast eval
    config) on the same calibrated table, JAX's prior and chain noise
    injected into the port, K = 4 steps.

    Where codes cannot move: the port's sampler with JAX's `quantized_conv`
    and JAX's table at every site (`_jax_int8_convs`) equals the port's own
    sampler bit for bit (maps 100%, probabilities within 0), every site
    call equal to JAX's on the port's input; the encoder's sites run in the
    2 full calls only and the middle's and decoder's in all 4, so the
    replays run on the static scales too. The dynamic sampler differs.

    Against JAX's own sampler each forward drifts by about the int8
    quantization noise itself (test_int8_unet_matches_jax: moved codes
    compound over the sites), so a draw moves wherever the Gumbel margin is
    below that: measured 99.12% of the maps agree, probabilities within
    1.58e-2 where they agree, mean |dp| 2.2e-3. Held: maps >= 98.5%, 2e-2
    where they agree, 5e-3 on the mean."""
    from test_torch_sampler import _jax_noise

    jmodel, jparams, tmodel, _, cond, _, jstats, table = int8_pair
    s, k = 2, 4
    key = jax.random.PRNGKey(3)
    jstatic = jmodel.with_quant_scales(jstats)
    ref = np.asarray(jax_make_prob_sampler(jstatic, num_samples=s, num_steps=k, encoder_reuse=2)(
        jparams, jnp.asarray(cond), key))
    prior, gumbel = _jax_noise(key, np.arange(B))
    noise = {"prior": torch.from_numpy(prior), "gumbel": torch.from_numpy(gumbel)}
    static = tmodel.with_quant_scales({n: torch.tensor(v) for n, v in table.items()})

    def run(model):
        return make_prob_sampler(model, num_samples=s, num_steps=k, encoder_reuse=2)(
            tmodel.unet, torch.from_numpy(cond), **noise)

    ours = run(static)
    with _jax_int8_convs(tmodel.unet, jparams, table, True) as seen:
        hybrid = run(static)
    torch.testing.assert_close(ours, hybrid, rtol=0, atol=0)
    assert all(calls == equal for calls, equal in seen.values()), seen
    replayed = {n for n, _ in tq.quant_sites(tmodel.unet)
                if n.startswith(("middle_block.", "output_blocks."))}
    assert replayed and len(replayed) < len(seen)
    assert {n: calls for n, (calls, _) in seen.items()} == {
        n: k if n in replayed else k // 2 for n in seen}
    assert not torch.equal(run(tmodel), ours)  # the dynamic scales

    ours = ours.numpy()
    assert ours.shape == ref.shape == (B, s, H, W, C)
    agree = ours.argmax(-1) == ref.argmax(-1)
    assert agree.mean() >= 0.985, agree.mean()
    assert np.abs(ours - ref)[agree].max() <= 2e-2
    assert np.abs(ours - ref).mean() <= 5e-3
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)


def test_a_model_without_scales_runs_dynamic(int8_pair):
    """The scales travel with the model: after a scaled model's call on the
    net, a model without a table runs the dynamic scales again, and nothing
    stays on the net."""
    _, _, tmodel, xt, cond, t, _, table = int8_pair
    args = [torch.from_numpy(a) for a in (xt, cond, t)]
    with torch.no_grad():
        dynamic = tmodel.apply(tmodel.unet, *args)["diffusion_out"]
        scaled = tmodel.with_quant_scales({n: torch.tensor(v) * 0.5 for n, v in table.items()})
        clipped = scaled.apply(tmodel.unet, *args)["diffusion_out"]
        again = tmodel.apply(tmodel.unet, *args)["diffusion_out"]
    assert tmodel.quant_scales is None and scaled.unet is tmodel.unet
    assert not torch.equal(clipped, dynamic)
    torch.testing.assert_close(again, dynamic, rtol=0, atol=0)
    assert all(m.act_scale is None for _, m in tq.quant_sites(tmodel.unet))
    assert "act_scale" not in str(list(tmodel.unet.state_dict()))


def test_training_refuses_the_switch(tmp_path):
    from ccdm_tpu_torch.train.trainer import TrainingRun

    params = dict(TINY_PARAMS, dataset_file="ccdm_tpu.data.synthetic", batch_size=2,
                  output_path=str(tmp_path), quantized_inference="static")
    with pytest.raises(ValueError, match="inference-only"):
        TrainingRun(params, device="cpu")


# ---- the evaluators ----------------------------------------------------------------

def test_cityscapes_evaluator_calibrates_static_scales(tmp_path):
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator

    params = dict(CITYSCAPES_EVAL_PARAMS, quantized_inference="static", time_steps=3,
                  compute_dtype="float32", output_path=str(tmp_path),
                  feature_cond_encoder={"type": "none"},
                  unet_openai={"base_channels": 8, "channel_mult": [1, 2],
                               "attention_resolutions": [4], "num_head_channels": 4})
    images = np.random.default_rng(0).standard_normal((2, 16, 32, 3)).astype(np.float32)
    ev = CityscapesEvaluator(params)
    with pytest.raises(ValueError, match="calibration_images"):
        ev.build((16, 32, 3), 2, device="cpu")
    ev.build((16, 32, 3), 2, device="cpu", calibration_images=images)
    assert set(ev.model.quant_scales) == {n for n, _ in tq.quant_sites(ev.model.unet)}
    assert ev.calibration_seconds > 0
    probs = ev.predict_batch(torch.from_numpy(images), 0)
    assert probs.shape == (2, 16, 32, 20) and torch.isfinite(probs).all()


def test_the_eval_cli_and_the_sweep_pass_the_switch(tmp_path):
    """A `.json` params file (the card's machine has no PyYAML) means what the
    YAML means: `"static"` calibrates, `true` runs dynamic scales; the CLI
    and the step sweep carry it to the harness."""
    from ccdm_tpu_torch.cli import eval as cli

    base = {"dataset_file": "ccdm_tpu.data.synthetic", "dataset_val_max_size": 2,
            "batch_size": 2, "evaluations": [1, 2], "evaluation_vote_strategy": "confidence",
            "time_steps": 3, "compute_dtype": "float32", "seed": 0,
            "unet_openai": {"base_channels": 8, "channel_mult": [1, 2],
                            "attention_resolutions": [4], "num_head_channels": 4}}
    seconds = {}
    for value in ("static", True):
        out = tmp_path / str(value)
        path = tmp_path / f"{value}.json"
        path.write_text(json.dumps(dict(base, quantized_inference=value, evaluation_path=str(out))))
        res = cli.main([str(path), "--device", "cpu"])
        saved = json.loads((out / "lidc_uncertainty_full.json").read_text())
        assert saved["count"] == res["count"] == 2
        seconds[value] = res["calibration_seconds"]
    assert seconds["static"] > 0 and seconds[True] == 0
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(dict(base, quantized_inference="static",
                                    dataset_file="ccdm_tpu.data.synthetic_sampling_speed",
                                    step_sweep=[1], evaluation_path=str(tmp_path / "sweep"))))
    sweep = cli.main([str(path), "--device", "cpu"])
    assert list(sweep) == [1] and sweep[1]["calibration_seconds"] > 0

"""The UNet's memory and norm keys in the port (`unet_openai.use_checkpoint`,
`remat_attention`, `norm_fp32`) against the JAX package on the CPU.

`norm_fp32: false`: the port's forward against the Flax UNet built with
`norm_fp32=False` (fp32, 2e-5), and the JAX package's own norm giving the
same bits under both values in bf16, which is why the port has one norm.
The remat keys: the builder hands them to every block with the JAX
package's defaults, they act only in a training forward that autograd
records, and neither an exported step program nor the sampler's maps see
them. Their gradients against JAX and against the plain step are in
`test_torch_train_step.py`."""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.models.layers import GroupNorm32 as JaxGroupNorm32
from ccdm_tpu.models.unet import create_unet as jax_create_unet
from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.layers import GroupNorm32
from ccdm_tpu_torch.models.unet import TimestepBlock, create_unet
from ccdm_tpu_torch.utils.serving import export_sampler
from torch_port_util import TINY_PARAMS, TINY_UNET, load_port_weights, unzero

torch.set_num_threads(2)

B, H, W, C = 2, 32, 32, 2
KEYS_ON = {"use_checkpoint": True, "remat_attention": True}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    xt = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))]
    cond = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    return xt, cond


@pytest.fixture(scope="module")
def norm_fp32_off():
    kw = dict(image_size=TINY_UNET["image_size"], base_channels=TINY_UNET["base_channels"],
              out_channels=C, num_res_blocks=2, channel_mult=TINY_UNET["channel_mult"],
              attention_resolutions=TINY_UNET["attention_resolutions"],
              num_head_channels=TINY_UNET["num_head_channels"])
    flax_unet = jax_create_unet(**kw, dtype=jnp.float32, norm_fp32=False)
    xt, cond = _inputs()
    params = unzero(jax.jit(flax_unet.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(xt), jnp.asarray(cond),
        jnp.ones((B,), jnp.int32))["params"])
    port = load_port_weights(create_unet(**kw, dtype=torch.float32), params).eval()
    return jax.jit(flax_unet.apply), params, port, xt, cond


@pytest.mark.parametrize("t", [(7, 201), (1, 250)])
def test_forward_matches_flax_with_norm_fp32_off(norm_fp32_off, t):
    apply, params, port, xt, cond = norm_fp32_off
    t = np.array(t, dtype=np.int32)
    ref = apply({"params": params}, jnp.asarray(xt), jnp.asarray(cond),
                jnp.asarray(t))["diffusion_out"]
    with torch.no_grad():
        out = port(torch.from_numpy(xt), torch.from_numpy(cond),
                   torch.from_numpy(t))["diffusion_out"].numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=0)
    assert np.abs(out - 0.5).max() > 1e-2


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (4, 8, 8, 128)])
def test_jax_norm_gives_the_same_bf16_bits_under_both_values(shape):
    """flax's GroupNorm computes its statistics and normalise in fp32 under
    any `dtype` and casts only the result: `norm_fp32` changes no bit, so
    the port's one fp32 norm is the JAX package's under both values."""
    x = jnp.asarray(np.random.default_rng(1).standard_normal(shape) * 3 + 1, jnp.bfloat16)
    outs = []
    for full in (True, False):
        norm = JaxGroupNorm32(full_fp32=full)
        params = norm.init(jax.random.PRNGKey(0), x)
        params = jax.tree.map(
            lambda p: p + jnp.asarray(np.random.default_rng(2).standard_normal(p.shape),
                                      p.dtype) * 0.1, params)
        outs.append(np.asarray(jax.jit(norm.apply)(params, x)).view(np.uint16))
    assert outs[0].dtype == np.uint16 and outs[0].shape == shape
    np.testing.assert_array_equal(outs[0], outs[1])
    # the port's norm on the same bf16 input agrees to its last bit's rounding
    port = GroupNorm32(shape[-1])
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(params["params"]["GroupNorm_0"]["scale"])))
        port.bias.copy_(torch.from_numpy(np.array(params["params"]["GroupNorm_0"]["bias"])))
        ours = port(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                    .permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1).float().numpy()
    ref = np.asarray(jax.jit(JaxGroupNorm32(full_fp32=False).apply)(params, x), np.float32)
    np.testing.assert_allclose(ours, ref, atol=2 ** -7 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("keys,want", [({}, (False, True)), (KEYS_ON, (True, True)),
                                       ({"remat_attention": False, "norm_fp32": False},
                                        (False, False))])
def test_the_builder_reads_the_keys_with_the_jax_defaults(keys, want):
    model = build_model(dict(TINY_PARAMS, unet_openai=dict(TINY_PARAMS["unet_openai"], **keys)),
                        C, 1, device="cpu")
    blocks = [m for m in model.unet.modules() if isinstance(m, TimestepBlock)]
    assert blocks and {(b.remat_resblocks, b.remat_attention) for b in blocks} == {want}


def _recomputed_norms(net, fn):
    """GroupNorm forwards that ran inside the backward (rematerialised)."""
    inside = []
    hooks = [m.register_forward_pre_hook(
        lambda *_: inside.append(torch._C._current_graph_task_id() != -1))
        for m in net.modules() if isinstance(m, GroupNorm32)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return sum(inside), len(inside)


def test_remat_acts_only_in_a_recorded_training_forward():
    model = build_model(dict(TINY_PARAMS, unet_openai=dict(TINY_PARAMS["unet_openai"],
                                                           **KEYS_ON)), C, 1, device="cpu")
    net = model.unet
    xt, cond = (torch.from_numpy(a) for a in _inputs())
    t = torch.tensor([3, 100])

    def backward():
        net(xt, cond, t)["diffusion_out"].square().sum().backward()

    sites = sum(isinstance(m, GroupNorm32) for m in net.modules())  # 31
    net.eval()
    assert _recomputed_norms(net, backward) == (0, sites)
    net.train()
    # every ResBlock's two norms and every attention block's one, again
    assert _recomputed_norms(net, backward) == (sites - 1, 2 * sites - 1)
    with torch.no_grad():
        assert _recomputed_norms(net, lambda: net(xt, cond, t)) == (0, sites)


def test_no_remat_in_the_exported_program_or_the_sampler():
    """With both keys on and the UNet left in training mode, the exported
    step program holds no checkpoint and the sampler's maps equal those of
    the same weights with the keys off."""
    maps, blobs = [], []
    for keys in (KEYS_ON, {"remat_attention": False}):
        params = dict(TINY_PARAMS, time_steps=6,
                      unet_openai=dict(TINY_PARAMS["unet_openai"], **keys))
        model = build_model(params, C, 1, device="cpu")
        net = model.unet.train()
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in net.parameters():
                if not p.any():
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        images = torch.from_numpy(_inputs(3)[1])
        maps.append(make_prob_sampler(model, 2, 3)(net, images, key=11))
        if keys is KEYS_ON:
            blobs.append(export_sampler(model, net, (H, W, 1), num_samples=2, num_steps=3,
                                        batch_size=B))
    assert torch.equal(maps[0], maps[1])
    assert maps[0].std() > 0.01  # the un-zeroed heads make the maps depend on the torso
    with zipfile.ZipFile(io.BytesIO(blobs[0])) as z:
        step = torch.export.load(io.BytesIO(z.read("step.pt2")))
    targets = {str(n.target) for n in step.graph.nodes if n.op == "call_function"}
    assert not [t for t in targets if "checkpoint" in t], targets
    assert "ccdm.group_norm.default" in targets

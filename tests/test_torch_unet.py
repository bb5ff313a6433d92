"""Port parity: the port's UNet against the Flax UNet, through the jax-free
converter `flax_params_to_state_dict`, in fp32 on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.models.torch_convert import flax_unet_to_torch
from ccdm_tpu.models.unet import create_unet as jax_create_unet
from ccdm_tpu_torch.models.convert import flax_params_to_state_dict
from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32, timestep_embedding
from ccdm_tpu_torch.models.unet import create_unet
from torch_port_util import TINY_UNET, load_port_weights, unzero

torch.set_num_threads(2)

B, H, W, C = 2, 32, 32, 2


def _build(scale_shift, ce_head):
    kw = dict(image_size=TINY_UNET["image_size"], base_channels=TINY_UNET["base_channels"],
              out_channels=C, num_res_blocks=2, channel_mult=TINY_UNET["channel_mult"],
              attention_resolutions=TINY_UNET["attention_resolutions"],
              num_head_channels=TINY_UNET["num_head_channels"],
              use_scale_shift_norm=scale_shift, ce_head=ce_head)
    flax_unet = jax_create_unet(**kw, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    xt = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))]
    cond = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    params = flax_unet.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(xt),
                            jnp.asarray(cond), jnp.ones((B,), jnp.int32))["params"]
    params = unzero(params)
    port = load_port_weights(create_unet(**kw, dtype=torch.float32), params).eval()
    return flax_unet, params, port, xt, cond


@pytest.mark.parametrize("scale_shift,ce_head", [(False, False), (True, True)])
@pytest.mark.parametrize("t", [(7, 201), (1, 250)])
def test_forward_matches_flax(scale_shift, ce_head, t):
    flax_unet, params, port, xt, cond = _build(scale_shift, ce_head)
    t = np.array(t, dtype=np.int32)
    ref = flax_unet.apply({"params": params}, jnp.asarray(xt), jnp.asarray(cond),
                          jnp.asarray(t))
    with torch.no_grad():
        ours = port(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(t))
    out = ours["diffusion_out"].numpy()
    assert out.shape == (B, H, W, C)
    # fp32 through ~40 layers: the JAX-vs-reference-torch parity test held
    # the same network to 2e-5
    np.testing.assert_allclose(out, np.asarray(ref["diffusion_out"]), atol=2e-5, rtol=0)
    # the softmax is not degenerate: the un-zeroed heads make the torso matter
    assert np.abs(out - 0.5).max() > 1e-2
    if ce_head:
        np.testing.assert_allclose(ours["logits"].numpy(), np.asarray(ref["logits"]),
                                   atol=2e-5, rtol=0)
    else:
        assert ours["logits"] is None


def test_converter_equals_flax_unet_to_torch():
    _, params, port, _, _ = _build(False, True)
    ours = flax_params_to_state_dict(params)
    ref = flax_unet_to_torch(params)
    assert set(ours) == set(ref) == set(port.state_dict())
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_kernel_sites_per_forward():
    """Every GroupNorm and attention of the tiny UNet is a kernel site: 2 per
    ResBlock (4 encoder, 2 middle, 6 decoder), 1 per attention block (2
    encoder, 1 middle, 3 decoder) and the head's."""
    *_, port, _, _ = _build(False, False)
    assert sum(isinstance(m, GroupNorm32) for m in port.modules()) == 12 * 2 + 6 + 1
    assert sum(isinstance(m, AttentionBlock) for m in port.modules()) == 6


def test_timestep_embedding_matches_jax():
    from ccdm_tpu.models.layers import timestep_embedding as jax_embedding

    t = np.array([1, 17, 250], dtype=np.int32)
    for dim in (16, 33):
        ours = timestep_embedding(torch.from_numpy(t), dim).numpy()
        ref = np.asarray(jax_embedding(jnp.asarray(t), dim))
        # cos/sin of arguments up to 250 rad: libm ulps of the argument
        np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=0)


def _norm_inputs(net):
    """Hooks that record whether each GroupNorm's input is channels-last."""
    from ccdm_tpu_torch.ops.group_norm import channels_last

    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
        "nhwc" if channels_last(a[0]) else "nchw" if a[0].is_contiguous() else "other"))
        for m in net.modules() if isinstance(m, GroupNorm32)]
    return seen, hooks


def test_the_channels_last_forward_equals_the_nchw_forward():
    """A UNet as built runs NCHW, and its training forward hands K2's
    backward NCHW; with its float convs' weights laid out channels-last (as
    the samplers lay them out) its forward runs channels-last from the
    input concat to the head; at fp32 the two agree within the JAX parity
    bound."""
    *_, port, xt, cond = _build(False, True)
    args = (torch.from_numpy(xt), torch.from_numpy(cond), torch.tensor([7, 201]))
    assert not port.channels_last
    assert all(c.weight.is_contiguous() for c in port._float_convs)
    seen, hooks = _norm_inputs(port)
    nchw = port(*args)  # the parameters require grad: autograd records
    sites = len(seen)
    assert seen == ["nchw"] * sites
    nchw["diffusion_out"].sum().backward()  # K2's backward takes what it saved: NCHW
    seen.clear()
    port.lay_out_weights(True)
    assert port.channels_last
    assert all(c.weight.is_contiguous(memory_format=torch.channels_last)
               for c in port._float_convs)
    with torch.no_grad():
        cl = port(*args)
    assert seen == ["nhwc"] * sites and cl["diffusion_out"].is_contiguous()
    port.lay_out_weights(False)
    for h in hooks:
        h.remove()
    assert not port.channels_last
    for key in ("diffusion_out", "logits"):
        np.testing.assert_allclose(cl[key].numpy(), nchw[key].detach().numpy(), atol=2e-5,
                                   rtol=0)


def test_an_int8_unet_hands_its_kernels_nchw():
    """A `quantize_convs` UNet's inference forward stays NCHW: K3's int8
    convs and K2 take contiguous inputs."""
    from ccdm_tpu_torch.ops.quant import QuantConv2d

    kw = dict(image_size=TINY_UNET["image_size"], base_channels=TINY_UNET["base_channels"],
              out_channels=C, channel_mult=TINY_UNET["channel_mult"],
              attention_resolutions=TINY_UNET["attention_resolutions"],
              num_head_channels=TINY_UNET["num_head_channels"], dtype=torch.float32)
    net = create_unet(**kw, quantize_convs=True).eval()
    convs = []
    hooks = [m.register_forward_pre_hook(lambda m, a: convs.append(a[0].is_contiguous()))
             for m in net.modules() if isinstance(m, QuantConv2d)]
    seen, more = _norm_inputs(net)
    with torch.no_grad():
        net(torch.zeros(B, H, W, C), torch.zeros(B, H, W, 1), torch.tensor([3, 9]))
    for h in hooks + more:
        h.remove()
    assert convs and all(convs)
    assert seen and set(seen) == {"nchw"}

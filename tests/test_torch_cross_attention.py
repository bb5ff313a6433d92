"""Port parity of the spatial transformer (`ccdm_tpu_torch/models/cross_attention.py`)
against the JAX package's (`ccdm_tpu/models/cross_attention.py`) on the CPU
in fp32, with the JAX module's weights carried across by the converter.

The JAX module's output projection starts at zero, which would make both
modules return their input whatever the blocks compute: every leaf is
redrawn from a numpy seed first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.models.cross_attention import SpatialTransformer as JaxSpatialTransformer
from ccdm_tpu_torch.models.convert import flax_spatial_transformer_to_state_dict
from ccdm_tpu_torch.models.cross_attention import SpatialTransformer

torch.set_num_threads(2)

B, H, W, C = 2, 4, 6, 32  # 32 channels: GroupNorm32's 32 groups of one
HEADS, DH, S, CTX = 2, 8, 5, 12  # heads, head width, context tokens and width


def _redrawn(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.2).astype(np.float32),
                        jax.device_get(params))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("with_context", [True, False], ids=["context", "self"])
def test_spatial_transformer_matches_jax(depth, with_context):
    """The same input, context and weights: the port's NCHW output equals
    the JAX module's NHWC one within 2e-5 of its largest value."""
    rng = np.random.default_rng(depth * 10 + with_context)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ctx = rng.standard_normal((B, S, CTX)).astype(np.float32)
    context = jnp.asarray(ctx) if with_context else None
    jst = JaxSpatialTransformer(num_heads=HEADS, head_dim=DH, depth=depth)
    params = jst.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), context)
    params = _redrawn(params["params"], seed=depth)
    ref = np.asarray(jst.apply({"params": params}, jnp.asarray(x), context))

    st = SpatialTransformer(C, HEADS, DH, depth=depth,
                            context_dim=CTX if with_context else None)
    st.load_state_dict(flax_spatial_transformer_to_state_dict(params), strict=True)
    with torch.no_grad():
        ours = st(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                  torch.from_numpy(ctx) if with_context else None)
    ours = ours.permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape == x.shape
    assert not np.allclose(ref, x, atol=1e-3)  # the blocks moved the output
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


def test_spatial_transformer_starts_as_the_identity():
    """Built fresh, the zero-initialised output projection makes it return
    its input, as the JAX module does at init."""
    st = SpatialTransformer(C, HEADS, DH)
    x = torch.randn(B, C, H, W)
    with torch.no_grad():
        assert torch.equal(st(x), x)

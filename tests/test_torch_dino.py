"""Port parity: `ccdm_tpu_torch.models.dino` against the JAX package's DINO
encoder, on a tiny ViT (embed 48, depth 2, 2 heads, patch 8, pretrained on
a 4x4 grid) and a non-square 32x64 image, so the position embedding is
interpolated; at stride 8 and at stride 4, where the patches overlap and
the 7x15 token grid is resized to 8x16. Weights go through the jax-free
`flax_dino_to_state_dict`."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ccdm_tpu.models import dino as jdino
from ccdm_tpu_torch.eval.lidc_uncertainty import build_eval_feature_fn
from ccdm_tpu_torch.models import dino as tdino
from ccdm_tpu_torch.models.convert import flax_dino_to_state_dict
from torch_port_util import unzero

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
VIT = dict(embed_dim=48, depth=2, num_heads=2, patch_size=8, pretrain_size=32)
# fp32 through two transformer blocks on O(1) activations: reassociation
# of 48-wide sums, a few ulps a layer
ATOL = 2e-5


def _fce(stride):
    return {"type": "dino", "model": "dino_vits8", "vit_config": VIT,
            "output_stride": stride, "source_layer": 1, "train": False}


@pytest.fixture(scope="module", params=[8, 4], ids=["stride8", "stride4"])
def encoders(request):
    stride = request.param
    jenc = jdino.DinoFeatureEncoder(_fce(stride))
    # every zero leaf (cls token, biases) redrawn, so each of them matters
    params = unzero(jenc.init(jax.random.PRNGKey(0), (32, 64, 3)))
    tenc = tdino.DinoFeatureEncoder(_fce(stride))
    vit = tenc.init(device="cpu")
    vit.load_state_dict(flax_dino_to_state_dict(params), strict=True)
    images = np.random.default_rng(1).standard_normal((2, 32, 64, 3)).astype(np.float32)
    return jenc, params, tenc, vit, images


@pytest.mark.parametrize("facet", ["key", "query", "value", "token", "attn"])
def test_facets_match_jax(encoders, facet):
    jenc, params, _, vit, images = encoders
    ref = np.asarray(jenc.module.apply({"params": params}, jnp.asarray(images), facet=facet))
    with torch.no_grad():
        ours = vit(torch.from_numpy(images), facet=facet).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert np.abs(ref).max() > 0.1  # not degenerate


def test_encoder_call_matches_jax(encoders):
    """The feature map the UNet gets: at stride 4 the 7x15 token grid is
    bilinearly upsampled to 8x16, as `jax.image.resize` does."""
    jenc, params, tenc, vit, images = encoders
    ref = np.asarray(jenc(params, jnp.asarray(images)))
    with torch.no_grad():
        ours = tenc(vit, torch.from_numpy(images)).numpy()
    stride = tenc.stride
    assert ours.shape == ref.shape == (2, 32 // stride, 64 // stride, 48)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("grid", [(4, 8), (7, 15), (3, 3), (4, 4), (32, 64)])
def test_interpolate_pos_embed_matches_jax(grid):
    pe = np.random.default_rng(2).standard_normal((1, 1 + 16, 8)).astype(np.float32)
    ours = tdino.interpolate_pos_embed(torch.from_numpy(pe), grid).numpy()
    ref = np.asarray(jdino.interpolate_pos_embed(jnp.asarray(pe), grid))
    assert ours.shape == ref.shape == (1, 1 + grid[0] * grid[1], 8)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_bicubic_matrix_is_torch_interpolate():
    """The copied sampling matrix is what upstream DINO's own call computes,
    `F.interpolate(bicubic, scale_factor=(g + 0.1)/side,
    recompute_scale_factor=False)`; the port keeps the matrix, which the
    JAX package uses too."""
    grid = torch.randn(1, 8, 4, 4, generator=torch.Generator().manual_seed(3))
    for h, w in ((4, 8), (7, 15), (3, 3)):
        ref = F.interpolate(grid, scale_factor=((h + 0.1) / 4, (w + 0.1) / 4),
                            mode="bicubic", align_corners=False,
                            recompute_scale_factor=False)
        wh = torch.from_numpy(tdino._torch_bicubic_matrix(4, h, 4 / (h + 0.1)))
        ww = torch.from_numpy(tdino._torch_bicubic_matrix(4, w, 4 / (w + 0.1)))
        ours = torch.einsum("hs,wt,bcst->bchw", wh, ww, grid)
        torch.testing.assert_close(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [((7, 15), (8, 16)), ((8, 16), (64, 128)), ((3, 5), (3, 5))])
def test_resize_bilinear_matches_jax_upsampling(src, dst):
    x = np.random.default_rng(4).standard_normal((2, *src, 5)).astype(np.float32)
    ours = tdino.resize_bilinear(torch.from_numpy(x), dst).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="bilinear"))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_resize_bilinear_refuses_downsampling():
    """Downsampling was refused until it was ported; it now antialiases as
    `jax.image.resize` does (more cases in test_torch_dino_extras.py), and
    an empty target is what is refused."""
    x = np.random.default_rng(5).standard_normal((1, 8, 8, 2)).astype(np.float32)
    ours = tdino.resize_bilinear(torch.from_numpy(x), (4, 8)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 4, 8, 2), method="bilinear"))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tdino.resize_bilinear(torch.zeros(1, 8, 8, 2), (0, 8))


def test_converter_inverts_the_checkpoint_script(encoders, tmp_path):
    """The port's weights through `scripts/convert_dino_checkpoint.convert`
    (torch names -> the `.npz` layout) and back through
    `build_eval_feature_fn`'s `weights:` loading give the same tensors."""
    sys.path.insert(0, str(REPO / "scripts"))
    from convert_dino_checkpoint import convert

    *_, vit, _ = encoders
    state = {k: v.numpy() for k, v in vit.state_dict().items()}
    npz = tmp_path / "dino.npz"
    np.savez(npz, **convert(state))
    fce = dict(_fce(8), weights=str(npz))
    fn, shape, net = build_eval_feature_fn({"feature_cond_encoder": fce}, (32, 64, 3),
                                           device="cpu")
    assert shape == (4, 8, 48)
    for key, value in net.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
    with torch.no_grad():
        out = fn(net, torch.zeros(1, 32, 64, 3))
    assert out.shape == (1, 4, 8, 48)


def test_full_size_encoder_names_and_shapes():
    """dino_vits8 as configured: the upstream `VisionTransformer`'s
    parameter names and shapes, 12 blocks of 384 channels (built on the
    meta device, nothing allocated)."""
    enc = tdino.DinoFeatureEncoder({"type": "dino", "model": "dino_vits8", "output_stride": 8,
                                    "source_layer": 11})
    with torch.device("meta"):
        vit = tdino.DinoViT(384, 12, 6, 8, 8)
    shapes = {k: tuple(v.shape) for k, v in vit.state_dict().items()}
    assert enc.channels == 384
    assert shapes["patch_embed.proj.weight"] == (384, 3, 8, 8)
    assert shapes["pos_embed"] == (1, 1 + 28 * 28, 384)
    assert shapes["blocks.11.attn.qkv.weight"] == (3 * 384, 384)
    assert shapes["blocks.11.mlp.fc1.weight"] == (1536, 384)
    assert len(shapes) == 4 + 12 * 12  # patch conv weight and bias, cls, pos, 12 a block


def test_encoder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdino.DinoFeatureEncoder(_fce(8)).init()

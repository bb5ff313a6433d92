"""DINO's descriptor extras in the port (`ccdm_tpu_torch/models/dino.py`)
against the JAX package's, on a tiny ViT (48 channels, 6 heads of 8, 3
blocks) with the same NumPy-seeded weights and images: the facets of
several blocks in one pass, `log_bin_descriptors`,
`extract_descriptors` (one block and several, with and without
`resize_shape`, upsampling and downsampling), `extract_saliency_maps` and
its dino_vits8-only refusal, and the bilinear resize's antialiased
downsampling against `jax.image.resize`; all in fp32 within 1e-5. Then
the LANCZOS resize of the descriptor CLI's input bit for bit against
Pillow, and the two descriptor tools against the JAX scripts: the upstream
`.pth` converter array for array, the extraction CLI's `.npy` within
1e-5."""

import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ccdm_tpu.models import dino as jdino
from ccdm_tpu_torch.data.resample import resize_lanczos_uint8
from ccdm_tpu_torch.models import dino as tdino
from ccdm_tpu_torch.models.convert import flax_dino_to_state_dict
from torch_port_util import unzero

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
VIT = dict(embed_dim=48, depth=3, num_heads=6, patch_size=8, pretrain_size=32)
# fp32 through three transformer blocks and a pooling or resize: sums of
# 48 channels and of a few taps, reassociated, a few ulps of O(1) values
ATOL = 1e-5


def _fce(name="dino_vits8"):
    return {"type": "dino", "model": name, "vit_config": VIT, "output_stride": 4,
            "source_layer": 2, "facet": "key", "train": False}


@pytest.fixture(scope="module")
def encoders():
    jenc = jdino.DinoFeatureEncoder(_fce())
    params = unzero(jenc.init(jax.random.PRNGKey(0), (32, 48, 3)))
    tenc = tdino.DinoFeatureEncoder(_fce())
    vit = tenc.init(device="cpu")
    vit.load_state_dict(flax_dino_to_state_dict(params), strict=True)
    images = np.random.default_rng(1).standard_normal((2, 32, 48, 3)).astype(np.float32)
    return jenc, params, tenc, vit, images


def _close(ours, ref):
    ours = ours.numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert np.abs(ref).max() > 0.05  # not degenerate


@pytest.mark.parametrize("facet,layers", [("key", (0, 2)), ("token", (1,)), ("attn", (2, 0))])
def test_several_blocks_in_one_pass_match_jax(encoders, facet, layers):
    jenc, params, _, vit, images = encoders
    refs = jenc.module.apply({"params": params}, jnp.asarray(images), facet=facet, layers=layers)
    with torch.no_grad():
        ours = vit(torch.from_numpy(images), facet=facet, layers=layers)
    assert len(ours) == len(refs) == len(layers)
    for o, r in zip(ours, refs):
        _close(o, r)
    with pytest.raises(ValueError, match="out of range"):
        vit(torch.from_numpy(images), layers=(3,))


@pytest.mark.parametrize("shape,hierarchy", [((2, 7, 11, 5), 2), ((1, 12, 10, 3), 3),
                                             ((1, 2, 3, 4), 2)])
def test_log_bin_descriptors_match_jax(shape, hierarchy):
    feats = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ours = tdino.log_bin_descriptors(torch.from_numpy(feats), hierarchy)
    assert ours.shape == (*shape[:3], shape[3] * (1 + 8 * hierarchy))
    _close(ours, jdino.log_bin_descriptors(jnp.asarray(feats), hierarchy))


@pytest.mark.parametrize("layers,resize_shape,log_bin", [
    (None, None, False),          # the configured block, upsampled 7x11 -> 8x12
    (1, (4, 5), True),            # one block, log-binned, downsampled
    ([0, 2], None, False),        # several blocks: no resize unless asked
    ([2, 1], (16, 24), True),     # several blocks, log-binned, upsampled
    ((0,), (3, 11), False),       # one axis down, the other kept
])
def test_extract_descriptors_match_jax(encoders, layers, resize_shape, log_bin):
    jenc, params, tenc, vit, images = encoders
    ref = jenc.extract_descriptors(params, jnp.asarray(images), layers=layers,
                                   resize_shape=resize_shape, log_bin=log_bin)
    ours = tenc.extract_descriptors(vit, torch.from_numpy(images), layers=layers,
                                    resize_shape=resize_shape, log_bin=log_bin)
    if isinstance(layers, (list, tuple)):
        assert isinstance(ours, list) and len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _close(o, r)
    else:
        _close(ours, ref)
    with pytest.raises(ValueError, match="not a supported facet"):
        tenc.extract_descriptors(vit, torch.from_numpy(images), facet="attn")


def test_saliency_maps_match_jax_and_need_vits8(encoders):
    jenc, params, tenc, vit, images = encoders
    ours = tenc.extract_saliency_maps(vit, torch.from_numpy(images))
    assert ours.shape == (2, 7 * 11)
    _close(ours, jenc.extract_saliency_maps(params, jnp.asarray(images)))
    assert float(ours.min()) == 0.0 and abs(float(ours.max()) - 1.0) < 1e-6
    with pytest.raises(ValueError, match="dino_vits"):
        tdino.DinoFeatureEncoder(_fce("dino_vitb8")).extract_saliency_maps(
            vit, torch.from_numpy(images))


@pytest.mark.parametrize("src,dst", [((8, 16), (4, 8)), ((7, 15), (3, 4)), ((9, 9), (9, 2)),
                                     ((5, 6), (2, 13))])
def test_resize_bilinear_downsampling_matches_jax(src, dst):
    x = np.random.default_rng(4).standard_normal((2, *src, 5)).astype(np.float32)
    ours = tdino.resize_bilinear(torch.from_numpy(x), dst)
    _close(ours, jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="bilinear"))


@pytest.mark.parametrize("src,dst", [((37, 53), (224, 321)), ((301, 224), (37, 53)),
                                     ((50, 50), (51, 49)), ((7, 9), (3, 31)), ((480, 640), (224, 299))])
@pytest.mark.parametrize("rgb", [False, True], ids=["L", "RGB"])
def test_resize_lanczos_uint8_is_pils(src, dst, rgb):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (*src, 3) if rgb else src, dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.LANCZOS))
    ours = resize_lanczos_uint8(img, dst)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


def _upstream_state(depth: int = 2, dim: int = 16, heads_mlp: int = 64):
    """A synthesised upstream DINO `VisionTransformer` state dict, with the
    final `norm.*` entries the port builds no module for."""
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    state = {"cls_token": t(1, 1, dim), "pos_embed": t(1, 1 + 16, dim),
             "patch_embed.proj.weight": t(dim, 3, 8, 8), "patch_embed.proj.bias": t(dim),
             "norm.weight": t(dim), "norm.bias": t(dim)}
    for n in range(depth):
        p = f"blocks.{n}"
        state.update({f"{p}.norm1.weight": t(dim), f"{p}.norm1.bias": t(dim),
                      f"{p}.attn.qkv.weight": t(3 * dim, dim), f"{p}.attn.qkv.bias": t(3 * dim),
                      f"{p}.attn.proj.weight": t(dim, dim), f"{p}.attn.proj.bias": t(dim),
                      f"{p}.norm2.weight": t(dim), f"{p}.norm2.bias": t(dim),
                      f"{p}.mlp.fc1.weight": t(heads_mlp, dim),
                      f"{p}.mlp.fc1.bias": t(heads_mlp),
                      f"{p}.mlp.fc2.weight": t(dim, heads_mlp), f"{p}.mlp.fc2.bias": t(dim)})
    return state


@pytest.mark.parametrize("wrapped", [False, True], ids=["state_dict", "checkpoint"])
def test_dino_checkpoint_converter_equals_the_jax_script(tmp_path, wrapped):
    sys.path.insert(0, str(REPO / "scripts"))
    from convert_dino_checkpoint import convert

    from ccdm_tpu_torch.tools import convert_dino_checkpoint as tool

    state = _upstream_state()
    pth = tmp_path / "dino.pth"
    torch.save({"state_dict": state} if wrapped else state, pth)
    assert tool.main([str(pth), str(tmp_path / "dino.npz")]) == 0
    ref = convert({k: v.numpy() for k, v in state.items()})
    with np.load(tmp_path / "dino.npz") as ours:
        assert sorted(ours.files) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    # and it loads where `weights:` names it
    enc = tdino.DinoFeatureEncoder({"type": "dino", "model": "dino_vits8", "output_stride": 8,
                                    "source_layer": 1, "vit_config": dict(embed_dim=16, depth=2, num_heads=2,
                                                       patch_size=8, pretrain_size=32)})
    vit = enc.load_pretrained(enc.init(device="cpu"), str(tmp_path / "dino.npz"))
    for k, v in vit.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), err_msg=k)


VIT_SMALL = dict(embed_dim=48, depth=2, num_heads=6, patch_size=8, pretrain_size=32)
MODES = ("bin", "saliency")


def _cli_args(root, mode):
    return ["--image_path", str(root / "img.png"), "--weights", str(root / "w.npz"),
            "--load_size", "32", "--stride", "4", "--layer", "1", f"--{mode}"]


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """One PNG (a 45x61 RGB image: LANCZOS to load size 32), one set of tiny
    converted weights, and the JAX script's `.npy` in both modes (run in
    this process; the script builds the named model, so the tiny config
    goes in through `VIT_CONFIGS`)."""
    from ccdm_tpu_torch.utils.png import write_png

    root = tmp_path_factory.mktemp("cli")
    jenc = jdino.DinoFeatureEncoder({"model": "dino_vits8", "vit_config": VIT_SMALL,
                                     "source_layer": 1})
    params = unzero(jenc.init(jax.random.PRNGKey(3), (32, 32, 3)))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(root / "w.npz", **flat)
    img = np.random.default_rng(7).integers(0, 256, (45, 61, 3), dtype=np.uint8)
    write_png(str(root / "img.png"), img)
    script = str(REPO / "scripts" / "extract_dino_descriptors.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdino.VIT_CONFIGS, "dino_vits8", VIT_SMALL)
        for mode in MODES:
            mp.setattr(sys, "argv", [script, "--output_path", str(root / f"ref_{mode}.npy"),
                                     *_cli_args(root, mode)])
            runpy.run_path(script, run_name="__main__")
    return root


@pytest.mark.parametrize("mode", MODES)
def test_descriptor_cli_equals_the_jax_script(jax_cli, monkeypatch, mode):
    """Both CLIs on the same PNG and weights: the `.npy` files agree."""
    from ccdm_tpu_torch.tools import extract_dino_descriptors as tool

    monkeypatch.setitem(tdino.VIT_CONFIGS, "dino_vits8", VIT_SMALL)
    out = jax_cli / f"ours_{mode}.npy"
    assert tool.main(["--output_path", str(out), "--device", "cpu",
                      *_cli_args(jax_cli, mode)]) == 0
    ours, ref = np.load(out), np.load(jax_cli / f"ref_{mode}.npy")
    # 45x61 -> 32x43: a 7x9 token grid at stride 4, descriptors at 8x10
    assert ours.shape == ref.shape == ((1, 7 * 9) if mode == "saliency" else (1, 8, 10, 48 * 17))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)

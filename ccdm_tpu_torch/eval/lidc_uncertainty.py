"""LIDC uncertainty evaluation (port of `ccdm_tpu/eval/lidc_uncertainty.py`).

Ported: `make_prob_sampler`, the batched multi-sample generation that the
LIDC harness, the Cityscapes evaluator and the benchmark call;
`load_eval_params`, the EMA weights of a checkpoint (`load_from`); and
`build_eval_feature_fn`, the DINO conditioning of an eval config. The
harness around them is not ported yet, nor are per-element noise keys.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ccdm_tpu_torch.diffusion.sampling import SamplerConfig, ancestral_sampler, sample_prior
from ccdm_tpu_torch.models.builder import DenoisingModel

LOGGER = logging.getLogger(__name__)


def make_prob_sampler(model: DenoisingModel, num_samples: int,
                      num_steps: Optional[int] = None, feature_fn=None,
                      encoder_reuse: int = 1):
    """`(net, images [B,H,W,Ci], generator) -> probs [B,S,H,W,C]`.

    Each image is repeated S times, image-major (as `jnp.repeat`), the prior
    is drawn, and the ancestral sampler runs under `torch.inference_mode()`
    with the model's `step_T_sample` mode for the final step ("confidence"
    yields probability maps). `net` is the module holding the weights (the
    JAX version's `params`).

    `feature_fn(feature_net, images)` gives the DINO map of the B images,
    once, which is then repeated S times; `feature_net` (the encoder's
    weights, the JAX version's `feature_params`) is passed to each call.
    `encoder_reuse` R > 1 replays the UNet encoder's activations on the
    steps between every R-th.

    For the tests, `prior` `[B·S,H,W,C]` and the chain noise (`gumbel`
    `[K,B·S,H,W,C]` in the one-hot state, `uniforms` `[K,B·S,H,W]` in the
    index state) inject the noise the JAX sampler drew; otherwise it all
    comes from `generator`.
    """
    cfg = SamplerConfig(num_steps=num_steps or model.time_steps,
                        step_T_sample=model.step_T_sample,
                        encoder_reuse=int(encoder_reuse))
    c = model.diffusion.num_classes

    def run(net, images: torch.Tensor, generator: Optional[torch.Generator] = None, *,
            feature_net=None, prior: Optional[torch.Tensor] = None,
            gumbel: Optional[torch.Tensor] = None,
            uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = images.shape
        with torch.inference_mode():
            cond = images.repeat_interleave(num_samples, dim=0)
            fc = None
            if feature_fn is not None:
                fc = feature_fn(feature_net, images).repeat_interleave(num_samples, dim=0)
            xt = (sample_prior(b * num_samples, h, w, c, generator, images.device)
                  if prior is None else prior)
            pair = (model.denoise_fns_cached(net, cond, fc)
                    if cfg.encoder_reuse > 1 else None)
            out = ancestral_sampler(model.diffusion, model.denoise_fn(net, cond, fc), xt,
                                    cfg, generator, gumbel=gumbel, uniforms=uniforms,
                                    denoise_pair=pair)
        return out.reshape(b, num_samples, h, w, c)

    return run


def load_eval_params(params: Dict[str, Any], net: torch.nn.Module) -> torch.nn.Module:
    """Load the EMA weights (`average_model`, else `model`) of the port's
    checkpoint at `params["load_from"]` into `net`; without `load_from`,
    leave its weights as they are, with a warning."""
    load_from = params.get("load_from")
    if not load_from:
        LOGGER.warning("no load_from given — evaluating randomly initialised weights")
        return net
    from ccdm_tpu_torch.config import expanduservars
    from ccdm_tpu_torch.train.checkpoint import load_tree

    tree = load_tree(expanduservars(load_from))
    restored = tree.get("average_model", tree.get("model"))
    if restored is None:
        raise KeyError(f"checkpoint at {load_from!r} has no average_model/model key")
    net.load_state_dict(restored, strict=True)
    return net


def _unflatten(flat) -> Dict[str, Any]:
    """`{"a/b/c": array}` (a converted `.npz`) -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key in flat:
        *parents, leaf = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(flat[key])
    return tree


def build_eval_feature_fn(params: Dict[str, Any], image_shape, *, device=None,
                          generator: Optional[torch.Generator] = None):
    """Eval-time DINO conditioning: `(feature_fn, feature_shape, encoder
    net)`, all None when no encoder is configured.

    `feature_fn(net, images)` maps `[B,H,W,3]` to `[B,H/s,W/s,D]`. The
    weights resolve in the reference's order: the `load_from` checkpoint's
    `average_feature_cond_encoder`, then its `feature_cond_encoder`, then
    the converted `.npz` named by `weights:` (numpy only), else random
    weights from `generator` (default: seed 7), with a warning. The net is
    built on `device` (default: the CUDA card).
    """
    fce = params.get("feature_cond_encoder") or {"type": "none"}
    if fce.get("type") != "dino":
        return None, None, None
    from ccdm_tpu_torch.models.convert import flax_dino_to_state_dict
    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder

    encoder = DinoFeatureEncoder(fce)
    net = encoder.init(generator, device)
    loaded = False
    if params.get("load_from"):
        from ccdm_tpu_torch.config import expanduservars
        from ccdm_tpu_torch.train.checkpoint import load_tree

        try:
            tree = load_tree(expanduservars(params["load_from"]))
        except FileNotFoundError:
            tree = {}
        for key in ("average_feature_cond_encoder", "feature_cond_encoder"):
            if key in tree:
                net.load_state_dict(tree[key], strict=True)
                loaded = True
                LOGGER.info("loaded encoder weights from checkpoint key %r", key)
                break
    if not loaded and fce.get("weights"):
        with np.load(fce["weights"]) as blob:
            state = flax_dino_to_state_dict(_unflatten(blob))
        net.load_state_dict(state, strict=True)
    elif not loaded:
        LOGGER.warning("DINO eval conditioning with RANDOM encoder weights")
    feature_shape = (image_shape[0] // encoder.stride,
                     image_shape[1] // encoder.stride, encoder.channels)
    return encoder, feature_shape, net

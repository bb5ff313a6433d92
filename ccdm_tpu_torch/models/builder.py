"""Model assembly from the `params.yml` config surface (port of
`ccdm_tpu/models/builder.py`).

`in_channels = num_classes + image_channels` (the UNet consumes
`concat([x_t, condition])`), `out_channels = num_classes`. `compute_dtype`
sets the torso's dtype; GroupNorm parameters and the output heads stay fp32,
as the JAX package's `param_dtype=float32` keeps them. Of `unet_openai`'s
memory and norm keys, `use_checkpoint` (default false) and
`remat_attention` (default true, as in the JAX package) rematerialise the
ResBlocks and the attention blocks in training (`models/unet.TimestepBlock`);
`norm_fp32` takes either value and changes no bit, as in the JAX package
(`models/layers.GroupNorm32`), so the port's norm does not read it.

Modules are constructed on the meta device and their weights drawn from an
explicit CPU `torch.Generator`, so building a model touches no global RNG
and gives the same weights on every device.

`quantized_inference` (any true value) builds the int8 convs
(`ops/quant.py`); `DenoisingModel.with_quant_scales` gives a model whose
UNet calls use calibrated static activation scales, and a model without
them runs the dynamic scales.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ccdm_tpu_torch.diffusion.categorical import CategoricalDiffusion
from ccdm_tpu_torch.diffusion.sampling import SamplerConfig, ancestral_sampler
from ccdm_tpu_torch.models.dino import VIT_CONFIGS
from ccdm_tpu_torch.models.layers import GroupNorm32
from ccdm_tpu_torch.models.unet import UNetModel, create_unet
from ccdm_tpu_torch.ops import quant
from ccdm_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class DenoisingModel:
    """Diffusion math + UNet + sampler entry points.

    As in the JAX package, the weights are an argument: `net` plays the role
    of Flax's `params` (the module holding the weights, e.g. `self.unet` or
    an EMA copy of it); `unet` is the module `build_model` made.

    `quant_scales`: the calibrated int8 activation absmax per site (module
    name -> fp32 device scalar, `ops.quant.calibrate_sampler`), applied
    around every UNet call this model makes; None: dynamic scales. It is
    not part of any state dict.
    """

    diffusion: CategoricalDiffusion
    unet: UNetModel
    step_T_sample: str = "majority"
    quant_scales: Optional[Dict[str, torch.Tensor]] = dataclasses.field(
        default=None, compare=False, repr=False)
    # the static scales max(absmax, 1e-8) / 127, derived once from quant_scales
    act_scales: Optional[Dict[str, torch.Tensor]] = dataclasses.field(
        default=None, init=False, compare=False, repr=False)

    def __post_init__(self):
        if self.quant_scales is not None:
            object.__setattr__(self, "act_scales", {
                name: quant.static_act_scale(v) for name, v in self.quant_scales.items()})

    @property
    def time_steps(self) -> int:
        return self.diffusion.time_steps

    def with_quant_scales(self, scales: Dict[str, torch.Tensor]) -> "DenoisingModel":
        """A model whose int8 convs use calibrated static activation scales:
        `scales` is `ops.quant.calibrate_sampler`'s table."""
        return dataclasses.replace(self, quant_scales=scales)

    def _call(self, net: UNetModel, *args, **kwargs) -> dict:
        with quant.static_scales(net, self.act_scales):
            return net(*args, **kwargs)

    def apply(self, net: UNetModel, xt: torch.Tensor, condition: torch.Tensor,
              t: torch.Tensor, feature_condition: Optional[torch.Tensor] = None) -> dict:
        """One UNet call: `xt` `[B,H,W,C]`, `condition` `[B,H,W,Ci]`, `t` `[B]`,
        `feature_condition` `[B,h,w,Cf]` where the UNet concatenates one."""
        return self._call(net, xt, condition, t, feature_condition)

    def denoise_fn(self, net: UNetModel, condition: torch.Tensor,
                   feature_condition: Optional[torch.Tensor] = None):
        """Close over the conditioning -> `(xt, t) -> p0` for the sampler."""
        def fn(xt, t):
            return self.apply(net, xt, condition, t, feature_condition)["diffusion_out"]
        return fn

    def denoise_fns_cached(self, net: UNetModel, condition: torch.Tensor,
                           feature_condition: Optional[torch.Tensor] = None):
        """The pair for encoder-reuse sampling: `full(xt, t) -> (p0, skips)`
        runs the whole UNet and returns the encoder activations;
        `reuse(xt, t, skips) -> p0` replays them through the middle and the
        decoder with the current step's time embedding."""
        def full(xt, t):
            ret = self._call(net, xt, condition, t, feature_condition, return_skips=True)
            return ret["diffusion_out"], ret["skips"]

        def reuse(xt, t, skips):
            return self._call(net, xt, condition, t, cached_skips=skips)["diffusion_out"]

        return full, reuse

    def sample(self, net: UNetModel, xt: torch.Tensor, condition: torch.Tensor,
               num_steps: Optional[int] = None,
               feature_condition: Optional[torch.Tensor] = None, *,
               element_keys: Optional[torch.Tensor] = None,
               gumbel: Optional[torch.Tensor] = None,
               uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Ancestral sampling from the prior draw `xt` -> `[B,H,W,C]`."""
        cfg = SamplerConfig(num_steps=num_steps or self.time_steps,
                            step_T_sample=self.step_T_sample)
        return ancestral_sampler(self.diffusion,
                                 self.denoise_fn(net, condition, feature_condition),
                                 xt, cfg, element_keys=element_keys, gumbel=gumbel,
                                 uniforms=uniforms)


# flax's lecun_normal: a normal truncated at 2 sigma, its scale raised so the
# variance stays 1/fan_in (the std of N(0, 1) truncated to [-2, 2])
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight from `generator` (a CPU generator) as the JAX
    package's flax modules draw theirs: conv and linear weights lecun normal
    (a normal truncated to +-2 sigma with variance 1/fan_in), biases 0,
    GroupNorm 1/0, and zeros for modules marked `zero_init` (output
    projections and heads). The int8 `QuantConv2d` is an `nn.Conv2d` and
    draws the same weights, kept in fp32."""
    for module in net.modules():
        if isinstance(module, GroupNorm32):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
        elif isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = module.weight
            if getattr(module, "zero_init", False):
                w.zero_()
            else:
                fan_in = math.prod(w.shape[1:])
                draw = nn.init.trunc_normal_(torch.empty(w.shape), 0.0, 1.0, -2.0, 2.0,
                                             generator=generator)
                w.copy_(draw / (math.sqrt(fan_in) * _TRUNCATED_STD))
            if module.bias is not None:
                module.bias.zero_()
    return net


@trace.span("setup.model")
def build_model(
    params: Dict[str, Any],
    num_classes: int,
    image_channels: int = 1,
    image_size: Optional[int] = None,
    *,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> DenoisingModel:
    """Assemble diffusion + UNet from a reference-format `params` dict, on
    `device` (default: the CUDA card; the CPU only when asked for with
    `device="cpu"`), with weights drawn from `generator` (default: seed 0).
    Its span (`utils/trace.py`) is `setup.model`."""
    backbone = params.get("backbone", "unet_openai")
    if backbone != "unet_openai":
        raise ValueError(f"unsupported backbone {backbone!r}")
    bb = dict(params.get("unet_openai") or {})
    fce = params.get("feature_cond_encoder") or {"type": "none"}
    feature_block_idx, feature_stride, feature_channels = -1, 8, 0
    if fce.get("type") == "dino":
        feature_block_idx = int(fce.get("target_layer", 10))
        feature_stride = int(fce.get("output_stride", 8))
        # the encoder's width (Flax infers it from the features it is given)
        vit = fce.get("vit_config") or VIT_CONFIGS[fce.get("model", "dino_vits8")]
        feature_channels = int(vit["embed_dim"])
    elif fce.get("type") not in (None, "none"):
        raise NotImplementedError(f"feature_cond_encoder {fce.get('type')!r} is not ported")

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_model: no CUDA device; the model builds on the card "
                               "unless the caller passes device='cpu'")
        device = "cuda"
    device = torch.device(device)
    diffusion = CategoricalDiffusion.create(
        params.get("beta_schedule", "cosine"),
        int(params.get("time_steps", 250)),
        num_classes,
        params.get("beta_schedule_params"),
        device,
    )
    dtype = (torch.bfloat16 if params.get("compute_dtype", "bfloat16") == "bfloat16"
             else torch.float32)
    with torch.device("meta"):
        unet = create_unet(
            image_size=image_size or int(bb.get("image_size", 128)),
            base_channels=int(bb.get("base_channels", 32)),
            out_channels=num_classes,
            in_channels=num_classes + image_channels,
            num_res_blocks=int(bb.get("num_res_blocks", 2)),
            channel_mult=bb.get("channel_mult"),
            attention_resolutions=tuple(bb.get("attention_resolutions", (32, 16, 8))),
            num_heads=int(bb.get("num_heads", 1)),
            num_head_channels=int(bb.get("num_head_channels", -1)),
            use_scale_shift_norm=bool(bb.get("use_scale_shift_norm", False)),
            dropout=float(bb.get("dropout", 0.0)),
            softmax_output=bool(bb.get("softmax_output", True)),
            ce_head=bool(bb.get("ce_head", False)),
            feature_cond_block_idx=feature_block_idx,
            feature_cond_stride=feature_stride,
            feature_channels=feature_channels,
            dtype=dtype,
            quantize_convs=bool(params.get("quantized_inference", False)),
            remat_resblocks=bool(bb.get("use_checkpoint", False)),
            # the JAX package's default, as the reference checkpoints attention
            remat_attention=bool(bb.get("remat_attention", True)),
        )
    unet = unet.to_empty(device=device)
    init_weights_(unet, generator or torch.Generator().manual_seed(0))
    unet.eval()
    return DenoisingModel(
        diffusion=diffusion,
        unet=unet,
        step_T_sample=params.get("step_T_sample", "majority"),
    )

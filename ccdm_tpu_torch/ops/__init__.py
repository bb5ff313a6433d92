"""The port's hand-written CUDA kernels and their plain PyTorch versions.

- `group_norm`: fused GroupNorm(+SiLU), with an optional `[B, C]` add in
  front of it, `csrc/group_norm.cu`; serves every GroupNorm site of the UNet
  (ResBlocks, where the out-norm takes the time-embedding add, attention
  pre-norms, heads).
- `flash_attention`: attention forward, `csrc/flash_attention.cu` (bf16 on
  the tensor cores); serves every attention block.
- `quant`: the int8 convolution of `quantized_inference`, `csrc/quant_conv.cu`
  (quantize on load, int8 tensor cores, fp32 dequant and bias), its
  `QuantConv2d` module and the static scales' calibration.

Each wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors (or raises); `_build` compiles the kernels on first use. Importing
the package registers the three as PyTorch ops (`ccdm::group_norm`,
`ccdm::flash_attention`, `ccdm::quant_conv`), which the wrappers call only
while `torch.export` traces and which a served sampler's graphs hold
(`utils/serving.py`); `precision.fp32_precision` keeps fp32 arithmetic in
fp32 on the card.
"""

from ccdm_tpu_torch.ops import flash_attention, group_norm, precision, quant  # noqa: F401

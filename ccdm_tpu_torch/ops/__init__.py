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
tensors (or raises); `_build` compiles the kernels on first use.
"""

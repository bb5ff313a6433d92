"""The port's hand-written CUDA kernels and their plain PyTorch versions.

- `group_norm`: fused GroupNorm(+SiLU), `csrc/group_norm.cu`; serves every
  GroupNorm site of the UNet (ResBlocks, attention pre-norms, heads).
- `flash_attention`: attention forward, `csrc/flash_attention.cu`; serves
  every attention block.

Each wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors (or raises); `_build` compiles the kernels on first use.
"""

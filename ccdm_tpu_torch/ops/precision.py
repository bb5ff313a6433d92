"""fp32 arithmetic in fp32 on the card.

PyTorch's default lets cuDNN run fp32 convolutions in TF32
(`torch.backends.cudnn.allow_tf32` is True): their inputs rounded to a
10-bit mantissa. The port's fp32 convolutions are the UNet's output heads
(in every config) and, with `compute_dtype: float32`, every convolution.
Trained in TF32, the LIDC gate's model read GED_16 0.2308 and HM-IoU_16
0.5579; the same run in fp32 read 0.1445 and 0.6799 (NVIDIA H100,
`tools/demo_gate.py`, seed 0, 5000 steps; PERF.md §6), which still missed
the gate's HM-IoU_16 >= 0.69: it passed only once the init also drew
flax's truncated normal (`models/builder.init_weights_`). So the train
step, the samplers (DINO's fp32 patch conv included) and the served
sampler compute in fp32 whatever the process's TF32 settings, as the JAX
package's fp32 reference does. The settings are not part of an exported
graph, so `utils/serving.load_sampler` sets them around every program call;
this module sits in `ops` because a serving process imports nothing else
of the port.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_precision():
    """cuDNN's fp32 convolutions and cuBLAS's fp32 matrix products in fp32,
    not TF32, for the duration (the settings are process-wide: the backward
    of a forward run inside must run inside too); restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

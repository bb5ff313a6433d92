"""Sampling-speed sweep (port of `ccdm_tpu/eval/lidc_sampling_speed.py`):
the LIDC uncertainty evaluation at each denoising step count of the sweep,
default {250, 200, 150, 100, 50, 25, 10}, each with its samples/s."""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty

LOGGER = logging.getLogger(__name__)

DEFAULT_STEP_SWEEP = [250, 200, 150, 100, 50, 25, 10]


def eval_lidc_sampling_speed(params: Dict[str, Any], step_sweep: Optional[List[int]] = None,
                             *, device=None) -> Dict[int, Dict[str, Any]]:
    step_sweep = step_sweep or params.get("step_sweep") or DEFAULT_STEP_SWEEP
    results: Dict[int, Dict[str, Any]] = {}
    for steps in step_sweep:
        LOGGER.info("=== sampling with %d denoising steps ===", steps)
        results[steps] = eval_lidc_uncertainty(dict(params), num_steps=int(steps),
                                               device=device)
        LOGGER.info("steps=%d: samples/sec=%.2f", steps, results[steps]["samples_per_sec"])
    return results

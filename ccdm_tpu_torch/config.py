"""Config defaults (a copy of `ccdm_tpu/config.py`'s `DEFAULTS`,
`with_defaults` and `expanduservars`, without its YAML loading: the port
takes `params` dicts, and only its CLI reads YAML, where PyYAML exists)."""

from __future__ import annotations

import os
from typing import Any, Dict


def expanduservars(path: str) -> str:
    """Expand `~` and `${ENV_VAR}` in a path."""
    return os.path.expanduser(os.path.expandvars(path))

DEFAULTS: Dict[str, Any] = {
    "class_weights": "uniform",
    "beta_schedule": "cosine",
    "beta_schedule_params": None,
    "time_steps": 250,
    "polyak_alpha": 0.9999,
    "backbone": "unet_openai",
    "batch_size": 16,
    "samples": 12,
    "step_T_sample": "majority",
    "feature_cond_encoder": {"type": "none"},
    "compute_dtype": "bfloat16",
}


def with_defaults(params: Dict[str, Any]) -> Dict[str, Any]:
    """`params` over `DEFAULTS`; `step_T_sample` follows a top-level
    `evaluation_vote_strategy` unless it was set explicitly."""
    merged = dict(DEFAULTS)
    merged.update(params or {})
    if merged.get("feature_cond_encoder") is None:
        merged["feature_cond_encoder"] = {"type": "none"}
    if "step_T_sample" not in (params or {}) and "evaluation_vote_strategy" in merged:
        merged["step_T_sample"] = merged["evaluation_vote_strategy"]
    return merged

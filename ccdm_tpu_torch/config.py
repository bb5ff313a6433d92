"""Config defaults (a copy of `ccdm_tpu/config.py`'s `DEFAULTS`,
`with_defaults` and `expanduservars`) and the CLIs' params-file reader: the
port's entry points take `params` dicts; `load_params` reads YAML where
PyYAML is installed (the card's machine has none) and `.json` anywhere."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def load_params(path: str) -> Dict[str, Any]:
    """A params file: `.json` with the standard library, anything else as
    YAML, which needs PyYAML."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    try:
        import yaml
    except ImportError as e:
        raise SystemExit(f"reading {path} needs PyYAML, which is not installed: pass a "
                         f".json file of the same dict") from e
    with open(path) as f:
        return yaml.safe_load(f)


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

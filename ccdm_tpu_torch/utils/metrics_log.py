"""Metrics observability: JSONL event log + optional Weights & Biases (a copy
of `ccdm_tpu/utils/metrics_log.py`).

Parity intent: the reference attaches ignite `WandBLogger` handlers and logs
scalar metrics + image grids when `params['wandb']` is set
(`ddpm/trainer.py:412-430,516-518,529-532`). Here every metric event is
always appended to `<output>/metrics.jsonl` (greppable, plottable, no deps),
and mirrored to wandb when the package is installed and `wandb: yes`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict

LOGGER = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, output_path: str, params: Dict[str, Any]):
        os.makedirs(output_path, exist_ok=True)
        self.path = os.path.join(output_path, "metrics.jsonl")
        self._file = open(self.path, "a")
        self._wandb = None
        if params.get("wandb"):
            try:
                import wandb

                mode = params.get("wandb_mode", "online")
                self._wandb = wandb.init(
                    project=params.get("wandb_project", "ccdm"),
                    mode=mode, config=params)
            except ImportError:
                LOGGER.warning("wandb requested but not installed — JSONL only")

    def log(self, step: int, metrics: Dict[str, Any], tag: str = "train") -> None:
        if self._file.closed:  # e.g. standalone validate() after run()
            self._file = open(self.path, "a")
        event = {"step": int(step), "tag": tag, "time": time.time()}
        event.update({k: (float(v) if hasattr(v, "__float__") else v)
                      for k, v in metrics.items()})
        self._file.write(json.dumps(event) + "\n")
        self._file.flush()
        if self._wandb is not None:
            import wandb

            wandb.log({f"{tag}/{k}": v for k, v in metrics.items()}, step=int(step))

    def log_image(self, step: int, path: str, caption: str = "") -> None:
        if self._wandb is not None:
            import wandb

            wandb.log({"examples": wandb.Image(path, caption=caption)}, step=int(step))

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()

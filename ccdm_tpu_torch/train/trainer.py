"""The training runtime (port of `ccdm_tpu/train/trainer.py`): a plain
step-indexed loop around `train.step.make_train_step`, on one device.

- `run_train(params, max_steps=None, device=None)` is the entry point, with
  the reference's `params.yml` surface; it trains on the CUDA card unless
  the caller passes `device="cpu"`.
- The UNet on the device holds the compute-dtype copy of the fp32 masters
  in `TrainState` (see `train/state.py`); a second UNet module holds the
  EMA (the reference's `average_model`) for validation, written from the
  EMA masters when validation needs it.
- Cadence by `crossed()`: `display_freq` logging, `save_freq` periodic
  checkpoints, `validation_freq` GED/HM-IoU validation and best
  checkpoints.
- Metrics stay on the device and are read two steps later, so the host
  never waits on the step it just queued; an invalid loss (non-finite or
  negative KL) saves `debug_state/` and raises.
- Resume: the epoch and batch position follow from the restored step, and
  `max_epochs` is the total budget. `max_steps` ends with a final save;
  SIGTERM saves and returns. `profile_steps: N` writes a `torch.profiler`
  trace of steps 10 .. 10 + N under `<output_path>/profile`.

Not ported yet, and refused with `NotImplementedError`: DINO feature
conditioning (frozen or trainable) and Cityscapes' mIoU validation (they
come with Cityscapes training), and meshes (multi-host, data parallel).
Qualitative grids are skipped with a warning: they need PIL. Not ported by
decision: `steps_per_launch` (one step a launch; the trajectory is the
same).
"""

from __future__ import annotations

import collections
import copy
import logging
import os
import pprint
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ccdm_tpu_torch.config import expanduservars, with_defaults
from ccdm_tpu_torch.data.loader import EpochLoader, device_prefetch
from ccdm_tpu_torch.data.registry import is_multi_annotator, resolve_dataset_module
from ccdm_tpu_torch.eval.ged_eval import compute_ged, make_batched_sampler
from ccdm_tpu_torch.models.builder import DenoisingModel, build_model
from ccdm_tpu_torch.train.checkpoint import CheckpointManagers, load_checkpoint
from ccdm_tpu_torch.train.optimizer import build_optimizer
from ccdm_tpu_torch.train.state import TrainState, create_train_state, master_params
from ccdm_tpu_torch.train.step import make_train_step, step_seed
from ccdm_tpu_torch.utils.archive import archive_code
from ccdm_tpu_torch.utils.logging import setup_logger
from ccdm_tpu_torch.utils.metrics_log import MetricsLogger
from ccdm_tpu_torch.utils.progress import ProgressLine

LOGGER = logging.getLogger(__name__)

STEP_KEYS = ("image", "x0")  # what the step reads of a batch


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("run_train: no CUDA device; training runs on the card unless "
                               "the caller passes device='cpu'")
        device = "cuda"
    return torch.device(device)


def _class_weights(dataset_module, num_classes: int, device) -> torch.Tensor:
    if hasattr(dataset_module, "get_weights"):
        w = np.asarray(dataset_module.get_weights(), dtype=np.float32)
    else:
        w = np.ones((num_classes,), dtype=np.float32)
    if len(w) != num_classes:
        raise ValueError(f"len(class_weights) != num_classes: {len(w)} != {num_classes}")
    return torch.from_numpy(w).to(device)


def _refuse_unported(params: Dict[str, Any]) -> None:
    fce = params.get("feature_cond_encoder") or {"type": "none"}
    if fce.get("type") not in (None, "none"):
        raise NotImplementedError("training with feature_cond_encoder (DINO conditioning, "
                                  "frozen or trainable) is not ported yet")
    mesh = params.get("mesh") or {}
    if int(mesh.get("data", 1)) > 1 or int(mesh.get("model", 1)) > 1:
        raise NotImplementedError("meshes (data or model parallel training) are not ported")
    if params.get("quantized_inference"):
        raise ValueError("quantized_inference is inference-only; remove it from the "
                         "training config (training always runs the float path)")


class TrainingRun:
    """The live objects of a training run; drives the step loop."""

    def __init__(self, params: Dict[str, Any], device=None):
        params = with_defaults(params)
        self.params = params
        self.device = _device(device)
        _refuse_unported(params)
        self._sigterm = False  # set by the SIGTERM handler, read by the loop
        self.output_path = expanduservars(params.get("output_path", "./logs/run"))
        os.makedirs(self.output_path, exist_ok=True)
        archive_code(self.output_path)
        LOGGER.info("experiment dir: %s", self.output_path)
        LOGGER.info("Training params:\n%s", pprint.pformat(params))

        self.module = resolve_dataset_module(params["dataset_file"])
        if not is_multi_annotator(self.module, params["dataset_file"]):
            raise NotImplementedError("mIoU validation (single-annotator datasets such as "
                                      "Cityscapes) is not ported yet")
        self.train_ds = self.module.training_dataset()
        self.val_ds = self.module.validation_dataset(
            max_size=params.get("dataset_val_max_size", 100))
        LOGGER.info("%d train / %d val images in %s", len(self.train_ds), len(self.val_ds),
                    params["dataset_file"])
        self.num_classes = self.module.get_num_classes()
        image_shape = self.train_ds.get(0, np.random.default_rng(0))["image"].shape

        seed = int(params.get("seed", 0))
        self.seed = seed
        # image_size = min(H, W) selects the channel_mult table; the masters
        # are drawn in fp32 and the compute-dtype module is loaded from them
        build = dict(num_classes=self.num_classes, image_channels=image_shape[-1],
                     image_size=min(image_shape[:2]), device=self.device)
        self.model: DenoisingModel = build_model(
            params, **build, generator=torch.Generator().manual_seed(seed))
        self.net = self.model.unet
        if next(self.net.parameters()).dtype == torch.float32:
            masters = master_params(self.net)
        else:
            fp32 = build_model(dict(params, compute_dtype="float32"), **build,
                               generator=torch.Generator().manual_seed(seed))
            masters = master_params(fp32.unet)
            with torch.no_grad():
                for name, p in self.net.named_parameters():
                    p.copy_(masters[name])
        self.ema_net = copy.deepcopy(self.net).eval()
        LOGGER.info("UNet parameters: %.3fM", sum(p.numel() for p in masters.values()) / 1e6)
        if int(params.get("steps_per_launch", 1)) > 1:
            LOGGER.info("steps_per_launch is not ported (one step a launch; the "
                        "trajectory is the same)")

        self.batch_size = int(params["batch_size"])
        self.loader = EpochLoader(self.train_ds, self.batch_size, seed=seed,
                                  num_workers=int(params.get("mp_loaders", 0)))
        self.steps_per_epoch = len(self.loader)
        if self.steps_per_epoch == 0:
            raise ValueError(f"batch_size {self.batch_size} exceeds the training set "
                             f"({len(self.train_ds)} images): zero steps per epoch")
        tx, self.lr_schedule = build_optimizer(params, self.steps_per_epoch)
        self.state: TrainState = create_train_state(
            masters, tx, polyak_alpha=float(params["polyak_alpha"]))
        self.checkpoints = CheckpointManagers(self.output_path)
        self.metrics = MetricsLogger(self.output_path, params)
        load_from = params.get("load_from")
        if load_from:
            LOGGER.info("resuming from %s", load_from)
            load_checkpoint(expanduservars(load_from), self.state)
            self.state.write_to(self.net)
        self.step_fn = make_train_step(
            self.model, _class_weights(self.module, self.num_classes, self.device),
            self.lr_schedule)
        self._samplers = {}  # num_samples -> batched sampler
        self._ema_step = None  # the step whose EMA `ema_net` holds

    # ---- validation ------------------------------------------------------

    def ema_unet(self) -> torch.nn.Module:
        """The EMA UNet module, written from the EMA masters once a step."""
        if self._ema_step != self.state.step:
            self.state.write_to(self.ema_net, ema=True)
            self._ema_step = self.state.step
        return self.ema_net

    def validate(self) -> Dict[str, float]:
        params = self.params
        num_samples = int(params.get("samples", 12))
        if num_samples not in self._samplers:
            self._samplers[num_samples] = make_batched_sampler(self.model, num_samples)
        generator = torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed + 2, self.state.step))
        ged, div, hmiou = compute_ged(
            self.model, self.ema_unet(), self.val_ds, num_samples,
            max(1, self.batch_size // num_samples), generator,
            max_batches=int(params.get("validation_max_batches", 0)) or None,
            sampler=self._samplers[num_samples])
        LOGGER.info("mean GED %.3f, mean diversity %.3f, HM-IoU %.3f", ged, div, hmiou)
        metrics = {"GED": ged, "diversity": div, "HMIoU": hmiou}
        self.metrics.log(self.state.step, metrics, tag="val")
        self.checkpoints.save_best("ged", self.state, ged)
        self.checkpoints.save_best("hmiou", self.state, hmiou)
        LOGGER.warning("qualitative grids are not ported (utils/visualize.py needs PIL)")
        return metrics

    # ---- the loop ----------------------------------------------------------

    def _on_sigterm(self, signum, frame):
        # only a flag: the step loop saves and returns at the next step
        self._sigterm = True

    def run(self, max_steps: Optional[int] = None) -> TrainState:
        self._profiler = None
        prev_handler: Any = self  # sentinel: "handler not installed"
        try:
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:  # not the main thread: no graceful-preempt path
            pass
        try:
            return self._run_impl(max_steps)
        finally:
            if prev_handler is not self:
                signal.signal(signal.SIGTERM, prev_handler)
            if self._profiler is not None:
                self._profiler.stop()
                self._profiler = None
            self.metrics.close()

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = os.path.join(self.output_path, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        self._profiler = None
        LOGGER.info("profiler trace written to %s/profile", self.output_path)

    def _run_impl(self, max_steps: Optional[int] = None) -> TrainState:
        p = self.params
        max_epochs = int(p.get("max_epochs", 1))
        display_freq = int(p.get("display_freq", 500))
        save_freq = int(p.get("save_freq", 1000))
        validation_freq = int(p.get("validation_freq", 5000))
        profile_steps = int(p.get("profile_steps", 0))  # trace N steps from step 10

        pending = collections.deque()  # (step, metrics on the device)
        recent_batches = collections.deque(maxlen=4)  # for the debug dump
        window_items, window_t0 = 0, time.perf_counter()
        progress = ProgressLine(enable=bool(p.get("progress_bar", True)))
        last_loss: Optional[float] = None

        def drain(block_all: bool = False):
            nonlocal last_loss
            while pending and (block_all or len(pending) > 2):
                s, m = pending.popleft()
                if bool(m["invalid"]):
                    progress.close()
                    LOGGER.error("invalid loss at step %d — saving debug state", s)
                    extras = dict(next((b for bs, b in recent_batches if bs == s), {}))
                    extras["loss"] = m["loss"]
                    self.checkpoints.save_debug(self.state, extras)
                    raise ValueError(f"Invalid loss (nan/inf/neg-KL) at step {s}")
                last_loss = float(m["loss"])

        step0 = self.state.step
        total = 0
        spe = self.steps_per_epoch
        start_epoch, skip0 = step0 // spe, step0 % spe
        if step0:
            LOGGER.info("resume position: step %d = epoch %d, batch %d/%d",
                        step0, start_epoch, skip0, spe)
        epoch = start_epoch - 1
        while True:
            epoch += 1
            # max_epochs is the budget unless an explicit max_steps drives the loop
            if max_steps is None and epoch >= max_epochs:
                break
            raw = self.loader.epoch(epoch, start_batch=skip0 if epoch == start_epoch else 0)
            batches = ({k: b[k] for k in STEP_KEYS} for b in raw)
            for batch in device_prefetch(batches, self.device):
                if profile_steps and total == 10 and self._profiler is None:
                    self._start_profile()
                metrics = self.step_fn(self.state, self.net, batch, self.seed + 1)
                total += 1
                step = step0 + total
                pending.append((step, metrics))
                recent_batches.append((step, batch))
                if self._profiler is not None and total >= 10 + profile_steps:
                    self._stop_profile()
                window_items += self.batch_size
                prev = step - 1

                def crossed(freq):
                    return (prev // freq) != (step // freq)

                progress.update(epoch=epoch, step=step, steps_per_epoch=spe,
                                items_done=total * self.batch_size, loss=last_loss)
                if crossed(display_freq):
                    drain(block_all=True)
                    progress.close()
                    dt = time.perf_counter() - window_t0
                    speed = window_items / max(dt, 1e-9)
                    mem_gb = (torch.cuda.memory_allocated(self.device) / 1e9
                              if self.device.type == "cuda" else 0.0)
                    LOGGER.info("epoch=%d, iter=%d, speed=%.2f img/s, loss=%.4g, lr=%.6g, "
                                "mem=%.2fGB", epoch, step, speed, last_loss,
                                metrics.get("lr", 0.0), mem_gb)
                    self.metrics.log(step, {"loss": last_loss, "lr": metrics.get("lr", 0.0),
                                            "imgs_per_sec": speed, "mem_gb": mem_gb},
                                     tag="train")
                    window_items, window_t0 = 0, time.perf_counter()
                else:
                    drain()
                if crossed(save_freq):
                    drain(block_all=True)
                    self.checkpoints.save_periodic(self.state)
                if crossed(validation_freq):
                    drain(block_all=True)
                    progress.close()
                    self.validate()
                    progress.reset_rate_window(total * self.batch_size)
                if self._sigterm:
                    drain(block_all=True)
                    progress.close()
                    self.checkpoints.save_periodic(self.state)
                    LOGGER.warning("preemption notice — state saved at step %d under %s; "
                                   "rerun with load_from to resume the remaining budget",
                                   step, self.output_path)
                    return self.state
                if max_steps is not None and total >= max_steps:
                    drain(block_all=True)
                    progress.close()
                    # the early exit is a run end too: persist the final state
                    self.checkpoints.save_periodic(self.state)
                    return self.state
            drain(block_all=True)
        progress.close()
        self.checkpoints.save_periodic(self.state)
        return self.state


def run_train(params: Dict[str, Any], max_steps: Optional[int] = None,
              device=None) -> TrainState:
    """Train from a reference-format `params` dict, on the CUDA card unless
    `device` says otherwise."""
    setup_logger()
    return TrainingRun(params, device=device).run(max_steps=max_steps)

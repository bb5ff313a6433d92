"""The training runtime (port of `ccdm_tpu/train/trainer.py`): a plain
step-indexed loop around `train.step.make_train_step`, on one device or
over a `data x model` grid of ranks, one process per card.

- `run_train(params, max_steps=None, device=None)` is the entry point, with
  the reference's `params.yml` surface; it trains on the CUDA card unless
  the caller passes `device="cpu"`.
- The UNet on the device holds the compute-dtype copy of the fp32 masters
  in `TrainState` (see `train/state.py`); a second UNet module holds the
  EMA (the reference's `average_model`) for validation, written from the
  EMA masters when validation needs it.
- Datasets: a module whose `training_dataset` / `validation_dataset` take
  `params` gets them (Cityscapes builds its transform pipelines from them).
- DINO conditioning (`feature_cond_encoder.type: dino`): frozen (`train:
  no`), the encoder's weights live outside the state, are neither
  optimised nor checkpointed, and the step maps the images without
  autograd; trainable (`train: yes`), the encoder's masters join the UNet's
  in one composite state, optimised and averaged jointly and checkpointed
  under `feature_cond_encoder` / `average_feature_cond_encoder`, and a
  second encoder module holds the EMA for validation.
- Cadence by `crossed()`: `display_freq` logging, `save_freq` periodic
  checkpoints, `validation_freq` validation (GED/HM-IoU on multi-annotator
  sets, mIoU on single-annotator ones such as Cityscapes, each with its
  best checkpoints) and a qualitative grid (`images_<step>.png`), whose
  failure only warns.
- Launches, as the JAX trainer's: `steps_per_launch: K` groups an epoch's
  batches into launches of K steps (`train.step.make_multi_step`), the
  epoch's tail (`remaining % K`) as launches of one, a mid-epoch resume
  grouping the remaining batches; the trajectory is K = 1's, bit for bit.
  On the card each step is a replay of a CUDA graph of it
  (`train.step.GraphedTrainStep`, captured once after warm-up steps), so the
  host steps in once a launch; the CPU runs the eager step. The cadence,
  the preemption check and `max_steps` act at launch boundaries: an event
  fires at the launch that crosses its multiple, and `max_steps` stops at
  the first boundary at or past it.
- Metrics stay on the device and are read two launches later, so the host
  never waits on the launch it just queued; an invalid loss (non-finite or
  negative KL) saves `debug_state/` (with the launch's batches) and raises.
- Resume: the epoch and batch position follow from the restored step, and
  `max_epochs` is the total budget. `max_steps` ends with a final save;
  SIGTERM saves and returns at the end of the launch. `profile_steps: N`
  writes a `torch.profiler` trace of steps 10 .. 10 + N (whole launches)
  under `<output_path>/profile` (rank 0's only: the other ranks run
  untraced).

Data parallel (`parallel/mesh.py`; `cli/train.py --multihost` under
torchrun): every rank builds the same masters from the seed (or loads the
same checkpoint, written at any world size), takes its rows of each global
batch from the sharded `EpochLoader`, and the step sums the gradients over
the ranks, so the ranks stay equal. Rank 0 does the I/O: the code archive,
`metrics.jsonl`, the progress line, the grids, the profiler trace and the
checkpoints, which the others wait for at a barrier. Validation is sliced by rank (each rank
samples its strided share of the images) and combined with one float64
allgather; the scores that choose a best checkpoint are rank 0's,
broadcast. A SIGTERM on any rank stops every rank at the same step (a max
over the ranks at each launch boundary), and they save together.

`mesh: {data: d, model: m}` lays the ranks out as the JAX trainer's mesh
(`parallel/mesh.py`; `data` defaults to the world size over `model`), and
`d * m` must equal the world size. With `m > 1` the UNet (and a trainable
encoder) keeps each rank's share of the leaves the model axis splits
(`parallel/tensor.py`), and so does the state; the loader shards the data
by data index, so a model group's ranks take the same rows. Validation and
the eval paths sample with the whole EMA, gathered on every rank, and keep
their slicing by rank, as the JAX trainer's multi-process validation
copies its sharded EMA out of the mesh. The split layers' forward holds
collectives, which a CUDA graph under gloo cannot capture, so the step
runs eagerly there (logged once).
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
from ccdm_tpu_torch.eval.metrics import ConfusionMatrix
from ccdm_tpu_torch.models.builder import DenoisingModel, build_model
from ccdm_tpu_torch.models.dino import DinoFeatureEncoder
from ccdm_tpu_torch.parallel import mesh
from ccdm_tpu_torch.parallel.tensor import Sharding, shard_modules
from ccdm_tpu_torch.train.checkpoint import CheckpointManagers, load_checkpoint
from ccdm_tpu_torch.train.optimizer import build_optimizer
from ccdm_tpu_torch.train.state import (
    ENCODER,
    UNET,
    TrainState,
    create_train_state,
    master_params,
    prefixed,
)
from ccdm_tpu_torch.train.step import (
    GraphedTrainStep,
    make_multi_step,
    make_train_step,
    step_seed,
)
from ccdm_tpu_torch.utils.archive import archive_code
from ccdm_tpu_torch.utils.logging import setup_logger
from ccdm_tpu_torch.utils.metrics_log import MetricsLogger
from ccdm_tpu_torch.utils.progress import ProgressLine
from ccdm_tpu_torch.utils.visualize import prediction_grid, save_grid

LOGGER = logging.getLogger(__name__)

STEP_KEYS = ("image", "x0")  # what the step reads of a batch


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("run_train: no CUDA device; training runs on the card unless "
                               "the caller passes device='cpu'")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _class_weights(dataset_module, num_classes: int, device) -> torch.Tensor:
    if hasattr(dataset_module, "get_weights"):
        w = np.asarray(dataset_module.get_weights(), dtype=np.float32)
    else:
        w = np.ones((num_classes,), dtype=np.float32)
    if len(w) != num_classes:
        raise ValueError(f"len(class_weights) != num_classes: {len(w)} != {num_classes}")
    return torch.from_numpy(w).to(device)


def _accepts_param(fn, name: str) -> bool:
    """Whether `fn` takes a parameter called `name` (dataset-module protocol
    dispatch by signature: catching TypeError instead would also swallow
    one raised inside the dataset's constructor)."""
    import inspect

    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins and extension functions
        return True


def _build_datasets(params: Dict[str, Any]):
    """The dataset module and its training and validation sets; a module
    whose constructors take `params` gets them (Cityscapes builds its
    transform pipelines from them)."""
    module = resolve_dataset_module(params["dataset_file"])
    if _accepts_param(module.training_dataset, "params"):
        train_ds = module.training_dataset(params)
    else:
        train_ds = module.training_dataset()
    val_max = params.get("dataset_val_max_size", 100)
    if _accepts_param(module.validation_dataset, "params"):
        val_ds = module.validation_dataset(max_size=val_max, params=params)
    else:
        val_ds = module.validation_dataset(max_size=val_max)
    LOGGER.info("%d train / %d val images in %s", len(train_ds), len(val_ds),
                params["dataset_file"])
    return module, train_ds, val_ds


def _mesh_config(params: Dict[str, Any]) -> mesh.MeshConfig:
    """The `mesh` of `params` (`data` defaults to the world size over
    `model`), refusing what the port does not run."""
    layout = params.get("mesh") or {}
    model = int(layout.get("model", 1))
    data = int(layout.get("data", mesh.process_count() // max(model, 1)))
    if params.get("quantized_inference"):
        raise ValueError("quantized_inference is inference-only; remove it from the "
                         "training config (training always runs the float path)")
    return mesh.MeshConfig(data=data, model=model)


class TrainingRun:
    """The live objects of a training run; drives the step loop."""

    def __init__(self, params: Dict[str, Any], device=None):
        params = with_defaults(params)
        self.params = params
        self.device = _device(device)
        self.mesh = mesh.make_mesh(_mesh_config(params))
        self.is_main = mesh.process_index() == 0
        self._sigterm = False  # set by the SIGTERM handler, read by the loop
        self.output_path = expanduservars(params.get("output_path", "./logs/run"))
        os.makedirs(self.output_path, exist_ok=True)
        if self.is_main:
            archive_code(self.output_path)
        LOGGER.info("rank %d of %d on %s; mesh data %d x model %d", mesh.process_index(),
                    mesh.process_count(), self.device, self.mesh.data_count,
                    self.mesh.model_count)
        LOGGER.info("experiment dir: %s", self.output_path)
        LOGGER.info("Training params:\n%s", pprint.pformat(params))

        self.module, self.train_ds, self.val_ds = _build_datasets(params)
        self.num_classes = self.module.get_num_classes()
        self.ignore_class = self.module.get_ignore_class()
        image_shape = self.train_ds.get(0, np.random.default_rng(0))["image"].shape

        seed = int(params.get("seed", 0))
        self.seed = seed
        self._build_encoder(params["feature_cond_encoder"])
        # image_size = min(H, W) selects the channel_mult table; the masters
        # are drawn in fp32 and the compute-dtype module is loaded from them
        build = dict(num_classes=self.num_classes, image_channels=image_shape[-1],
                     image_size=min(image_shape[:2]), device=self.device)
        self.model: DenoisingModel = build_model(
            params, **build, generator=torch.Generator().manual_seed(seed))
        self.net = self.model.unet
        whole = None  # the fp32 masters of a compute-dtype module, whole
        if next(self.net.parameters()).dtype != torch.float32:
            fp32 = build_model(dict(params, compute_dtype="float32"), **build,
                               generator=torch.Generator().manual_seed(seed))
            whole = master_params(fp32.unet)
            with torch.no_grad():
                for name, p in self.net.named_parameters():
                    p.copy_(whole[name])
        # the EMA modules hold every leaf whole; the trained ones this rank's
        # shares of the leaves the model axis splits
        self.ema_net = copy.deepcopy(self.net).eval()
        self._prefix = UNET if self.trainable_encoder else ""
        split = shard_modules(self.net, self.mesh, self._prefix)
        self.sharding = Sharding(split, self.mesh)
        masters = master_params(self.net) if whole is None else {
            name: self.sharding.share(self._prefix + name, v) for name, v in whole.items()}
        LOGGER.info("UNet parameters: %.3fM",
                    sum(p.numel() for p in self.ema_net.parameters()) / 1e6)
        # a trainable encoder's masters are its fp32 parameters themselves
        if self.trainable_encoder:
            self.ema_encoder = copy.deepcopy(self.encoder_net).requires_grad_(False)
            split.update(shard_modules(self.encoder_net, self.mesh, ENCODER))
            masters = {**prefixed(UNET, masters),
                       **prefixed(ENCODER, master_params(self.encoder_net))}
        if split:
            LOGGER.info("model axis: %d leaves split over %d ranks", len(split),
                        self.mesh.model_count)
        self.steps_per_launch = max(1, int(params.get("steps_per_launch", 1)))

        self.batch_size = int(params["batch_size"])
        # each rank loads its rows p::P of every global batch; with P > 1 an
        # epoch is trimmed to whole global batches, the same count on every rank
        self.loader = EpochLoader(self.train_ds, self.batch_size, seed=seed,
                                  process_index=self.mesh.data_index,
                                  process_count=self.mesh.data_count,
                                  num_workers=int(params.get("mp_loaders", 0)))
        self.steps_per_epoch = len(self.loader)
        if self.steps_per_epoch == 0:
            raise ValueError(f"batch_size {self.batch_size} exceeds the training set "
                             f"({len(self.train_ds)} images): zero steps per epoch")
        tx, self.lr_schedule = build_optimizer(params, self.steps_per_epoch)
        self.state: TrainState = create_train_state(
            masters, tx, polyak_alpha=float(params["polyak_alpha"]), sharding=self.sharding)
        self.checkpoints = CheckpointManagers(self.output_path)
        self.metrics = MetricsLogger(self.output_path, params) if self.is_main else None
        load_from = params.get("load_from")
        if load_from:
            LOGGER.info("resuming from %s", load_from)
            load_checkpoint(expanduservars(load_from), self.state)
            self.state.write_to(self.net, prefix=self._prefix)
        step = make_train_step(
            self.model, _class_weights(self.module, self.num_classes, self.device),
            self.lr_schedule,
            feature_fn=None if self.trainable_encoder else self.encoder,
            encoder_apply=self.encoder if self.trainable_encoder else None,
            sharding=self.sharding)
        # on the card a step is a replay of a CUDA graph of it, except over a
        # model axis, whose split layers hold collectives in the forward
        self.step_fn = step
        if self.device.type == "cuda" and self.mesh.model_count > 1:
            LOGGER.info("model axis: the step runs eagerly (its forward holds collectives, "
                        "which a CUDA graph under gloo cannot capture)")
        elif self.device.type == "cuda":
            self.step_fn = GraphedTrainStep(step)
        self._samplers = {}  # (num_samples, num_steps) -> batched sampler
        self._ema_step = None  # the step whose EMA `ema_net` holds

    def _build_encoder(self, fce: Dict[str, Any]) -> None:
        """The DINO encoder of `feature_cond_encoder` (None without one):
        seed-7 random weights unless `weights:` names a converted `.npz`."""
        self.encoder = self.encoder_net = self.ema_encoder = None
        self.trainable_encoder = False
        if fce.get("type") in (None, "none"):
            return
        if fce.get("type") != "dino":
            raise NotImplementedError(f"feature_cond_encoder {fce.get('type')!r} is not ported")
        self.encoder = DinoFeatureEncoder(fce)
        self.encoder_net = self.encoder.init(torch.Generator().manual_seed(7), self.device)
        if fce.get("weights"):
            self.encoder.load_pretrained(self.encoder_net, expanduservars(fce["weights"]))
        else:
            LOGGER.warning("DINO conditioning with RANDOM weights: provide "
                           "feature_cond_encoder.weights (a converted .npz)")
        self.trainable_encoder = self.encoder.trainable
        LOGGER.info("DINO feature conditioning: %s stride=%d ch=%d train=%s", self.encoder.name,
                    self.encoder.stride, self.encoder.channels, self.trainable_encoder)

    # ---- validation ------------------------------------------------------

    def ema_unet(self) -> torch.nn.Module:
        """The EMA UNet module (and the EMA encoder's, when it trains),
        written from the EMA masters once a step."""
        if self._ema_step != self.state.step:
            self.state.write_to(self.ema_net, ema=True, prefix=self._prefix)
            if self.trainable_encoder:
                self.state.write_to(self.ema_encoder, ema=True, prefix=ENCODER)
            self._ema_step = self.state.step
        return self.ema_net

    def _val_feature_net(self) -> Optional[torch.nn.Module]:
        """The encoder that validation samples with: the EMA encoder when it
        trains (written by `ema_unet`), else the frozen one."""
        return self.ema_encoder if self.trainable_encoder else self.encoder_net

    def validate(self) -> Dict[str, float]:
        params = self.params
        if is_multi_annotator(self.module, params["dataset_file"]):
            num_samples = int(params.get("samples", 12))
            ged, div, hmiou = compute_ged(
                self.model, self.ema_unet(), self.val_ds, num_samples,
                max(1, self.batch_size // num_samples), step_seed(self.seed + 2, self.state.step),
                max_batches=int(params.get("validation_max_batches", 0)) or None,
                sampler=self._sampler(num_samples), feature_net=self._val_feature_net())
            # every rank decides on the best checkpoints from rank 0's scores
            ged, div, hmiou = mesh.broadcast_from_main(ged, div, hmiou)
            LOGGER.info("mean GED %.3f, mean diversity %.3f, HM-IoU %.3f", ged, div, hmiou)
            metrics = {"GED": ged, "diversity": div, "HMIoU": hmiou}
            if self.is_main:
                self.metrics.log(self.state.step, metrics, tag="val")
            self.checkpoints.save_best("ged", self.state, ged)
            self.checkpoints.save_best("hmiou", self.state, hmiou)
            return metrics
        # val mIoU picks the best checkpoints; a pass over 6 train images is
        # only logged (the reference's engine_train mIoU)
        miou, train_miou = mesh.broadcast_from_main(
            self.validate_miou(), self.validate_miou(max_images=6, dataset=self.train_ds))
        LOGGER.info("val mIoU: %.4f (train-split mIoU: %.4f)", miou, train_miou)
        metrics = {"mIoU": miou, "mIoU_train": train_miou}
        if self.is_main:
            self.metrics.log(self.state.step, metrics, tag="val")
        self.checkpoints.save_best("miou", self.state, miou)
        return metrics

    def validate_miou(self, max_images: Optional[int] = 16, dataset=None) -> float:
        """The confusion-matrix mIoU of one EMA sample an image over the
        first `max_images` of `dataset` (default: the val split), in batches
        of `max(1, min(batch_size // 4, n))`. Image i reads with
        `default_rng(1000 + i)` (a train-split sample's augmentation) and
        samples from the streams of its index. The truth is the first expert
        mask, else `label`, else `argmax x0`; the prediction's argmax
        spans every channel, the ignore class included, as the reference's
        in-training matrix (only the reported IoUs drop that class). In a
        process group each rank samples its strided share of the images
        (the tail padded to the batch, the padding left out of the matrix)
        and one float64 allgather sums the matrices: the same mIoU for any
        number of ranks."""
        ds = self.val_ds if dataset is None else dataset
        n = min(len(ds), max_images or len(ds))
        if n == 0:
            return float("nan")
        sampler = self._sampler(1)
        cm = ConfusionMatrix(self.num_classes, self.ignore_class)
        bs = max(1, min(self.batch_size // 4, n))
        ema, key = self.ema_unet(), step_seed(self.seed + 2, self.state.step)
        mine = mesh.host_slice(n)
        for start in range(0, len(mine), bs):
            idx, real = mesh.pad_chunk(mine[start:start + bs], bs)
            samples = [ds.get(i, np.random.default_rng(1000 + i)) for i in idx]
            images = torch.from_numpy(np.stack([s["image"] for s in samples])).to(self.device)
            if "labels" in samples[0]:  # multi-annotator protocol
                true = np.argmax(np.stack([s["labels"][0] for s in samples]), -1)
            elif "label" in samples[0]:
                true = np.stack([s["label"] for s in samples])
            else:  # a training sample: one-hot x0
                true = np.argmax(np.stack([s["x0"] for s in samples]), -1)
            preds = sampler(ema, images, key, idx, feature_net=self._val_feature_net())
            cm.update(preds[:real, 0], torch.from_numpy(true[:real]).to(preds.device))
        if mesh.process_count() > 1:
            cm.matrix = mesh.allgather_f64(cm.matrix).sum(axis=0).reshape(
                cm.matrix.shape).astype(cm.matrix.dtype)
        return cm.miou()

    def _sampler(self, num_samples: int, num_steps: Optional[int] = None):
        """The batched sampler of `num_samples` samples, built once per
        `(num_samples, num_steps)` and conditioned on the run's encoder."""
        key = (num_samples, num_steps)
        if key not in self._samplers:
            self._samplers[key] = make_batched_sampler(self.model, num_samples, num_steps,
                                                       feature_fn=self.encoder)
        return self._samplers[key]

    def save_qualitative(self) -> str:
        """A grid of `n_validation_images` validation images, each with its
        label (or first expert mask) and `n_validation_predictions` samples
        of the EMA model, written to `<output_path>/images_<step>.png`."""
        p = self.params
        n = min(int(p.get("n_validation_images", 3)), len(self.val_ds))
        samples = [self.val_ds.get(i) for i in range(n)]
        images = np.stack([s["image"] for s in samples])
        if "labels" in samples[0]:
            labels = np.argmax(np.stack([s["labels"][0] for s in samples]), -1)
        else:
            labels = np.stack([s["label"] for s in samples])
        preds = self._sampler(int(p.get("n_validation_predictions", 3)))(
            self.ema_unet(), torch.from_numpy(images).to(self.device), step_seed(self.seed, 123),
            feature_net=self._val_feature_net())
        grid = prediction_grid(images, labels, preds.cpu().numpy(), self.num_classes)
        return save_grid(grid, os.path.join(self.output_path,
                                            f"images_{self.state.step:06d}.png"))

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
            if self.metrics is not None:
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

    def _launch(self, batches) -> Dict[str, Any]:
        """One launch: a step of one batch, or `make_multi_step` over K."""
        if len(batches) == 1:
            return self.step_fn(self.state, self.net, batches[0], self.seed + 1,
                                self.encoder_net)
        return make_multi_step(self.step_fn)(self.state, self.net, batches, self.seed + 1,
                                             self.encoder_net)

    def _run_impl(self, max_steps: Optional[int] = None) -> TrainState:
        p = self.params
        max_epochs = int(p.get("max_epochs", 1))
        display_freq = int(p.get("display_freq", 500))
        save_freq = int(p.get("save_freq", 1000))
        validation_freq = int(p.get("validation_freq", 5000))
        profile_steps = int(p.get("profile_steps", 0))  # trace N steps from step 10
        k_launch = self.steps_per_launch

        pending = collections.deque()  # (launch's last step, metrics on the device)
        recent_batches = collections.deque(maxlen=4)  # (step, the launch's batches)
        window_items, window_t0 = 0, time.perf_counter()
        progress = ProgressLine(enable=bool(p.get("progress_bar", True)) and self.is_main)
        last_loss: Optional[float] = None
        profiled = False

        def drain(block_all: bool = False):
            nonlocal last_loss
            while pending and (block_all or len(pending) > 2):
                s, m = pending.popleft()
                if bool(m["invalid"]):
                    progress.close()
                    LOGGER.error("invalid loss at step %d — saving debug state", s)
                    group = next((b for bs, b in recent_batches if bs == s), [{}])
                    # a launch of K steps dumps its batches stacked [K, B, ...]
                    extras = dict(group[0]) if len(group) == 1 else {
                        k: torch.stack([b[k] for b in group]) for k in group[0]}
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
            skip = skip0 if epoch == start_epoch else 0
            raw = self.loader.epoch(epoch, start_batch=skip)
            batches = device_prefetch(({k: b[k] for k in STEP_KEYS} for b in raw), self.device,
                                      buffer_size=k_launch + 1)
            for group in launch_groups(batches, spe - skip, k_launch):
                if profile_steps and self.is_main and total >= 10 and not profiled:
                    self._start_profile()
                    profiled = True
                metrics = self._launch(group)
                total += len(group)
                step = step0 + total
                pending.append((step, metrics))
                recent_batches.append((step, group))
                if self._profiler is not None and total >= 10 + profile_steps:
                    self._stop_profile()
                window_items += self.batch_size * len(group)
                prev = step - len(group)

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
                    if self.is_main:
                        self.metrics.log(step, {"loss": last_loss,
                                                "lr": metrics.get("lr", 0.0),
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
                    if self.is_main:
                        try:
                            png = self.save_qualitative()
                            self.metrics.log_image(step, png, f"iteration {step}")
                        except Exception as e:  # a grid is not worth a run
                            LOGGER.warning("qualitative grid failed: %s", e)
                # the ranks stop at the same launch: the flag of any rank
                if mesh.any_rank(self._sigterm):
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


def launch_groups(batches, count: int, k: int):
    """The launches of an epoch's `count` remaining batches (as the JAX
    trainer groups them, `ccdm_tpu/train/trainer.py`): whole groups of `k`,
    then the tail, `count % k`, one batch a launch. Lists of batches."""
    it = iter(batches)
    for _ in range(count // k):
        yield [next(it) for _ in range(k)]
    for batch in it:
        yield [batch]


def run_train(params: Dict[str, Any], max_steps: Optional[int] = None,
              device=None) -> TrainState:
    """Train from a reference-format `params` dict, on the CUDA card unless
    `device` says otherwise."""
    setup_logger()
    return TrainingRun(params, device=device).run(max_steps=max_steps)

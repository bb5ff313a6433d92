"""LIDC uncertainty evaluation (port of `ccdm_tpu/eval/lidc_uncertainty.py`).

- `make_prob_sampler`: the batched multi-sample generation that the LIDC
  harness, the Cityscapes evaluator, the trainer's validation and the
  benchmark call. Every (image, sample) pair draws its prior and chain
  noise from its own stream, keyed on `index * S + sample` with `indices`
  the GLOBAL dataset positions (`diffusion/random.py`), so an image's
  samples do not depend on the batch size or the batch's composition.
- `eval_lidc_uncertainty`, the harness: per test image `max(evaluations)`
  samples in one batched sampler call; GED, sample and expert diversity
  and HM-IoU at every sample count; the confusion matrix of the mean
  log-probability prediction against every non-empty expert mask; the
  steady-state samples/s; the results JSON in `evaluation_path`. In a
  process group each rank scores its strided share of the test images and
  one float64 allgather combines the partial sums (`parallel/mesh.py`): the
  results do not depend on the number of ranks; rank 0 writes the JSON.
- `load_eval_params`, the EMA weights of a checkpoint (`load_from`), and
  `build_eval_feature_fn`, the DINO conditioning of an eval config.

`quantized_inference: static` calibrates the int8 activation scales on the
first `min(n, 2)` test images after the weights load, as the JAX harness
does, and samples with the calibrated model; `yes` samples with dynamic
scales.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ccdm_tpu_torch.config import expanduservars, with_defaults
from ccdm_tpu_torch.diffusion import random
from ccdm_tpu_torch.diffusion.sampling import (
    GraphedSampler,
    ReverseStep,
    SamplerConfig,
    _resolve_state,
    ancestral_sampler,
    sample_prior_per_key,
    subsampled_t_values,
)
from ccdm_tpu_torch.models.builder import DenoisingModel
from ccdm_tpu_torch.ops import quant
from ccdm_tpu_torch.ops.precision import fp32_precision
from ccdm_tpu_torch.parallel import mesh
from ccdm_tpu_torch.parallel.tensor import is_split
from ccdm_tpu_torch.parallel.mesh import pad_chunk  # noqa: F401  (re-exported)
from ccdm_tpu_torch.utils import trace

LOGGER = logging.getLogger(__name__)


def make_prob_sampler(model: DenoisingModel, num_samples: int,
                      num_steps: Optional[int] = None, feature_fn=None,
                      encoder_reuse: int = 1, graphs: bool = True):
    """`(net, images [B,H,W,Ci], key=0, indices=None) -> probs [B,S,H,W,C]`.

    Each image is repeated S times, image-major (as `jnp.repeat`), the prior
    is drawn, and the ancestral sampler runs under `torch.inference_mode()`
    with the model's `step_T_sample` mode for the final step ("confidence"
    yields probability maps). `net` is the module holding the weights (the
    JAX version's `params`); each call holds its float convs' weights
    channels-last (`UNetModel.lay_out_weights`, in place, once), so that
    the UNet's inference torso runs channels-last.

    On the card the reverse process replays CUDA graphs of its step
    (`diffusion/sampling.GraphedSampler`, the JAX version's `lax.scan`
    inside `jax.jit`), cached per shape and weights, bit-equal to the eager
    loop where the card repeats its sums. The eager loop
    (`ancestral_sampler`) runs on the CPU, for injected noise, for a net
    whose layers are split over a model axis (`parallel/tensor.py`: their
    forwards hold collectives, which no capture permits; logged), for a
    net whose int8 sites are recording (a calibration), and with
    `graphs=False`. The run's `graphed` attribute is the `GraphedSampler`
    (None with `graphs=False`), whose counts say what was captured and
    replayed. A capture that fails raises.

    Noise: `key` is the run's integer seed; element `index * S + sample`,
    with `indices` `[B]` the images' global dataset positions (default
    `arange(B)`), draws its prior from `random.element_keys(key, ids,
    PRIOR)` and its chain from `(key, ids, CHAIN)`. For the tests, `prior`
    `[B·S,H,W,C]` and the chain noise (`gumbel` `[K,B·S,H,W,C]` in the
    one-hot state, `uniforms` `[K,B·S,H,W]` in the index state) inject the
    noise the JAX sampler drew instead.

    `feature_fn(feature_net, images)` gives the DINO map of the B images,
    once, in fp32 whatever the process's TF32 settings (as the train step
    and the calibration compute it), which is then repeated S times;
    `feature_net` (the encoder's weights, the JAX version's
    `feature_params`) is passed to each call. The prior, the keys and the
    conditioning are made for each call outside the graphs.
    `encoder_reuse` R > 1 replays the UNet encoder's activations on the
    steps between every R-th.

    Spans (`utils/trace.py`): `sampler.call` around each call, with the
    children `sampler.conditioning` (with `dino.features`, between two
    device marks), `sampler.prior` (the prior and the chain keys) and the
    steps: `sampler.steps` around the eager loop, or `GraphedSampler`'s.
    """
    cfg = SamplerConfig(num_steps=num_steps or model.time_steps,
                        step_T_sample=model.step_T_sample,
                        encoder_reuse=int(encoder_reuse))
    c = model.diffusion.num_classes
    graphed = GraphedSampler(model.diffusion, cfg) if graphs else None
    logged = False

    def denoisers(net, inputs):
        cond, fc = inputs["cond"], inputs.get("fc")
        return (model.denoise_fn(net, cond, fc),
                model.denoise_fns_cached(net, cond, fc) if cfg.encoder_reuse > 1 else None)

    def run(net, images: torch.Tensor, key: int = 0, indices=None, *,
            feature_net=None, prior: Optional[torch.Tensor] = None,
            gumbel: Optional[torch.Tensor] = None,
            uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = images.shape
        nonlocal logged
        net.lay_out_weights(True)
        with torch.inference_mode(), trace.span("sampler.call"):
            with trace.span("sampler.conditioning"):
                cond, fc = _conditioning(images, num_samples, feature_fn, feature_net)
            with trace.span("sampler.prior"):
                if indices is None:
                    indices = torch.arange(b)
                indices = torch.as_tensor(indices, dtype=torch.int64).to(images.device)
                ids = _element_ids(indices, num_samples)
                xt = (sample_prior_per_key(random.element_keys(key, ids, random.PRIOR), h, w, c)
                      if prior is None else prior)
                keys = random.element_keys(key, ids, random.CHAIN)
            inputs = {"cond": cond} if fc is None else {"cond": cond, "fc": fc}
            route = sampler_route(net, images.device, graphed is not None,
                                  any(v is not None for v in (prior, gumbel, uniforms)))
            if route == "model axis" and not logged:
                logged = True
                LOGGER.info("model axis: the sampler runs eagerly (the split layers' forwards "
                            "hold collectives, which a CUDA graph cannot capture)")
            if route != "graphs":
                fn, pair = denoisers(net, inputs)
                with trace.span("sampler.steps"):
                    out = ancestral_sampler(model.diffusion, fn, xt, cfg, element_keys=keys,
                                            gumbel=gumbel, uniforms=uniforms,
                                            denoise_pair=pair)
            else:
                quant.prepare_capture(net, images.device)
                out = graphed(net, xt, keys, inputs, lambda static: denoisers(net, static))
        return out.reshape(b, num_samples, h, w, c)

    run.graphed = graphed
    return run


def sampler_route(net: torch.nn.Module, device: torch.device, graphs: bool,
                  injected: bool) -> str:
    """How `make_prob_sampler` runs a call on `device`: "graphs", or why the
    eager loop runs: "asked" (`graphs=False`), "cpu" (not a CUDA device),
    "injected noise", "model axis" (a split layer's forward holds
    collectives) or "calibration" (recording int8 sites)."""
    if not graphs:
        return "asked"
    if torch.device(device).type != "cuda":
        return "cpu"
    if injected:
        return "injected noise"
    if is_split(net):
        return "model axis"
    if any(m.recording for _, m in quant.quant_sites(net)):
        return "calibration"
    return "graphs"


def _element_ids(indices: torch.Tensor, num_samples: int) -> torch.Tensor:
    """The global element ids `index * S + sample`, image-major, `[B*S]`."""
    return (indices[:, None] * num_samples
            + torch.arange(num_samples, device=indices.device)).reshape(-1)


def _conditioning(images: torch.Tensor, num_samples: int, feature_fn, feature_net):
    """The UNet's conditioning of B images repeated S times, image-major:
    `(images [B*S,H,W,Ci], DINO map [B*S,h,w,D] or None)`. DINO's patch
    embedding is an fp32 convolution, which cuDNN runs in TF32 by default:
    it runs in fp32 here, as in the train step and the calibration. With
    tracing on, the span `dino.features` holds two device marks around the
    encoder: its `dino` gap is DINO's device ms."""
    cond = images.repeat_interleave(num_samples, dim=0)
    if feature_fn is None:
        return cond, None
    with fp32_precision(), trace.span("dino.features"):
        trace.mark("start", images.device)
        fc = feature_fn(feature_net, images)
        trace.mark("dino", images.device)
    return cond, fc.repeat_interleave(num_samples, dim=0)


class _StartProgram(torch.nn.Module):
    """`(images [B,H,W,Ci], seed words [2]) -> (state, cond[, fc])`: the
    prior draw in the sampler's state, the images repeated S times and the
    DINO map, once (the encoder's weights are this module's)."""

    def __init__(self, model: DenoisingModel, num_samples: int, state: str, feature_fn,
                 feature_net):
        super().__init__()
        self.model, self.num_samples, self.state = model, num_samples, state
        self.feature_fn, self.feature_net = feature_fn, feature_net

    def forward(self, images: torch.Tensor, seed: torch.Tensor):
        b, h, w, _ = images.shape
        ids = _element_ids(torch.arange(b, device=images.device), self.num_samples)
        cond, fc = _conditioning(images, self.num_samples, self.feature_fn, self.feature_net)
        xt = sample_prior_per_key(random.element_keys(seed, ids, random.PRIOR), h, w,
                                  self.model.diffusion.num_classes)
        x = ReverseStep(self.model.diffusion, self.state, self.model.step_T_sample).initial(xt)
        return (x, cond) if fc is None else (x, cond, fc)


class _StepProgram(torch.nn.Module):
    """`(state, seed words, k, t, cond[, fc]) -> (next state, probs)`: one
    UNet call at the 0-d timestep `t`, its posterior and the draw of step
    `k` (a 0-d int64 tensor) from each element's chain stream. The UNet's
    weights (and the int8 sites' codes and static scales, its buffers) are
    this module's."""

    def __init__(self, model: DenoisingModel, num_samples: int, state: str, net):
        super().__init__()
        self.model, self.num_samples, self.state, self.net = model, num_samples, state, net

    def forward(self, x: torch.Tensor, seed: torch.Tensor, k: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor, fc: Optional[torch.Tensor] = None):
        batch = cond.shape[0]
        ids = _element_ids(torch.arange(batch // self.num_samples, device=cond.device),
                           self.num_samples)
        rs = ReverseStep(self.model.diffusion, self.state, self.model.step_T_sample,
                         element_keys=random.element_keys(seed, ids, random.CHAIN))
        t_vec = t.reshape(1).repeat(batch).to(torch.int32)
        p0 = self.net(rs.unet_input(x), cond, t_vec, fc)["diffusion_out"]
        probs = rs.posterior(x, p0, t_vec)
        return rs.draw(k, probs), probs


class _FinalProgram(torch.nn.Module):
    """`(state, probs) -> maps [B*S,H,W,C]` after the last step:
    `ReverseStep.finish`, with the last step's draw fixed by the t-grid."""

    def __init__(self, model: DenoisingModel, state: str, drew: bool):
        super().__init__()
        self.rs = ReverseStep(model.diffusion, state, model.step_T_sample)
        self.drew = drew

    def forward(self, x: torch.Tensor, probs: torch.Tensor):
        return self.rs.finish(x, probs, self.drew)


def sampler_programs(model: DenoisingModel, net: torch.nn.Module, num_samples: int,
                     num_steps: Optional[int] = None, feature_fn=None, feature_net=None):
    """`make_prob_sampler(model, S, K, feature_fn)` with the default indices
    and no encoder reuse, cut into three modules for `torch.export`
    (`utils/serving.py`), so that one UNet call is traced, not K:

        x, *cond = start(images, seed)
        for k, t in enumerate(t_grid):
            x, probs = step(x, seed, k, t, *cond)
        maps = final(x, probs)          # [B*S,H,W,C], image-major

    `seed` is `random.seed_words` of the run's seed, `k` and `t` 0-d int64
    tensors. Returns `(start, step, final, t_grid, state)`; every step is
    `ReverseStep`'s, as in `ancestral_sampler`, so the maps equal
    `make_prob_sampler`'s bit for bit where the device repeats its sums.
    `net`'s float convs' weights are held channels-last, as that sampler
    holds them."""
    net.lay_out_weights(True)
    t_grid = subsampled_t_values(model.time_steps, num_steps or model.time_steps)
    state = _resolve_state(SamplerConfig(len(t_grid)), model.diffusion.num_classes)
    return (_StartProgram(model, num_samples, state, feature_fn, feature_net),
            _StepProgram(model, num_samples, state, net),
            _FinalProgram(model, state, drew=int(t_grid[-1]) > 1),
            t_grid, state)


def load_eval_params(params: Dict[str, Any], net: torch.nn.Module) -> torch.nn.Module:
    """Load the EMA weights (`average_model`, else `model`) of the checkpoint
    at `params["load_from"]` into `net`; without `load_from`, leave its
    weights as they are, with a warning. The checkpoint is the port's, or a
    `.pt` in the reference's schema (`{"model", "average_model"}` in the
    reference's key names, fp32: `tools/export_torch_checkpoint.py`, the
    JAX package's `scripts/export_torch_checkpoint.py`). Every entry of
    `net` must be there; entries `net` does not build are left out with a
    warning, as the JAX package's converter leaves them out."""
    load_from = params.get("load_from")
    if not load_from:
        LOGGER.warning("no load_from given — evaluating randomly initialised weights")
        return net
    from ccdm_tpu_torch.train.checkpoint import load_tree

    tree = load_tree(expanduservars(load_from))
    restored = tree.get("average_model", tree.get("model"))
    if restored is None:
        raise KeyError(f"checkpoint at {load_from!r} has no average_model/model key")
    wanted = net.state_dict().keys()
    missing = sorted(set(wanted) - set(restored))
    if missing:
        raise KeyError(f"checkpoint at {load_from!r} lacks {len(missing)} of the model's "
                       f"entries: {missing[:5]}")
    extra = sorted(set(restored) - set(wanted))
    if extra:
        LOGGER.warning("checkpoint at %r: %d entries the model does not build, left out: %s",
                       load_from, len(extra), extra[:10])
    net.load_state_dict({k: restored[k] for k in wanted}, strict=True)
    return net


@trace.span("setup.dino")
def build_eval_feature_fn(params: Dict[str, Any], image_shape, *, device=None,
                          generator: Optional[torch.Generator] = None):
    """Eval-time DINO conditioning: `(feature_fn, feature_shape, encoder
    net)`, all None when no encoder is configured.

    `feature_fn(net, images)` maps `[B,H,W,3]` to `[B,H/s,W/s,D]`. The
    weights resolve in the reference's order: the `load_from` checkpoint's
    `average_feature_cond_encoder`, then its `feature_cond_encoder`, then
    the converted `.npz` named by `weights:` (numpy only), else random
    weights from `generator` (default: seed 7), with a warning. The net is
    built on `device` (default: the CUDA card). Its span
    (`utils/trace.py`) is `setup.dino`.
    """
    fce = params.get("feature_cond_encoder") or {"type": "none"}
    if fce.get("type") != "dino":
        return None, None, None
    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder

    encoder = DinoFeatureEncoder(fce)
    net = encoder.init(generator, device)
    loaded = False
    if params.get("load_from"):
        from ccdm_tpu_torch.train.checkpoint import load_tree

        try:
            tree = load_tree(expanduservars(params["load_from"]))
        except FileNotFoundError:
            tree = {}
        for key in ("average_feature_cond_encoder", "feature_cond_encoder"):
            if key in tree:
                net.load_state_dict(tree[key], strict=True)
                loaded = True
                LOGGER.info("loaded encoder weights from checkpoint key %r", key)
                break
    if not loaded and fce.get("weights"):
        encoder.load_pretrained(net, fce["weights"])
    elif not loaded:
        LOGGER.warning("DINO eval conditioning with RANDOM encoder weights")
    feature_shape = (image_shape[0] // encoder.stride,
                     image_shape[1] // encoder.stride, encoder.channels)
    return encoder, feature_shape, net


def eval_lidc_uncertainty(params: Dict[str, Any], num_steps: Optional[int] = None, *,
                          device=None, graphs: bool = True) -> Dict[str, Any]:
    """The LIDC uncertainty protocol over the config's test set (see the
    module docstring): a dict of `count`, `nonzero_fraction`, `mIoU`, `IoU`,
    `Dice`, `diversity_experts`, `GED_s`, `diversity_s`, `HMIoU_s` per
    sample count s, `samples_per_sec` (steady state: the first batch is
    left out when there is a second, and padded tail images are not
    counted), and the host seconds of generation, data, metrics and the
    static scales' calibration (in a process group: the slowest rank's;
    the rate is every rank's steady samples over the slowest rank's
    steady seconds).

    The model builds on `device` (default: the CUDA card) and samples with
    the EMA weights of `load_from`, replaying CUDA graphs on the card
    (`make_prob_sampler`; `graphs=False` runs the eager loop)."""
    from ccdm_tpu_torch.data.registry import resolve_dataset_module
    from ccdm_tpu_torch.eval.metrics import (
        ConfusionMatrix,
        generalised_energy_distance,
        hungarian_matched_iou,
    )
    from ccdm_tpu_torch.models.builder import build_model

    # with_defaults maps evaluation_vote_strategy -> step_T_sample, so
    # "confidence" reaches the sampler's final step
    params = with_defaults(params)
    module = resolve_dataset_module(params["dataset_file"])
    dataset = module.test_dataset(params.get("dataset_val_max_size"))
    num_classes = module.get_num_classes()
    LOGGER.info("%d images in test dataset '%s'", len(dataset), params["dataset_file"])

    evaluations: List[int] = params.get("evaluations", 8)
    if isinstance(evaluations, int):
        evaluations = [evaluations]
    max_samples = max(evaluations)

    first = dataset.get(0)
    image_shape = first["image"].shape
    seed = int(params.get("seed", 0))
    model = build_model(params, num_classes, image_channels=image_shape[-1],
                        image_size=min(image_shape[:2]), device=device,
                        generator=torch.Generator().manual_seed(seed))
    feature_fn, _, feature_net = build_eval_feature_fn(params, image_shape, device=device)
    net = load_eval_params(params, model.unet)
    device = next(net.parameters()).device

    n = len(dataset)
    calibration_seconds = 0.0
    if str(params.get("quantized_inference", "")).lower() == "static":
        t0 = time.perf_counter()
        cal_images = torch.from_numpy(
            np.stack([dataset.get(i)["image"] for i in range(min(n, 2))])).to(device)
        model = quant.calibrate_static_scales(model, net, cal_images, feature_fn=feature_fn,
                                              feature_net=feature_net)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        calibration_seconds = time.perf_counter() - t0
    batch_size = min(max(1, int(params.get("batch_size", 2))), max(n, 1))
    sampler = make_prob_sampler(model, max_samples, num_steps, feature_fn,
                                encoder_reuse=int(params.get("encoder_reuse", 1)), graphs=graphs)

    geds = np.zeros(len(evaluations))
    div_samples = np.zeros(len(evaluations))
    div_experts = np.zeros(len(evaluations))
    hm_ious = np.zeros(len(evaluations))
    cm = ConfusionMatrix(num_classes)
    num_annotators = first["labels"].shape[0]
    nonzero_total = 0
    count = 0
    batch_seconds: List[float] = []
    batch_real: List[int] = []
    data_seconds = metrics_seconds = 0.0

    mine = mesh.host_slice(n)
    for start in range(0, len(mine), batch_size):
        idx, real = mesh.pad_chunk(mine[start:start + batch_size], batch_size)
        t0 = time.perf_counter()
        samples = [dataset.get(i) for i in idx]
        images = torch.from_numpy(np.stack([s["image"] for s in samples])).to(device)
        labels = np.stack([s["labels"][...] for s in samples[:real]])  # [B,A,H,W,C]
        refs = np.argmax(labels, axis=-1).astype(np.int32)  # [B,A,H,W]
        data_seconds += time.perf_counter() - t0

        t0 = time.perf_counter()
        probs = sampler(net, images, seed, idx, feature_net=feature_net)  # [B,S,H,W,C]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        batch_seconds.append(time.perf_counter() - t0)
        batch_real.append(real)

        t0 = time.perf_counter()
        probs = probs[:real]
        pred_idx = probs.argmax(dim=-1)  # [B,S,H,W]
        refs_t = torch.from_numpy(refs).to(device)
        for i, s in enumerate(evaluations):
            ged, div_s, div_e = generalised_energy_distance(pred_idx[:, :s], refs_t, num_classes)
            geds[i] += ged.sum()
            div_samples[i] += div_s.sum()
            div_experts[i] += div_e.sum()
            hm_ious[i] += hungarian_matched_iou(pred_idx[:, :s], refs_t, num_classes).sum()

        # the confusion matrix of the mean log-probability prediction against
        # every non-empty expert mask (empty masks are left out)
        mean_log = torch.log(probs.clamp_min(1e-30)).mean(dim=1)
        mean_pred = mean_log.argmax(dim=-1).cpu().numpy()  # [B,H,W]
        nonzero = refs.sum(axis=(2, 3)) > 0  # [B,A]
        nonzero_total += int(nonzero.sum())
        for b in range(refs.shape[0]):
            for a in range(refs.shape[1]):
                if nonzero[b, a]:
                    cm.update(mean_pred[b], refs[b, a])
        count += real
        metrics_seconds += time.perf_counter() - t0

    # steady state: the first batch pays the warm-up, so it is left out
    # whenever a second exists; only real samples count
    steady = list(zip(batch_seconds, batch_real))
    if len(steady) > 1:
        steady = steady[1:]
    steady_samples = sum(r for _, r in steady) * max_samples
    steady_seconds = sum(s for s, _ in steady)
    generation_seconds = sum(batch_seconds)
    if mesh.process_count() > 1:
        # one allgather: counts and sums combine by +, the wall clocks by max
        # (the ranks ran side by side)
        e = len(evaluations)
        parts = mesh.allgather_f64(np.concatenate([
            geds, div_samples, div_experts, hm_ious, cm.matrix.reshape(-1),
            [count, nonzero_total, steady_samples, steady_seconds, generation_seconds,
             data_seconds, metrics_seconds, calibration_seconds]]))
        summed, slowest = parts.sum(axis=0), parts.max(axis=0)
        geds, div_samples = summed[:e], summed[e:2 * e]
        div_experts, hm_ious = summed[2 * e:3 * e], summed[3 * e:4 * e]
        cm.matrix = summed[4 * e:4 * e + num_classes ** 2].reshape(
            cm.matrix.shape).astype(cm.matrix.dtype)
        count, nonzero_total, steady_samples = (int(v) for v in summed[-8:-5])
        (steady_seconds, generation_seconds, data_seconds, metrics_seconds,
         calibration_seconds) = slowest[-5:].tolist()
    if count == 0:
        raise ValueError(f"empty test dataset ({n} images)")
    results: Dict[str, Any] = {
        "count": count,
        "nonzero_fraction": nonzero_total / max(count * num_annotators, 1),
        "mIoU": cm.miou(),
        "IoU": cm.iou().tolist(),
        "Dice": cm.dice().tolist(),
        "diversity_experts": float(div_experts[0] / count),
        "samples_per_sec": float(steady_samples) / max(float(steady_seconds), 1e-9),
        "generation_seconds": generation_seconds,
        "data_seconds": data_seconds,
        "metrics_seconds": metrics_seconds,
        "calibration_seconds": calibration_seconds,
    }
    for i, s in enumerate(evaluations):
        results[f"GED_{s}"] = float(geds[i] / count)
        results[f"diversity_{s}"] = float(div_samples[i] / count)
        results[f"HMIoU_{s}"] = float(hm_ious[i] / count)

    LOGGER.info("Nonzero: %.4g", results["nonzero_fraction"])
    LOGGER.info("mIoU scores: %.4g", results["mIoU"])
    LOGGER.info("IoU scores: %s", results["IoU"])
    LOGGER.info("Dice scores: %s", results["Dice"])
    LOGGER.info("Diversity experts: %.4g", results["diversity_experts"])
    for s in evaluations:
        LOGGER.info("GED (%d): %.4g", s, results[f"GED_{s}"])
        LOGGER.info("Diversity samples (%d): %.4g", s, results[f"diversity_{s}"])
        LOGGER.info("HM IoU (%d): %.4g", s, results[f"HMIoU_{s}"])
    LOGGER.info("samples/sec: %.2f", results["samples_per_sec"])

    out_dir = params.get("evaluation_path") or params.get("output_path")
    if out_dir and mesh.process_index() == 0:
        out_dir = expanduservars(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        tag = f"steps{num_steps}" if num_steps else "full"
        path = os.path.join(out_dir, f"lidc_uncertainty_{tag}.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=2)
        LOGGER.info("wrote results to %s", path)
    return results

"""Serving export: the ancestral sampler as a `torch.export` artifact (port
of `ccdm_tpu/utils/serving.py`).

The JAX package serialises its jitted sampler, the T-step `lax.scan`
inside, as one StableHLO program. Exported whole, the port's Python loop
would trace K copies of the UNet, so the artifact holds the sampler cut
into three programs (`eval/lidc_uncertainty.sampler_programs`) and a
manifest, and `load_sampler` walks the t-grid over them:

- `start(images, seed) -> (state, cond[, fc])`: the prior draw, the images
  repeated S times, the DINO map once (the frozen encoder inside);
- `step(state, seed, k, t, cond[, fc]) -> (state, probs)`: one UNet call,
  its posterior and the draw of step k (the UNet's weights, the int8 codes
  and calibrated static scales inside);
- `final(state, probs) -> maps`: the last step's resolution, probabilities
  under `confidence`, the majority one-hot under `majority`.

The weights of each network are stored once: the step holds the UNet's and
the final step's posterior comes out of the step, so no program holds a
second copy. The three hand-written kernels are nodes of the graphs, the
registered ops `ccdm::group_norm`, `ccdm::flash_attention` and
`ccdm::quant_conv`; their launch plans are chosen when they run.

Artifact contract (the JAX package's, `ccdm_tpu/utils/serving.py:10-16`):

    serve(images [B,H,W,Ci] f32, seed int64[2]) -> probs [B,S,H,W,C] f32

`seed` holds the low and high 32-bit words of the run's seed
(`diffusion.random.seed_words`), where JAX's artifact takes a raw
`uint32[2]` key; the maps equal `make_prob_sampler(model, S, K,
feature_fn)(net, images, key=seed)` on the same device. The batch size is
static: one artifact per served batch shape, and one per device: an
artifact exported on the card serves on the card, one exported on the CPU
on the CPU (as a JAX artifact is per platform). A serving process imports
`torch` and `ccdm_tpu_torch.ops`, which registers the kernels, as a JAX
artifact needs the runtime of its custom calls; nothing of the model,
diffusion or config code. Backend flags are not part of a graph, so
`serve` runs every program under `ops.precision.fp32_precision`.
Encoder reuse is not in the artifact (nor in the JAX package's).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional, Tuple

import torch

FORMAT_VERSION = 1
_PROGRAMS = ("start", "step", "final")


def export_sampler(model, net, image_shape: Tuple[int, int, int], *, num_samples: int,
                   num_steps: Optional[int] = None, batch_size: int = 1, feature_fn=None,
                   feature_net=None) -> bytes:
    """Serialise the ready-to-serve sampler to bytes, on the device `net`'s
    weights lie on. `model`, `net`, `feature_fn` and `feature_net` as for
    `make_prob_sampler` and its call, a calibrated model included
    (`quantized_inference: static` travels inside)."""
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.eval.lidc_uncertainty import sampler_programs
    from ccdm_tpu_torch.ops import quant

    device = next(net.parameters()).device
    start, step, final, t_grid, state = sampler_programs(
        model, net, num_samples, num_steps, feature_fn, feature_net)
    for _, site in quant.quant_sites(net):
        site.codes()  # the int8 codes, derived from the real weights before the trace
    images = torch.zeros(batch_size, *image_shape, device=device)
    seed = random.seed_words(0).to(device)
    k, t = (torch.tensor(v, dtype=torch.int64, device=device) for v in (0, int(t_grid[0])))
    blobs = {}
    # the static scales are the int8 sites' buffers for the duration: the
    # step program holds them as constants
    with torch.no_grad(), quant.static_scales(net, model.act_scales):
        x, *cond = start(images, seed)
        x_next, probs = step(x, seed, k, t, *cond)
        for name, program, args in (("start", start, (images, seed)),
                                    ("step", step, (x, seed, k, t, *cond)),
                                    ("final", final, (x_next, probs))):
            ep = torch.export.export(program, args, strict=False)
            ep.example_inputs = None  # the state of a step is megabytes: keep it out
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            blobs[name] = buf.getvalue()
    manifest = {
        "format": FORMAT_VERSION, "device": device.type, "t_grid": t_grid.tolist(),
        "state": state, "batch": batch_size, "image_shape": list(image_shape),
        "num_samples": num_samples, "num_classes": model.diffusion.num_classes,
        "step_T_sample": model.step_T_sample,
    }
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
        for name, blob in blobs.items():
            z.writestr(f"{name}.pt2", blob)
    return out.getvalue()


def save_sampler(path: str, *args, **kwargs) -> str:
    """`export_sampler` to a file; returns the path."""
    blob = export_sampler(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def load_sampler(path_or_bytes):
    """Load an artifact -> `serve(images, seed) -> probs [B,S,H,W,C]`, on the
    device it was exported on (a card's artifact raises without a card)."""
    from ccdm_tpu_torch.ops.precision import fp32_precision  # also registers ccdm::*

    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    with zipfile.ZipFile(src) as z:
        m = json.loads(z.read("manifest.json"))
        if m["format"] != FORMAT_VERSION:
            raise ValueError(f"artifact format {m['format']}, this loader reads {FORMAT_VERSION}")
        if m["device"] == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the artifact was exported on a CUDA card and serves on one")
        start, step, final = (torch.export.load(io.BytesIO(z.read(f"{name}.pt2"))).module()
                              for name in _PROGRAMS)
    device = torch.device(m["device"])
    shape = (m["batch"], *m["image_shape"])
    steps = list(zip(torch.arange(len(m["t_grid"]), device=device),
                     torch.tensor(m["t_grid"], dtype=torch.int64, device=device)))

    def serve(images: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        if tuple(images.shape) != shape:
            raise ValueError(f"images {tuple(images.shape)}: this artifact serves {shape}")
        images = images.to(device, torch.float32)
        seed = seed.to(device, torch.int64)
        with torch.inference_mode(), fp32_precision():
            x, *cond = start(images, seed)
            for k, t in steps:
                x, probs = step(x, seed, k, t, *cond)
            maps = final(x, probs)
        return maps.reshape(m["batch"], m["num_samples"], *maps.shape[1:])

    serve.manifest = m
    return serve

"""The port's serving artifact (`ccdm_tpu_torch/utils/serving.py`) on the CPU.

The served sampler against the port's eager `make_prob_sampler` (bit for
bit, in the one-hot, index and int8-static states), the contract's seed
words, a loader that imports only `torch` and `ccdm_tpu_torch.ops`, one
UNet in the artifact, the registered ops' fake implementations, the export
CLI; then against the JAX package: the last step's posterior at 1e-5 in
fp32, and the served samplers' distributions. Also the repair that puts
DINO's features in fp32 at eval. Sizes are `tests/test_serving.py`'s.
"""

import io
import json
import math
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from ccdm_tpu.diffusion.categorical import theta_post_prob as jax_theta_post_prob
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu.utils import serving as jax_serving
from ccdm_tpu_torch.diffusion import random
from ccdm_tpu_torch.eval.lidc_uncertainty import build_eval_feature_fn, make_prob_sampler
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
from ccdm_tpu_torch.ops import quant
from ccdm_tpu_torch.utils.serving import StepBody, export_sampler, load_sampler, save_sampler
from torch_port_util import load_port_weights, unzero

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
PARAMS = {  # tests/test_serving.py's
    "beta_schedule": "cosine",
    "time_steps": 6,
    "compute_dtype": "float32",
    "step_T_sample": "confidence",
    "unet_openai": {
        "base_channels": 8, "image_size": 16, "channel_mult": [1, 2],
        "attention_resolutions": [2], "num_head_channels": 4,
    },
}
H, W, B, S, K = 16, 32, 2, 3, 4
# a tiny DINO whose stride-2 map joins the UNet at ds 2 (input block 4)
VIT = dict(embed_dim=48, depth=2, num_heads=2, patch_size=8, pretrain_size=32)
DINO = {"type": "dino", "model": "dino_vits8", "vit_config": VIT, "output_stride": 2,
        "source_layer": 1, "target_layer": 4}
CASES = {  # name -> (params, classes, image channels)
    "onehot": (PARAMS, 2, 1),
    "index_dino": (dict(PARAMS, feature_cond_encoder=DINO), 9, 3),
    "int8_static": (dict(PARAMS, compute_dtype="bfloat16", quantized_inference="static"), 2, 1),
    # dynamic scales, and the majority vote in the last step
    "int8_dynamic_majority": (dict(PARAMS, quantized_inference=True, step_T_sample="majority"),
                              2, 1),
}
SEED = 2 ** 40 + 5  # both seed words non-zero


def _unzero_(net, seed):
    """Every all-zero parameter redrawn: left at zero, the UNet's softmax is
    uniform whatever its torso computes."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)


class Case:
    """A model of one case, its eager maps and its artifact."""

    def __init__(self, name):
        params, c, ci = CASES[name]
        self.model = build_model(params, num_classes=c, image_channels=ci, image_size=H,
                                 device="cpu")
        _unzero_(self.model.unet, 1)
        self.feature_fn, _, self.feature_net = build_eval_feature_fn(params, (H, W, ci),
                                                                     device="cpu")
        if self.feature_net is not None:
            _unzero_(self.feature_net, 2)
        gen = torch.Generator().manual_seed(3)
        self.images = torch.randn(B, H, W, ci, generator=gen)
        if params.get("quantized_inference") == "static":
            self.model = quant.calibrate_static_scales(self.model, self.model.unet, self.images)
        self.sampler = make_prob_sampler(self.model, S, K, feature_fn=self.feature_fn)
        self.eager = self.sampler(self.model.unet, self.images, key=SEED,
                                  feature_net=self.feature_net)
        self.blob = export_sampler(self.model, self.model.unet, (H, W, ci), num_samples=S,
                                   num_steps=K, batch_size=B, feature_fn=self.feature_fn,
                                   feature_net=self.feature_net)
        self.serve = load_sampler(self.blob)


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(name):
        if name not in made:
            made[name] = Case(name)
        return made[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_served_maps_equal_the_eager_sampler_bit_for_bit(cases, name):
    case = cases(name)
    served = case.serve(case.images, random.seed_words(SEED))
    assert served.shape == case.eager.shape == (B, S, H, W, case.model.diffusion.num_classes)
    assert torch.equal(served, case.eager)
    assert case.serve.manifest["state"] == ("index" if name == "index_dino" else "onehot")
    if name == "int8_dynamic_majority":
        assert set(served.unique().tolist()) == {0.0, 1.0}


@pytest.mark.parametrize("seed", [0, 2 ** 32, 2 ** 64 - 1])
def test_seed_words_equal_the_integer_seed(cases, seed):
    case = cases("onehot")
    words = random.seed_words(seed)
    assert words.tolist() == [seed & 0xFFFFFFFF, seed >> 32]
    want = case.sampler(case.model.unet, case.images, key=seed)
    assert torch.equal(case.serve(case.images, words), want)
    # the eager sampler takes the words too
    assert torch.equal(case.sampler(case.model.unet, case.images, key=words), want)


def test_tensor_steps_draw_the_bits_of_int_steps():
    keys = random.element_keys(SEED, torch.arange(7), random.CHAIN)
    for step in (0, 1, 249, 2 ** 31 + 3):
        t = torch.tensor(step)
        assert torch.equal(random.bits(keys, t, 11), random.bits(keys, step, 11))
        assert torch.equal(random.gumbel(keys, t, (3, 4)), random.gumbel(keys, step, (3, 4)))
        assert torch.equal(random.uniform(keys, t, (5,)), random.uniform(keys, step, (5,)))
    assert torch.equal(random.element_keys(random.seed_words(SEED), torch.arange(7), 0),
                       random.element_keys(SEED, torch.arange(7), 0))
    with pytest.raises(ValueError):
        random.seed_words(2 ** 64)


@pytest.mark.parametrize("name", ["onehot", "index_dino", "int8_static"])
def test_the_step_body_gives_the_loop_as_written_before_it(cases, name):
    """`StepBody` called K times from Python (the CPU's loop, and the unit a
    card's CUDA graph captures, its `t` read from the device grid at its
    device `k`) against the loop the loader walked before the body: the
    step program called with `k` and `t` from the host, its state rebound.
    The maps are bit-equal, and equal the eager sampler's."""
    case = cases(name)
    start, step, final = (program.module() for program, _ in _programs(case.blob).values())
    seed = random.seed_words(SEED)
    t_grid = case.serve.manifest["t_grid"]
    with torch.inference_mode():
        x, *cond = start(case.images, seed)
        for k, t in zip(torch.arange(len(t_grid)), torch.tensor(t_grid, dtype=torch.int64)):
            x, probs = step(x, seed, k, t, *cond)
        before = final(x, probs)
        x, *cond = start(case.images, seed)
        body = StepBody(step, torch.tensor(t_grid, dtype=torch.int64), x, seed, cond)
        for _ in t_grid:
            probs = body()
        assert int(body.k) == len(t_grid) == K
        ours = final(body.x, probs)
    assert torch.equal(ours, before)
    assert torch.equal(ours.reshape(case.eager.shape), case.eager)
    assert case.serve.graphed is None  # a CPU artifact walks the loop


def test_wrong_batch_shape_rejected(cases):
    case = cases("onehot")
    with pytest.raises(ValueError, match="serves"):
        case.serve(torch.zeros(B + 1, H, W, 1), random.seed_words(0))
    with pytest.raises(ValueError, match="serves"):
        case.serve(torch.zeros(B, H, W + 1, 1), random.seed_words(0))


def _programs(blob):
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return {name: (torch.export.load(io.BytesIO(z.read(f"{name}.pt2"))),
                       z.read(f"{name}.pt2")) for name in ("start", "step", "final")}


def _count(graph, target):
    return sum(n.op == "call_function" and n.target == target for n in graph.nodes)


@pytest.mark.parametrize("name", ["onehot", "int8_static"])
def test_the_artifact_holds_one_unet(cases, name):
    """The step program holds one UNet call's sites (not K); the start and
    final programs hold none of its weights; the file is the weights once
    and the graphs."""
    case = cases(name)
    unet = case.model.unet
    programs = _programs(case.blob)
    step = programs["step"][0].graph
    # the attention blocks' 1x1 projections: Conv1d calls in an int8 UNet,
    # which runs NCHW, and batched matrix products over the same weights in a
    # float one, whose inference torso is channels-last (models/layers.py)
    projections = sum(type(m) is torch.nn.Conv1d for m in unet.modules())
    nhwc = not unet.quantize_convs
    sites = {
        torch.ops.ccdm.group_norm.default: sum(isinstance(m, GroupNorm32) for m in unet.modules()),
        torch.ops.ccdm.flash_attention.default:
            sum(isinstance(m, AttentionBlock) for m in unet.modules()),
        torch.ops.ccdm.quant_conv.default:
            sum(isinstance(m, quant.QuantConv2d) for m in unet.modules()),
        torch.ops.aten.conv2d.default: sum(type(m) is torch.nn.Conv2d for m in unet.modules()),
        torch.ops.aten.conv1d.default: 0 if nhwc else projections,
        torch.ops.aten.baddbmm.default: projections if nhwc else 0,
    }
    assert sites[torch.ops.ccdm.group_norm.default] == 31  # 24 in ResBlocks, 6 attention, head
    assert (sites[torch.ops.ccdm.quant_conv.default] > 0) == (name == "int8_static")
    for target, n in sites.items():
        assert _count(step, target) == n, target
    for other in ("start", "final"):
        assert not programs[other][0].state_dict
        for target in sites:
            assert _count(programs[other][0].graph, target) == 0
    # bytes: each weight and buffer (the int8 codes and scales) stored once,
    # beside a few schedule constants; the rest of the file is the three
    # graphs and the manifest
    weights = sum(t.numel() * t.element_size() for t in (*unet.parameters(), *unet.buffers()))
    stored = 0
    graphs = 0
    for _, raw in programs.values():
        with zipfile.ZipFile(io.BytesIO(raw)) as z:
            for info in z.infolist():
                if "/data/weights/weight_" in info.filename or \
                        "/data/constants/tensor_" in info.filename:
                    stored += info.file_size
                else:
                    graphs += info.file_size
    assert weights <= stored <= 1.2 * weights
    assert len(case.blob) <= 1.2 * weights + graphs + 4096


def test_the_loader_imports_only_torch_and_the_kernels(cases, tmp_path):
    """A fresh process loads the artifact with `torch` and the port's `ops`
    package (which registers the kernels) and serves the eager maps; no
    model, diffusion or config module, no jax."""
    case = cases("index_dino")
    path = tmp_path / "sampler.ccdm"
    path.write_bytes(case.blob)
    np.save(tmp_path / "images.npy", case.images.numpy())
    child = (
        "import json, sys\n"
        "sys.modules['ccdm_tpu'] = None\n"
        "import numpy as np, torch\n"
        "from ccdm_tpu_torch.utils.serving import load_sampler\n"
        "serve = load_sampler(sys.argv[1])\n"
        "out = serve(torch.from_numpy(np.load(sys.argv[2])), torch.tensor(json.loads(sys.argv[3])))\n"
        "np.save(sys.argv[4], out.numpy())\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith(('ccdm', 'jax', 'flax'))"
        " and sys.modules[m] is not None)))\n")
    proc = subprocess.run(
        [sys.executable, "-c", child, str(path), str(tmp_path / "images.npy"),
         json.dumps(random.seed_words(SEED).tolist()), str(tmp_path / "out.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    modules = set(json.loads(proc.stdout.splitlines()[-1]))
    allowed = {"ccdm_tpu_torch", "ccdm_tpu_torch.ops", "ccdm_tpu_torch.utils",
               "ccdm_tpu_torch.utils.serving"}
    assert {m for m in modules if not m.startswith("ccdm_tpu_torch.ops.")} <= allowed, modules
    assert "ccdm_tpu_torch.ops.group_norm" in modules
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), case.eager.numpy())


SITE_SHAPES = [(2, 16, 8, 8), (3, 32, 5, 7)]


@pytest.mark.parametrize("shape", SITE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_ops_pass_opcheck(shape, dtype):
    """Schema, fake implementation (shape, dtype, strides against the plain
    version's output) and dispatch of the three ops on the CPU."""
    gen = torch.Generator().manual_seed(0)
    b, c, h, w = shape
    x = torch.randn(shape, generator=gen).to(dtype)
    weight, bias = torch.rand(c, generator=gen), torch.randn(c, generator=gen)
    add = torch.randn(b, c, generator=gen).to(dtype)
    for args in ((x, weight, bias, add, 8, 1e-5, True), (x, weight, bias, None, 4, 1e-5, False)):
        torch.library.opcheck(torch.ops.ccdm.group_norm.default, args)
    qkv = torch.randn(b * 2, 3 * 8, h * w, generator=gen).to(dtype)  # the UNet's views
    torch.library.opcheck(torch.ops.ccdm.flash_attention.default,
                          (qkv[:, :8], qkv[:, 8:16], qkv[:, 16:]))
    for cout, k, stride, pad in ((24, 3, 1, 1), (24, 3, 2, 1), (12, 1, 1, 0)):
        w_q, s_w = quant.weight_codes(torch.randn(cout, c, k, k, generator=gen))
        torch.library.opcheck(torch.ops.ccdm.quant_conv.default,
                              (x, w_q, s_w, torch.randn(cout, generator=gen),
                               quant.dynamic_act_scale(x), k, stride, pad))


def test_export_cli_writes_an_artifact_on_the_cpu(tmp_path):
    from ccdm_tpu_torch.cli.export_serving import main

    params = yaml.safe_load((REPO / "configs/params_smoke_eval.yml").read_text())
    params.pop("load_from")  # random weights: the smoke run's checkpoint is not here
    path = tmp_path / "params.yml"
    path.write_text(yaml.safe_dump(params))
    out = main([str(path), str(tmp_path / "smoke.ccdm"), "--shape", "16", "16", "1",
                "--batch", "2", "--steps", "3", "--cpu"])
    serve = load_sampler(out)
    assert serve.manifest["num_samples"] == 2 and serve.manifest["t_grid"] == [4, 2, 1]
    probs = serve(torch.zeros(2, 16, 16, 1), random.seed_words(1))
    assert probs.shape == (2, 2, 16, 16, 2) and bool(torch.isfinite(probs).all())


def test_dino_features_are_computed_in_fp32_at_eval():
    """Every conv of the DINO ViT runs with cuDNN's TF32 off inside
    `make_prob_sampler`, whatever the process's setting, which is left as
    it was."""
    case = _dino_model()
    seen = []
    hooks = [m.register_forward_hook(lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
             for m in case["feature_net"].modules() if isinstance(m, torch.nn.Conv2d)]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        make_prob_sampler(case["model"], 2, 2, feature_fn=case["feature_fn"])(
            case["model"].unet, torch.zeros(1, H, W, 3), feature_net=case["feature_net"])
        assert seen == [False] * len(hooks) and hooks
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        for h in hooks:
            h.remove()


def _dino_model():
    """The index-state case's model and tiny DINO, weights as built."""
    params, c, ci = CASES["index_dino"]
    model = build_model(params, num_classes=c, image_channels=ci, image_size=H, device="cpu")
    feature_fn, _, feature_net = build_eval_feature_fn(params, (H, W, ci), device="cpu")
    return {"model": model, "feature_fn": feature_fn, "feature_net": feature_net}


# --- against the JAX package ------------------------------------------------

JH, JW, JS = 16, 16, 256


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX test model (`tests/test_serving.py`'s) with its zero leaves
    redrawn, and the port's model holding the same weights."""
    jmodel = jax_build_model(PARAMS, num_classes=2, image_channels=1, image_size=JH)
    jparams = unzero(jmodel.init(jax.random.PRNGKey(0), (JH, JW, 1)))
    tmodel = build_model(PARAMS, num_classes=2, image_channels=1, image_size=JH, device="cpu")
    load_port_weights(tmodel.unet, jparams)
    return jmodel, jparams, tmodel


def test_last_step_posterior_matches_jax(jax_pair):
    """The deterministic part: the artifact's last step (the step program at
    t = 1, then the final program) on a one-hot x_1 against JAX's
    `theta_post_prob` on `model.apply`, fp32, within 1e-5."""
    jmodel, jparams, tmodel = jax_pair
    blob = export_sampler(tmodel, tmodel.unet, (JH, JW, 1), num_samples=2, batch_size=1)
    programs = {name: ep.module() for name, (ep, _) in _programs(blob).items()}
    rng = np.random.default_rng(4)
    images = rng.standard_normal((1, JH, JW, 1)).astype(np.float32)
    x1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, JH, JW))]
    cond = np.repeat(images, 2, axis=0)
    t = np.ones(2, np.int32)
    p0 = jmodel.apply(jparams, x1, cond, t)["diffusion_out"]
    want = np.maximum(np.asarray(jax_theta_post_prob(jmodel.diffusion, x1, p0, t)), 1e-12)
    with torch.inference_mode():
        x_next, probs = programs["step"](torch.from_numpy(x1), random.seed_words(0),
                                         torch.tensor(5), torch.tensor(1),
                                         torch.from_numpy(cond))
        got = programs["final"](x_next, probs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_served_distribution_matches_jax_served_sampler(jax_pair, tmp_path):
    """The two packages' noise streams differ by design, so their served
    samplers are compared in distribution: per pixel, the mean final map
    over S = 256 samples agrees within 6 combined standard errors (plus
    1e-5 for fp32 arithmetic where both spreads vanish) at >= 99% of the
    pixels."""
    jmodel, jparams, tmodel = jax_pair
    images = np.random.default_rng(5).standard_normal((1, JH, JW, 1)).astype(np.float32)
    jserve = jax_serving.load_sampler(jax_serving.save_sampler(
        str(tmp_path / "jax.shlo"), jmodel, jparams, (JH, JW, 1), num_samples=JS))
    jax_maps = np.asarray(jserve(images, jax.random.PRNGKey(7)))[0, ..., 1]   # [S,H,W]
    serve = load_sampler(save_sampler(str(tmp_path / "port.ccdm"), tmodel, tmodel.unet,
                                      (JH, JW, 1), num_samples=JS))
    maps = serve(torch.from_numpy(images), random.seed_words(7)).numpy()[0, ..., 1]
    se = np.sqrt(jax_maps.var(0, ddof=1) / JS + maps.var(0, ddof=1) / JS)
    ok = np.abs(jax_maps.mean(0) - maps.mean(0)) <= 6 * se + 1e-5
    assert ok.mean() >= 0.99, ok.mean()
    # the maps are not all one value, so the check has something to see
    assert float(se.max()) > 1e-3
    assert math.isfinite(float(maps.sum()))

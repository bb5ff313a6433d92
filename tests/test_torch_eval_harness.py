"""The port's evaluation entry points against the JAX package's: the LIDC
uncertainty harness (its aggregation under the same stubbed probabilities,
and its independence of the batch size), the step sweep, Cityscapes
`run_inference` (mIoU, official scores and PNG pixels under the same
stubbed probabilities, at both resolutions), the eval CLI's three
branches, and a run with PIL, h5py and PyYAML made unimportable."""

import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ccdm_tpu.data.synthetic as jsyn
import ccdm_tpu.eval.cityscapes_eval as jcse
import ccdm_tpu.eval.lidc_uncertainty as jlu
import ccdm_tpu_torch.data.synthetic as tsyn
import ccdm_tpu_torch.eval.cityscapes_eval as tcse
import ccdm_tpu_torch.eval.lidc_uncertainty as tlu

torch.set_num_threads(4)
REPO = Path(__file__).resolve().parents[1]

TINY_UNET = {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [4],
             "num_head_channels": 4}
EVAL_PARAMS = {
    "dataset_file": "ccdm_tpu.data.synthetic",
    "dataset_val_max_size": 4,
    "batch_size": 3,
    "evaluations": [1, 3],
    "evaluation_vote_strategy": "confidence",
    "time_steps": 4,
    "beta_schedule": "cosine",
    "compute_dtype": "float32",
    "unet_openai": TINY_UNET,
}


@pytest.fixture
def tiny_synthetic(monkeypatch):
    for mod in (tsyn, jsyn):
        monkeypatch.setattr(mod, "test_dataset", lambda max_size=None, indices=None, mod=mod:
                            mod.synthetic_test_dataset(n=4, resolution=32))


def _stub_probs(indices, samples, h, w, c):
    """Dirichlet probability maps keyed on each image's global index."""
    return np.stack([np.random.default_rng(1000 + int(i)).dirichlet(
        np.full(c, 0.5), size=(samples, h, w)).astype(np.float32) for i in indices])


def _stub_samplers(monkeypatch, jax_module, port_module, c):
    def jax_make(model, num_samples, *args, **kwargs):
        def run(params, images, key, indices=None, feature_params=None):
            return jnp.asarray(_stub_probs(np.asarray(indices), num_samples,
                                           *images.shape[1:3], c))
        return run

    def port_make(model, num_samples, *args, **kwargs):
        def run(net, images, key=0, indices=None, *, feature_net=None):
            return torch.from_numpy(_stub_probs(indices, num_samples, *images.shape[1:3], c))
        return run

    monkeypatch.setattr(jax_module, "make_prob_sampler", jax_make)
    monkeypatch.setattr(port_module, "make_prob_sampler", port_make)


KEYS = ("GED_1", "GED_3", "diversity_1", "diversity_3", "HMIoU_1", "HMIoU_3",
        "diversity_experts", "mIoU", "nonzero_fraction")


def test_harness_aggregation_equals_jax(tiny_synthetic, monkeypatch, tmp_path):
    """The same probabilities through both harnesses: every metric agrees.
    (The stubbed sampler reads no weights: the JAX side is handed empty
    ones rather than compiling an init.)"""
    _stub_samplers(monkeypatch, jlu, tlu, 2)
    params = dict(EVAL_PARAMS, batch_size=2)
    ref = jlu.eval_lidc_uncertainty(dict(params, output_path=str(tmp_path / "jax")),
                                    model_params={})
    ours = tlu.eval_lidc_uncertainty(dict(params, output_path=str(tmp_path / "port")),
                                     device="cpu")
    assert ours["count"] == ref["count"] == 4
    for k in KEYS:
        assert ours[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-6), k
    for k in ("IoU", "Dice"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=1e-6)
    saved = json.loads((tmp_path / "port" / "lidc_uncertainty_full.json").read_text())
    assert saved["count"] == 4 and saved["GED_3"] == ours["GED_3"]
    assert ours["samples_per_sec"] > 0 and ours["data_seconds"] >= 0


def test_harness_results_do_not_depend_on_the_batch_size(tiny_synthetic):
    """The port's harness with the real sampler at batch sizes 1, 3 (a
    padded tail) and 4: every image's samples come from the streams of its
    global index, so the results agree."""
    runs = [tlu.eval_lidc_uncertainty(dict(EVAL_PARAMS, batch_size=bs), device="cpu")
            for bs in (1, 3, 4)]
    for other in runs[1:]:
        for k in KEYS:
            assert runs[0][k] == pytest.approx(other[k], rel=1e-6, abs=1e-12), k


def test_sampling_speed_sweep(tiny_synthetic, tmp_path):
    from ccdm_tpu_torch.eval.lidc_sampling_speed import (
        DEFAULT_STEP_SWEEP,
        eval_lidc_sampling_speed,
    )
    from ccdm_tpu.eval.lidc_sampling_speed import DEFAULT_STEP_SWEEP as JAX_SWEEP

    assert DEFAULT_STEP_SWEEP == JAX_SWEEP
    res = eval_lidc_sampling_speed(dict(EVAL_PARAMS, output_path=str(tmp_path)), [4, 2],
                                   device="cpu")
    assert set(res) == {4, 2} and all(r["samples_per_sec"] > 0 for r in res.values())
    assert {p.name for p in tmp_path.iterdir()} == {"lidc_uncertainty_steps4.json",
                                                    "lidc_uncertainty_steps2.json"}


def _cs_params(out, resolution, evaluations):
    settings = {"target_size": [32, 64]}
    if resolution == "original":
        settings["return_original_labels"] = True
    return {"output_path": str(out), "dataset_file": "datasets.cityscapes",
            "dataset_val_max_size": 3, "batch_size": 2, "time_steps": 2,
            "beta_schedule": "cosine", "compute_dtype": "float32",
            "evaluation": {"resolution": resolution, "evaluations": evaluations,
                           "evaluation_vote_strategy": "confidence"},
            "dataset_pipeline_val": ["resize", "torchvision_normalise"],
            "dataset_pipeline_val_settings": settings, "unet_openai": TINY_UNET}


def _nan_close(a, b, path="official"):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _nan_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, float) and math.isnan(b):
        assert math.isnan(a), path
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12), path
    else:
        assert a == b, path


@pytest.mark.parametrize("resolution,evaluations", [("dataloader", 2), ("original", 1)])
def test_run_inference_equals_jax(tmp_path, cityscapes_tree_factory, monkeypatch,
                                  resolution, evaluations):
    """Under the same stubbed votes: the confusion-matrix mIoU, the official
    scores (with iIoU at the original resolution) and every dumped PNG."""
    root = cityscapes_tree_factory(tmp_path / "cs", splits={"val": 3}, instance_ids=True)
    monkeypatch.setenv("CCDM_CITYSCAPES_PATH", root)
    _stub_samplers(monkeypatch, jcse, tcse, 20)
    ref = jcse.run_inference(_cs_params(tmp_path / "jax", resolution, evaluations))
    ours = tcse.run_inference(_cs_params(tmp_path / "port", resolution, evaluations),
                              device="cpu")
    assert ours["images"] == ref["images"] == 3
    assert ours["mIoU"] == pytest.approx(ref["mIoU"], rel=1e-9)
    np.testing.assert_allclose(ours["IoU"], ref["IoU"], rtol=1e-9)
    _nan_close(ours["official"], ref["official"])
    assert (ours["official"]["nbInstanceImages"] == 3) == (resolution == "original")
    for sub in ("submit", "color", "gt"):
        names = sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert len(names) == 3
        for name in names:
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "port" / sub / name)),
                np.asarray(Image.open(tmp_path / "jax" / sub / name)), err_msg=f"{sub}/{name}")
    shape = (64, 128) if resolution == "original" else (32, 64)
    assert np.asarray(Image.open(next((tmp_path / "port" / "submit").iterdir()))).shape == shape


def test_cli_runs_each_branch(tmp_path, tiny_synthetic, cityscapes_tree_factory, monkeypatch):
    from ccdm_tpu_torch.cli import eval as cli

    def params_file(name, params):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(params))
        return str(path)

    lidc = params_file("lidc", dict(EVAL_PARAMS, output_path=str(tmp_path / "lidc")))
    res = cli.main([lidc, "--device", "cpu"])
    assert res["count"] == 4 and (tmp_path / "lidc" / "lidc_uncertainty_full.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([lidc])  # the card by default, never the CPU by itself
    sweep = params_file("sweep", dict(EVAL_PARAMS, output_path=str(tmp_path / "sweep"),
                                      dataset_file="ccdm_tpu.data.synthetic_sampling_speed",
                                      step_sweep=[4, 1]))
    assert set(cli.main([sweep, "--device", "cpu"])) == {4, 1}
    root = cityscapes_tree_factory(tmp_path / "cs", splits={"val": 2})
    monkeypatch.setenv("CCDM_CITYSCAPES_PATH", root)
    cs = params_file("cs", _cs_params(tmp_path / "cs_out", "dataloader", 1))
    res = cli.main([cs, "--device", "cpu"])
    assert res["images"] == 2 and (tmp_path / "cs_out" / "submit").is_dir()


def test_eval_runs_without_pil_h5py_or_yaml(tmp_path):
    """A child process that cannot import PIL, h5py or PyYAML writes a
    Cityscapes tree and an LIDC PNG tree with the port's PNG writer and
    runs both evaluations through the CLI on the CPU."""
    child = textwrap.dedent("""
        import importlib.abc, json, sys
        BLOCKED = {"PIL", "h5py", "yaml"}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked")
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        sys.meta_path.insert(0, Block())

        import os
        from pathlib import Path
        import numpy as np
        from ccdm_tpu_torch.utils.png import write_png
        from ccdm_tpu_torch.cli import eval as cli

        out = Path(sys.argv[1])
        rng = np.random.default_rng(0)
        for i in range(2):
            base = str(out / "cs" / "{}" / "val" / "cityA") + f"/img{i}_" + "{}.png"
            write_png(base.format("leftImg8bit", "leftImg8bit"),
                      rng.integers(0, 256, (64, 128, 3)).astype(np.uint8))
            ids = rng.choice([7, 8, 26], size=(64, 128)).astype(np.uint8)
            write_png(base.format("gtFine", "gtFine_labelIds"), ids)
            inst = np.where(ids == 26, 26001, ids).astype(np.uint16)
            write_png(base.format("gtFine", "gtFine_instanceIds"), inst)
            lidc = out / "lidc" / "lidc_crops_test" / "test"
            write_png(str(lidc / "images" / "c0" / f"s{i}.png"),
                      rng.integers(0, 256, (140, 140)).astype(np.uint8))
            for a in range(4):
                write_png(str(lidc / "gt" / "c0" / f"s{i}_l{a}.png"),
                          ((rng.random((140, 140)) > 0.8) * 255).astype(np.uint8))
        os.environ["CCDM_CITYSCAPES_PATH"] = str(out / "cs")
        os.environ["CCDM_LIDC_ORIG_PATH"] = str(out / "lidc")
        cs = cli.main([sys.argv[2], "--device", "cpu"])
        lidc = cli.main([sys.argv[3], "--device", "cpu"])
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED | {"ccdm_tpu"})
        print("RESULT", json.dumps({"cs_images": cs["images"],
                                    "inst": cs["official"]["nbInstanceImages"],
                                    "lidc_count": lidc["count"], "leaked": leaked}))
    """)
    cs_params = dict(_cs_params(tmp_path / "cs_out", "original", 1), dataset_val_max_size=None)
    lidc_params = dict(EVAL_PARAMS, dataset_file="datasets.lidc_orig", dataset_val_max_size=None,
                       batch_size=2, evaluations=[2], time_steps=2,
                       output_path=str(tmp_path / "lidc_out"))
    paths = []
    for name, params in (("cs", cs_params), ("lidc", lidc_params)):
        paths.append(tmp_path / f"{name}.json")
        paths[-1].write_text(json.dumps(params))
    proc = subprocess.run([sys.executable, "-c", child, str(tmp_path), *map(str, paths)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT"))
    result = json.loads(line.split(" ", 1)[1])
    assert result == {"cs_images": 2, "inst": 2, "lidc_count": 2, "leaked": []}, result

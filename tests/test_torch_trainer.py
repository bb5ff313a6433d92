"""The port's trainer end to end on the CPU (mirroring `tests/test_trainer_e2e.py`
and `tests/test_preemption.py`), its data copies against the JAX package's
originals, the demo config's copy, the CLI, and `load_from` in the
evaluators."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ccdm_tpu_torch.data.synthetic as syn
from ccdm_tpu_torch.train.checkpoint import load_tree
from ccdm_tpu_torch.train.trainer import TrainingRun, run_train

torch.set_num_threads(4)
REPO = Path(__file__).resolve().parents[1]

SMOKE_PARAMS = {
    "dataset_file": "ccdm_tpu.data.synthetic",
    "batch_size": 8,
    "samples": 4,
    "max_epochs": 1,
    "time_steps": 4,
    "beta_schedule": "cosine",
    "polyak_alpha": 0.9,
    "compute_dtype": "float32",
    "optim": {"name": "Adam", "learning_rate": 1e-3, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1e-5}, "epochs": 1},
    "unet_openai": {"base_channels": 8, "channel_mult": [1, 2],
                    "attention_resolutions": [4], "num_head_channels": 4},
    "display_freq": 2,
    "save_freq": 4,
    "validation_freq": 4,
    "dataset_val_max_size": 4,
    "validation_max_batches": 1,
    "progress_bar": False,
    "mesh": {"model": 1},
}
SHRINK = ("syn.training_dataset = lambda: syn.synthetic_training_dataset(n={n}, resolution=32)\n"
          "syn.validation_dataset = lambda max_size=4: syn.synthetic_test_dataset(n=4, "
          "resolution=32)\n")


@pytest.fixture
def tiny_synthetic(monkeypatch):
    monkeypatch.setattr(syn, "training_dataset",
                        lambda: syn.synthetic_training_dataset(n=16, resolution=32))
    monkeypatch.setattr(syn, "validation_dataset",
                        lambda max_size=4: syn.synthetic_test_dataset(n=4, resolution=32))


def _train(tmp_path, name, max_steps=None, **overrides):
    params = dict(SMOKE_PARAMS, output_path=str(tmp_path / name), **overrides)
    return run_train(params, max_steps=max_steps, device="cpu")


def test_run_train_smoke(tmp_path, tiny_synthetic):
    state = _train(tmp_path, "run", max_steps=4)
    assert state.step == 4 and state.opt_state["count"] == 4
    run = tmp_path / "run"
    assert load_tree(str(run))["step"] == 4  # the periodic save at step 4
    for best in ("best_ged", "best_hmiou"):  # validation ran at step 4
        score = json.loads((run / best / "4" / "score.json").read_text())
        assert len(score) == 1
    events = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    val = [e for e in events if e["tag"] == "val"]
    assert len(val) == 1 and 0 <= val[0]["GED"] <= 2 and 0 <= val[0]["HMIoU"] <= 1
    assert [e["step"] for e in events if e["tag"] == "train"] == [2, 4]
    # the training state stays contiguous: validation lays out only the EMA
    # copy it samples with channels-last
    for tree in (state.params, state.ema_params, state.opt_state["mu"], state.opt_state["nu"]):
        assert all(v.is_contiguous() for v in tree.values())

    # resume from the checkpoint and take 2 more steps
    state2 = _train(tmp_path, "run2", max_steps=2, load_from=str(run))
    assert state2.step == 6


def test_max_steps_exit_saves_final_checkpoint(tmp_path, tiny_synthetic):
    _train(tmp_path, "run", max_steps=3, save_freq=1000, validation_freq=1000)
    tree = load_tree(str(tmp_path / "run"))
    assert tree["step"] == 3 and tree["opt_state"]["count"] == 3
    assert set(tree) == {"model", "average_model", "opt_state", "step"}


def test_resume_trajectory_identical(tmp_path, tiny_synthetic):
    """Two epochs in one run equal three steps, a save and a resume, bit
    for bit: the position follows from the step, the shuffle continues, the
    draws are keyed on the step, and max_epochs is the total budget."""
    base = dict(max_epochs=2, validation_freq=1000, save_freq=1000, display_freq=1000)
    state_a = _train(tmp_path, "a", **base)
    assert state_a.step == 4
    assert _train(tmp_path, "b", max_steps=3, **dict(base, save_freq=1)).step == 3
    state_b = _train(tmp_path, "b2", load_from=str(tmp_path / "b"), **base)
    assert state_b.step == 4
    for what in ("params", "ema_params"):
        a, b = getattr(state_a, what), getattr(state_b, what)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), f"{what} {k} diverged on resume"
    for k in state_a.opt_state["mu"]:
        assert torch.equal(state_a.opt_state["nu"][k], state_b.opt_state["nu"][k])
    # a run resumed at the budget does no more work
    assert _train(tmp_path, "c", load_from=str(tmp_path / "b2"), **base).step == 4
    # the periodic manager keeps the newest 3
    assert sorted(os.listdir(tmp_path / "b" / "model")) == ["1", "2", "3"]


def test_dropout_trains_in_training_mode_and_repeats(tmp_path, tiny_synthetic):
    """With `dropout > 0` the UNet trains in training mode, its masks drawn
    from the global generator forked and seeded from the step: two runs give
    the same weights, and they differ from a run without dropout."""
    unet = dict(SMOKE_PARAMS["unet_openai"], dropout=0.5)
    base = dict(save_freq=1000, validation_freq=1000, display_freq=1000)
    runs = [_train(tmp_path, name, max_steps=2, unet_openai=unet, **base).params
            for name in ("a", "b")]
    plain = _train(tmp_path, "c", max_steps=2, **base).params
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in plain)
    assert any(not torch.equal(runs[0][k], plain[k]) for k in plain)


def test_invalid_loss_aborts(tmp_path, tiny_synthetic):
    run = TrainingRun(dict(SMOKE_PARAMS, output_path=str(tmp_path / "bad"), display_freq=1),
                      device="cpu")
    with torch.no_grad():
        for p in run.state.params.values():
            p.mul_(float("nan"))
    with pytest.raises(ValueError, match="Invalid loss"):
        run.run(max_steps=3)
    tree = load_tree(str(tmp_path / "bad" / "debug_state"))
    assert set(tree["tensors"]) == {"image", "x0", "loss"}


def test_sigterm_flag_in_process(tmp_path, tiny_synthetic):
    run = TrainingRun(dict(SMOKE_PARAMS, output_path=str(tmp_path / "run"), max_epochs=50,
                           display_freq=10 ** 9, save_freq=10 ** 9, validation_freq=10 ** 9),
                      device="cpu")
    run._on_sigterm(signal.SIGTERM, None)
    assert run.run().step == 1  # the first step saves and returns
    assert load_tree(str(tmp_path / "run"))["step"] == 1


def test_sigterm_saves_in_a_subprocess(tmp_path):
    """A real SIGTERM to a training process: it saves and returns normally."""
    child = textwrap.dedent("""
        import sys
        import ccdm_tpu_torch.data.synthetic as syn
        {shrink}
        from ccdm_tpu_torch.train.trainer import run_train
        params = dict({params}, output_path=sys.argv[1], max_epochs=100000,
                      display_freq=1, save_freq=10 ** 9, validation_freq=10 ** 9)
        params["optim"] = dict(params["optim"], epochs=100000)
        state = run_train(params, device="cpu")
        print("FINAL_STEP", state.step, flush=True)
    """).format(shrink=SHRINK.format(n=64), params=repr(SMOKE_PARAMS))
    log_path = tmp_path / "child.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", child, str(tmp_path / "run")],
                                stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
    try:
        deadline = time.time() + 240
        while "iter=" not in log_path.read_text():
            assert proc.poll() is None, log_path.read_text()
            assert time.time() < deadline, log_path.read_text()
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, log_path.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
    out = log_path.read_text()
    assert "preemption notice" in out and "FINAL_STEP" in out, out
    assert load_tree(str(tmp_path / "run"))["step"] >= 1


def test_run_train_refuses_what_is_not_ported(tmp_path, tiny_synthetic):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_train(dict(SMOKE_PARAMS, output_path=str(tmp_path / "r")))
    # a data axis other than the world size (1 here), and a model axis the
    # one-process world cannot hold: both a mesh that is not the world size
    for extra, error in (({"mesh": {"data": 2}}, ValueError),
                         ({"mesh": {"model": 2}}, ValueError)):
        with pytest.raises(error, match="mesh"):
            TrainingRun(dict(SMOKE_PARAMS, output_path=str(tmp_path / "r"), **extra),
                        device="cpu")


def test_a_failing_grid_only_warns(tmp_path, tiny_synthetic, monkeypatch, caplog):
    """A qualitative grid that raises logs a warning; the run goes on to its
    `max_steps`, validating and saving on the way."""
    import ccdm_tpu_torch.train.trainer as trainer

    def broken(*args, **kwargs):
        raise RuntimeError("no grid today")

    monkeypatch.setattr(trainer, "prediction_grid", broken)
    with caplog.at_level("WARNING", logger=trainer.__name__):
        state = _train(tmp_path, "run", max_steps=4, validation_freq=2)
    assert state.step == 4
    assert sum("qualitative grid failed: no grid today" in r.getMessage()
               for r in caplog.records) == 2
    assert sorted(os.listdir(tmp_path / "run" / "best_ged")) == ["2", "4"]
    assert not list((tmp_path / "run").glob("images_*.png"))


def test_cli_trains_from_a_params_file(tmp_path, tiny_synthetic, capsys):
    from ccdm_tpu_torch.cli import train as cli

    path = tmp_path / "params.json"
    path.write_text(json.dumps(dict(SMOKE_PARAMS, output_path=str(tmp_path / "cli"))))
    cli.main([str(path), "--max-steps", "2", "--device", "cpu"])
    assert "trained to step 2" in capsys.readouterr().out
    assert cli.load_params(str(REPO / "configs/params_smoke.yml"))["batch_size"] == 8


def test_demo_params_match_the_yaml():
    from ccdm_tpu.config import load_params
    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS

    assert DEMO_TRAIN_PARAMS == load_params(str(REPO / "configs/params_demo.yml"))


# ---- the data copies against their originals ------------------------------

def test_synthetic_and_lidc_copies_equal_their_originals():
    import ccdm_tpu.data.synthetic as jsyn

    ours, ref = syn.make_synthetic_lidc_group(6, 32, seed=3), jsyn.make_synthetic_lidc_group(
        6, 32, seed=3)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    for make in ("synthetic_training_dataset", "synthetic_test_dataset"):
        a, b = getattr(syn, make)(n=5, resolution=32), getattr(jsyn, make)(n=5, resolution=32)
        assert len(a) == len(b) == 5
        for i in range(5):
            sa = a.get(i, np.random.default_rng(i))
            sb = b.get(i, np.random.default_rng(i))
            assert set(sa) == set(sb)
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k])
    test_a, test_b = syn.test_dataset(max_size=3), jsyn.test_dataset(max_size=3)
    np.testing.assert_array_equal(test_a.get(2)["labels"], test_b.get(2)["labels"])
    assert (syn.get_num_classes(), syn.get_ignore_class(), syn.is_multi_annotator()) == (
        jsyn.get_num_classes(), jsyn.get_ignore_class(), jsyn.is_multi_annotator())
    with pytest.raises(FileNotFoundError, match="CCDM_LIDC_PATH"):
        from ccdm_tpu_torch.data import lidc

        lidc.training_dataset(file_path=str(REPO / "no_such_file.hdf5"))


def test_registry_maps_names_onto_the_port():
    from ccdm_tpu_torch.data import lidc
    from ccdm_tpu_torch.data.registry import is_multi_annotator, resolve_dataset_module

    for name in ("ccdm_tpu.data.synthetic", "datasets.synthetic",
                 "ccdm_tpu.data.synthetic_sampling_speed"):
        assert resolve_dataset_module(name) is syn
    for name in ("datasets.lidc", "datasets.lidc_sampling_speed", "ccdm_tpu.data.lidc"):
        assert resolve_dataset_module(name) is lidc
    assert is_multi_annotator(syn) and is_multi_annotator(lidc)
    from ccdm_tpu_torch.data import cityscapes, lidc_orig

    for name in ("datasets.cityscapes", "ccdm_tpu.data.cityscapes"):
        assert resolve_dataset_module(name) is cityscapes
    for name in ("datasets.lidc_orig", "ccdm_tpu.data.lidc_orig"):
        assert resolve_dataset_module(name) is lidc_orig
    assert is_multi_annotator(lidc_orig) and not is_multi_annotator(cityscapes)
    with pytest.raises(ValueError, match="JAX package"):
        resolve_dataset_module("ccdm_tpu.data.transforms")


@pytest.mark.parametrize("workers,start", [(0, 0), (2, 1)])
def test_loader_copy_equals_the_original(workers, start):
    from ccdm_tpu.data.loader import EpochLoader as JaxLoader
    from ccdm_tpu_torch.data.loader import EpochLoader, device_prefetch

    ds = syn.synthetic_training_dataset(n=20, resolution=32)
    ours = EpochLoader(ds, 4, seed=7, num_workers=workers)
    ref = JaxLoader(ds, 4, seed=7, num_workers=workers)
    assert len(ours) == len(ref) == 5
    batches = list(ours.epoch(3, start_batch=start))
    want = list(ref.epoch(3, start_batch=start))
    assert len(batches) == len(want) == 5 - start
    for a, b in zip(batches, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    staged = list(device_prefetch(iter(batches), "cpu"))
    assert len(staged) == len(batches)
    for a, b in zip(staged, batches):
        assert all(torch.equal(a[k], torch.from_numpy(b[k])) for k in b)


# ---- load_from in the evaluators ------------------------------------------

def test_lidc_eval_samples_from_a_trained_checkpoint(tmp_path, tiny_synthetic):
    """Train 2 steps, save, load the EMA through `load_eval_params`, sample."""
    from ccdm_tpu_torch.eval.lidc_uncertainty import load_eval_params, make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model

    params = dict(SMOKE_PARAMS, output_path=str(tmp_path / "run"), save_freq=1000,
                  validation_freq=1000)
    state = run_train(params, max_steps=2, device="cpu")
    model = build_model(dict(params, step_T_sample="confidence"), 2, 1, 32, device="cpu")
    load_eval_params(dict(params, load_from=str(tmp_path / "run")), model.unet)
    for name, p in model.unet.named_parameters():
        assert torch.equal(p.detach(), state.ema_params[name]), name
    images = torch.from_numpy(np.stack([syn.validation_dataset().get(i)["image"]
                                        for i in range(2)]))
    probs = make_prob_sampler(model, 3)(model.unet, images, 0)
    assert probs.shape == (2, 3, 32, 32, 2) and bool(torch.isfinite(probs).all())
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 3, 32, 32))


def test_cityscapes_evaluator_loads_a_checkpoint(tmp_path):
    """`CityscapesEvaluator.build` loads `average_model` into the UNet and
    `build_eval_feature_fn` the checkpoint's `average_feature_cond_encoder`
    into the DINO encoder."""
    import copy

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator

    params = copy.deepcopy(CITYSCAPES_EVAL_PARAMS)
    params["unet_openai"]["base_channels"] = 16
    params["feature_cond_encoder"].update(source_layer=1, vit_config=dict(
        embed_dim=48, depth=2, num_heads=2, patch_size=8, pretrain_size=32))
    params.update(compute_dtype="float32", time_steps=3, output_path=str(tmp_path))
    first = CityscapesEvaluator(params)
    first.build((256, 512, 3), 1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    unet = {k: torch.randn(v.shape, generator=gen) for k, v in
            first.model.unet.state_dict().items()}
    dino = {k: torch.randn(v.shape, generator=gen) for k, v in
            first.feature_net.state_dict().items()}
    ckpt = tmp_path / "ckpt" / "model" / "7"
    ckpt.mkdir(parents=True)
    torch.save({"model": unet, "average_model": unet, "average_feature_cond_encoder": dino,
                "opt_state": {"count": 7}, "step": 7}, ckpt / "state.pt")
    loaded = CityscapesEvaluator(dict(params, load_from=str(tmp_path / "ckpt")))
    loaded.build((256, 512, 3), 1, device="cpu")
    for k, v in loaded.model.unet.state_dict().items():
        assert torch.equal(v, unet[k]), k
    for k, v in loaded.feature_net.state_dict().items():
        assert torch.equal(v, dino[k]), k

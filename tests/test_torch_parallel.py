"""The port's data parallelism on the CPU: two ranks in a `gloo` group
against one process and against the JAX package.

One pair of rank processes (`tests/torch_parallel_worker.py`) runs every
two-rank job once, while this process computes the references: the train
step (the JAX package's global-batch gradients under the same injected
draws, and the port's one-process step under the step's own draws), a
`TrainingRun` that writes one checkpoint and resumes at world size 1, the
LIDC harness, `compute_ged`, `validate_miou` and the Cityscapes evaluator
against one rank, and the harness against the JAX package's under stubbed
probabilities."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccdm_tpu.data.synthetic as jsyn
import ccdm_tpu.eval.lidc_uncertainty as jlu
import ccdm_tpu.parallel.mesh as jmesh
import ccdm_tpu_torch.data.synthetic as tsyn
import ccdm_tpu_torch.eval.lidc_uncertainty as tlu
from ccdm_tpu.diffusion.categorical import q_xt_given_x0_probs as jax_q
from ccdm_tpu.diffusion.categorical import sample_onehot as jax_sample_onehot
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu.train.step import train_loss as jax_train_loss
from ccdm_tpu_torch.eval.cityscapes_eval import run_inference
from ccdm_tpu_torch.eval.ged_eval import compute_ged
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.convert import flax_params_to_state_dict
from ccdm_tpu_torch.parallel import mesh
from ccdm_tpu_torch.train.optimizer import build_optimizer
from ccdm_tpu_torch.train.state import create_train_state, master_params
from ccdm_tpu_torch.train.step import make_train_step, step_seed
from ccdm_tpu_torch.train.trainer import TrainingRun
from ccdm_tpu_torch.utils.png import write_png
from torch_port_util import TINY_PARAMS, load_port_weights, unzero
from torch_parallel_worker import LIDC_IMAGES, shrink_synthetic, stub_probs

torch.set_num_threads(4)
HERE = Path(__file__).resolve().parent
RANKS = 2
B, H, W, C = 4, 16, 16, 2  # the global batch: 2 rows a rank

# base 64: no GroupNorm group of one channel, whose gradients in front of
# the norm are rounding noise (as tests/test_torch_train_step.py)
STEP_PARAMS = dict(TINY_PARAMS, polyak_alpha=0.9, max_epochs=1,
                   unet_openai=dict(TINY_PARAMS["unet_openai"], base_channels=64,
                                    num_head_channels=32),
                   optim={"name": "Adam", "learning_rate": 1e-4, "lr_function": "polynomial",
                          "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 1})
TINY_UNET = {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [4],
             "num_head_channels": 4}
RUN_PARAMS = {
    "dataset_file": "ccdm_tpu.data.synthetic", "batch_size": 8, "samples": 2,
    "max_epochs": 1, "time_steps": 4, "beta_schedule": "cosine", "polyak_alpha": 0.9,
    "compute_dtype": "float32", "unet_openai": TINY_UNET,
    "optim": {"name": "Adam", "learning_rate": 1e-3, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1e-5}, "epochs": 1},
    "display_freq": 1, "save_freq": 2, "validation_freq": 2, "dataset_val_max_size": 4,
    "validation_max_batches": 1, "progress_bar": False, "mesh": {"data": RANKS},
}
LIDC_PARAMS = {
    "dataset_file": "ccdm_tpu.data.synthetic", "batch_size": 2, "evaluations": [1, 3],
    "evaluation_vote_strategy": "confidence", "time_steps": 4, "beta_schedule": "cosine",
    "compute_dtype": "float32", "unet_openai": TINY_UNET,
}
LIDC_KEYS = ("GED_1", "GED_3", "diversity_1", "diversity_3", "HMIoU_1", "HMIoU_3",
             "diversity_experts", "mIoU", "nonzero_fraction", "count")
CS_IMAGES = 3


def _cs_params(out):
    return {"output_path": str(out), "dataset_file": "datasets.cityscapes",
            "dataset_val_max_size": CS_IMAGES, "batch_size": 2, "time_steps": 2,
            "beta_schedule": "cosine", "compute_dtype": "float32", "seed": 3,
            "evaluation": {"resolution": "dataloader", "evaluations": 1,
                           "evaluation_vote_strategy": "confidence"},
            "dataset_pipeline_val": ["resize", "torchvision_normalise"],
            "dataset_pipeline_val_settings": {"target_size": [32, 64]},
            "unet_openai": TINY_UNET}


def _write_cityscapes(root: Path, n: int):
    """A Cityscapes val split of `n` 64x128 scenes (random pixels and label ids)."""
    rng = np.random.default_rng(0)
    for i in range(n):
        write_png(root / "leftImg8bit" / "val" / "cityA" / f"img{i}_leftImg8bit.png",
                  (rng.random((64, 128, 3)) * 255).astype(np.uint8))
        write_png(root / "gtFine" / "val" / "cityA" / f"img{i}_gtFine_labelIds.png",
                  rng.choice([7, 8, 11, 26, 0], size=(64, 128)).astype(np.uint8))


def _step_inputs():
    """The JAX model's weights (zero leaves redrawn), a global batch, and
    t and x_t as the JAX `train_loss` draws them from its key."""
    jmodel = jax_build_model(STEP_PARAMS, num_classes=C, image_channels=1)
    jparams = unzero(jax.jit(lambda key: jmodel.init(key, (H, W, 1)))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:H, :W]
    masks = np.stack([(yy - rng.uniform(4, 12)) ** 2 + (xx - rng.uniform(4, 12)) ** 2
                      < rng.uniform(6, 20) for _ in range(B)])
    batch = {"image": rng.standard_normal((B, H, W, 1)).astype(np.float32),
             "x0": np.eye(C, dtype=np.float32)[masks.astype(np.int64)]}
    key = jax.random.PRNGKey(5)
    t_key, q_key, _ = jax.random.split(key, 3)
    t = jax.random.randint(t_key, (B,), 1, jmodel.diffusion.time_steps + 1)
    xt = jax_sample_onehot(q_key, jax_q(jmodel.diffusion, jnp.asarray(batch["x0"]), t))
    return jmodel, jparams, batch, key, torch.from_numpy(np.array(t)), \
        torch.from_numpy(np.array(xt))


class Ranks:
    """The two rank processes, started once for the module."""

    def __init__(self, root: Path):
        self.root = root
        self.jmodel, self.jparams, self.batch, self.key, t, xt = _step_inputs()
        model = build_model(STEP_PARAMS, C, 1, device="cpu")
        load_port_weights(model.unet, self.jparams)
        torch.save({"masters": model.unet.state_dict(), "t": t, "xt": xt,
                    "batch": {k: torch.from_numpy(v) for k, v in self.batch.items()}},
                   root / "step_inputs.pt")
        _write_cityscapes(root / "cs", CS_IMAGES)
        spec = {"dir": str(root), "step_params": STEP_PARAMS,
                "run_params": dict(RUN_PARAMS, output_path=str(root / "run")),
                "lidc_params": LIDC_PARAMS, "cityscapes_root": str(root / "cs"),
                "cityscapes_params": _cs_params(root / "cs_out2")}
        (root / "spec.json").write_text(json.dumps(spec))
        with socket.socket() as s:  # a free port for the rendezvous
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.procs = []
        for rank in range(RANKS):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(RANKS), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            log = open(root / f"rank{rank}.log", "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, str(HERE / "torch_parallel_worker.py"), str(root)],
                env=env, stdout=log, stderr=subprocess.STDOUT), log))
        self._results = None

    def results(self):
        """Both ranks' results, once both exit 0."""
        if self._results is None:
            # a rank that fails leaves the other waiting in a collective:
            # stop at the first failure
            deadline = time.monotonic() + 300
            while any(p.poll() is None for p, _ in self.procs) and \
                    not any(p.poll() for p, _ in self.procs) and time.monotonic() < deadline:
                time.sleep(0.2)
            rcs = [p.poll() for p, _ in self.procs]
            self.close()
            logs = "\n".join((self.root / f"rank{r}.log").read_text()[-3000:]
                             for r in range(RANKS))
            assert rcs == [0] * RANKS, f"exit codes {rcs}\n{logs}"
            self._results = [torch.load(self.root / f"rank{r}.pt", weights_only=False)
                             for r in range(RANKS)]
        return self._results

    def close(self):
        for proc, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


@pytest.fixture
def small_sets(monkeypatch):
    """The synthetic sets at the workers' size, for both packages."""
    for name in ("training_dataset", "validation_dataset", "test_dataset"):
        monkeypatch.setattr(tsyn, name, getattr(tsyn, name))
    shrink_synthetic()
    monkeypatch.setattr(jsyn, "test_dataset", lambda max_size=None, indices=None:
                        jsyn.synthetic_test_dataset(n=LIDC_IMAGES, resolution=32))


def _close_to_max(ours, ref, rel, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    err = np.abs(ours - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


@pytest.mark.parametrize("n,p,count", [(7, 0, 2), (7, 1, 2), (5, 2, 3), (2, 2, 3),
                                       (0, 0, 2), (16, 3, 4)])
def test_host_slice_and_pad_chunk_equal_jax(n, p, count):
    ours = mesh.host_slice(n, p, count)
    assert ours == jmesh.host_slice(n, p, count)
    for bs in (1, 2, 3):
        for start in range(0, len(ours), bs):
            assert mesh.pad_chunk(ours[start:start + bs], bs) == \
                jmesh.pad_chunk(ours[start:start + bs], bs)


def test_collectives_across_two_ranks(ranks):
    r0, r1 = ranks.results()
    assert (r0["rank"], r1["rank"], r0["count"]) == (0, 1, RANKS)
    assert r0["host_slice"] == [0, 2, 4, 6] and r1["host_slice"] == [1, 3, 5]
    assert r0["ranks_main"] == r1["ranks_main"] == (0.5,)  # rank 0's value on both
    for r in (r0, r1):  # float64 all the way: 2^24 + 1 and + 2 survive
        assert r["gathered"].dtype == np.float64
        np.testing.assert_array_equal(r["gathered"], [[2 ** 24 + 1, 0.25], [2 ** 24 + 2, 0.25]])
    # without a group: rank 0 of 1, and the collectives are local
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    np.testing.assert_array_equal(mesh.allgather_f64([3.0]), [[3.0]])
    assert mesh.broadcast_from_main(1.5) == (1.5,) and not mesh.any_rank(False)


def test_two_rank_step_matches_jax_global_batch(ranks):
    """Each rank's injected rows of t and x_t: the reduced loss and
    gradients equal the JAX package's `value_and_grad` of the global batch,
    within the step's bounds (loss 1e-5, gradients 1e-4 of each tensor's
    largest), and the ranks hold the same bits."""
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_train_loss(ranks.jmodel, p, jax.tree.map(jnp.asarray, ranks.batch),
                                 ranks.key, jnp.ones(C)), has_aux=True))(ranks.jparams)
    r0, r1 = ranks.results()
    assert r0["injected"]["loss"] == r1["injected"]["loss"]
    np.testing.assert_allclose(r0["injected"]["loss"], float(ref_loss), rtol=1e-5)
    ref = flax_params_to_state_dict(jax.device_get(ref_grads))
    assert set(ref) == set(r0["injected"]["grads"])
    for name, g in ref.items():
        assert torch.equal(r0["injected"]["grads"][name], r1["injected"]["grads"][name]), name
        _close_to_max(r0["injected"]["grads"][name], g.numpy(), 1e-4, name)


def test_two_rank_step_matches_the_one_process_step(ranks):
    """The step's own draws: rank p keeps rows p::P of the global batch's
    draws, so loss and gradients equal the one-process step within 1e-5 of
    each tensor's largest (the sum over ranks only reorders fp32
    additions), and both ranks hold the same masters.

    The masters after 3 Adam steps: Adam's normalised step moves a weight
    by up to lr whatever the size of its gradient, so a gradient at its
    rounding floor (the key rows of the qkv bias, 0 in exact arithmetic,
    and the odd element whose terms cancel) moves its weight by a share of
    lr that the order of the sums decides. Every weight is held within
    3 steps x 2 lr, and all but 1e-4 of the weights (the key rows left
    out) within 1e-5 of their tensor's largest."""
    model = build_model(STEP_PARAMS, C, 1, device="cpu")
    model.unet.load_state_dict(torch.load(ranks.root / "step_inputs.pt")["masters"])
    tx, schedule = build_optimizer(STEP_PARAMS, steps_per_epoch=20)
    state = create_train_state(master_params(model.unet), tx, polyak_alpha=0.9)
    step = make_train_step(model, torch.ones(C), schedule)
    batch = {k: torch.from_numpy(v) for k, v in ranks.batch.items()}
    grads, m = step.gradients(state, model.unet, batch, 7)
    for _ in range(3):
        step(state, model.unet, batch, 7)
    r0, r1 = ranks.results()
    np.testing.assert_allclose(r0["own"]["loss"], float(m["loss"]), rtol=1e-5)
    # the least KL is 0 in exact arithmetic (t = 1 pixels): rounding noise,
    # held as tests/test_torch_train_step.py holds it against JAX
    np.testing.assert_allclose(r0["own"]["kl_min"], float(m["kl_min"]), atol=1e-6)
    np.testing.assert_allclose(r0["own"]["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    for name, g in grads.items():
        _close_to_max(r0["own"]["grads"][name], g, 1e-5, name)
    lr = STEP_PARAMS["optim"]["learning_rate"]
    dh = STEP_PARAMS["unet_openai"]["num_head_channels"]
    beyond, total = {}, 0
    for name, v in state.params.items():
        assert torch.equal(r0["masters"][name], r1["masters"][name]), name
        diff = (r0["masters"][name] - v).abs()
        assert float(diff.max()) <= 3 * 2 * lr, name
        if name.endswith("qkv.bias"):
            diff = diff[(torch.arange(v.numel()) // dh) % 3 != 1]
        beyond[name] = int((diff > 1e-5 * float(v.abs().max())).sum())
        total += diff.numel()
    assert sum(beyond.values()) <= 1e-4 * total, {k: n for k, n in beyond.items() if n}


def test_two_rank_run_writes_one_checkpoint_and_resumes_at_one_rank(ranks, small_sets,
                                                                     tmp_path):
    """Rank 0 alone writes the step-2 checkpoints and metrics; both ranks
    end with the same state; a SIGTERM on one rank stops both at one step;
    a one-process run resumes from the checkpoint, and its validation
    (`compute_ged`, `validate_miou`) gives the two ranks'."""
    r0, r1 = ranks.results()
    run_dir = ranks.root / "run"
    assert r0["steps_per_epoch"] == r1["steps_per_epoch"] == 16 // RUN_PARAMS["batch_size"]
    for manager in ("model", "best_ged", "best_hmiou"):
        assert sorted(p.name for p in (run_dir / manager).iterdir()) == ["2"], manager
        assert sorted(p.name for p in (run_dir / manager / "2").iterdir()) == \
            (["state.pt"] if manager == "model" else ["score.json", "state.pt"])
    events = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events if e["tag"] == "train"] == [1, 2]
    assert len([e for e in events if e["tag"] == "val"]) == 1
    for key in ("model", "average_model"):
        for name, v in r0["state"][key].items():
            assert torch.equal(v, r1["state"][key][name]), (key, name)
    # a SIGTERM on rank 1 alone stops both ranks at the same step, saved once
    assert r0["stopped_at"] == r1["stopped_at"] == 1
    assert sorted(p.name for p in (ranks.root / "stop" / "model").iterdir()) == ["1"]
    run = TrainingRun(dict(RUN_PARAMS, mesh={"data": 1}, load_from=str(run_dir),
                           output_path=str(tmp_path / "resumed")), device="cpu")
    assert run.state.step == 2
    for name, v in r0["state"]["model"].items():
        assert torch.equal(run.state.params[name], v), name
    ged = compute_ged(run.model, run.ema_unet(), run.val_ds, 2, 3,
                      step_seed(5, run.state.step), sampler=run._sampler(2))
    np.testing.assert_allclose(r0["ged"], ged, rtol=1e-6)
    assert r1["ged"] == r0["ged"] == r0["ged_explicit"] == r1["ged_explicit"]
    miou = run.validate_miou(max_images=3)
    assert r0["miou"] == r1["miou"] == pytest.approx(miou, rel=1e-6)


@pytest.mark.parametrize("job", ["lidc", "cityscapes"])
def test_two_rank_evaluators_equal_one_rank(ranks, small_sets, job, tmp_path, monkeypatch):
    """The LIDC harness (5 images, 3 and 2 a rank, a padded tail) and the
    Cityscapes evaluator (3 images: 2 and 1) give one process's results
    on every rank."""
    r0, r1 = ranks.results()
    if job == "lidc":
        ref = tlu.eval_lidc_uncertainty(dict(LIDC_PARAMS, output_path=str(tmp_path)),
                                        device="cpu")
        saved = json.loads((ranks.root / "lidc" / "lidc_uncertainty_full.json").read_text())
        for k in LIDC_KEYS:
            assert r0["lidc"][k] == r1["lidc"][k] == saved[k] == pytest.approx(ref[k], rel=1e-6), k
        for k in ("IoU", "Dice"):
            np.testing.assert_allclose(r0["lidc"][k], ref[k], rtol=1e-6)
        return
    monkeypatch.setenv("CCDM_CITYSCAPES_PATH", str(ranks.root / "cs"))
    ref = run_inference(_cs_params(tmp_path / "cs_out1"), device="cpu")
    assert r0["cityscapes"]["images"] == r1["cityscapes"]["images"] == ref["images"] == CS_IMAGES
    for r in (r0, r1):
        assert r["cityscapes"]["mIoU"] == pytest.approx(ref["mIoU"], rel=1e-6, nan_ok=True)
        np.testing.assert_allclose(r["cityscapes"]["IoU"], ref["IoU"], rtol=1e-6)
    assert r1["cityscapes"]["official"] is None
    official = r0["cityscapes"]["official"]
    assert official["averageScoreClasses"] == pytest.approx(
        ref["official"]["averageScoreClasses"], rel=1e-6, nan_ok=True)
    for sub in ("submit", "gt", "color"):
        names = sorted(p.name for p in (tmp_path / "cs_out1" / sub).iterdir())
        assert names == sorted(p.name for p in (ranks.root / "cs_out2" / sub).iterdir())
        assert len(names) == CS_IMAGES
        for name in names:
            assert (tmp_path / "cs_out1" / sub / name).read_bytes() == \
                (ranks.root / "cs_out2" / sub / name).read_bytes(), f"{sub}/{name}"


def test_two_rank_harness_equals_jax_under_stubbed_probabilities(ranks, small_sets,
                                                                 monkeypatch, tmp_path):
    """The same probabilities through the JAX harness (one process) and
    the port's over two ranks: every metric agrees."""
    def jax_make(model, num_samples, *args, **kwargs):
        def run(params, images, key, indices=None, feature_params=None):
            return jnp.asarray(stub_probs(np.asarray(indices), num_samples,
                                          *images.shape[1:3], C))
        return run

    monkeypatch.setattr(jlu, "make_prob_sampler", jax_make)
    ref = jlu.eval_lidc_uncertainty(dict(LIDC_PARAMS, output_path=str(tmp_path)),
                                    model_params={})
    r0, r1 = ranks.results()
    assert r0["lidc_stub"]["count"] == ref["count"] == LIDC_IMAGES
    for k in LIDC_KEYS:
        assert r0["lidc_stub"][k] == r1["lidc_stub"][k] == pytest.approx(
            ref[k], rel=1e-6, abs=1e-6), k
    for k in ("IoU", "Dice"):
        np.testing.assert_allclose(r0["lidc_stub"][k], ref[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout,error", [({"model": 2}, ValueError),
                                          ({"data": 2}, ValueError),
                                          ({"data": 4, "model": 1}, ValueError)])
def test_meshes_the_port_does_not_run_are_refused(layout, error, tmp_path, small_sets):
    """A mesh whose data x model is not the world size (1 here: no process
    group): a model axis the one-process world cannot hold, and a data
    axis other than the world size."""
    with pytest.raises(error, match="mesh"):
        TrainingRun(dict(RUN_PARAMS, mesh=layout, output_path=str(tmp_path)), device="cpu")


def _init_without_a_card(monkeypatch):
    """torchrun's variables set, no card, the CPU not asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(var, value)
    mesh.init_distributed()


def _gather_over_a_missing_group(monkeypatch):
    """Two ranks' slicing asked of `compute_ged` outside a process group."""
    compute_ged(None, None, [], 2, 1, process_index=0, process_count=2)


@pytest.mark.parametrize("setup,error,match", [
    (_init_without_a_card, RuntimeError, "no CUDA device"),
    (_gather_over_a_missing_group, ValueError, "process_count 2"),
])
def test_setups_that_would_leave_a_rank_off_its_card_or_ungathered_are_refused(
        setup, error, match, monkeypatch):
    """`init_distributed` without a card trains on no CPU unasked (a rank
    that fell back alone would pick gloo beside the others' nccl), and
    `compute_ged` refuses a rank count its process group does not have."""
    with pytest.raises(error, match=match):
        setup(monkeypatch)
    assert not torch.distributed.is_initialized()

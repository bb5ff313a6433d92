"""The port's tensor parallelism (the mesh's `model` axis) on the CPU:
the split rule against the JAX package's `param_partition_spec`, and gloo
ranks laid out `{data 1, model 2}` and `{data 2, model 2}` against the JAX
package's unsharded step and the port's one-process step.

Both layouts' rank processes (`tests/torch_tp_worker.py`) start once for
the module and run beside this process, which computes the references."""

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

from ccdm_tpu.diffusion.categorical import q_xt_given_x0_probs as jax_q
from ccdm_tpu.diffusion.categorical import sample_onehot as jax_sample_onehot
from ccdm_tpu.models.builder import build_model as jax_build_model
from ccdm_tpu.models.dino import DinoFeatureEncoder as JaxDino
from ccdm_tpu.parallel.mesh import MODEL_AXIS, param_partition_spec
from ccdm_tpu.train.step import train_loss as jax_train_loss
from ccdm_tpu_torch import CITYSCAPES_DINO_TRAIN_PARAMS, DEMO_TRAIN_PARAMS
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.convert import flax_dino_to_state_dict, flax_params_to_state_dict
from ccdm_tpu_torch.models.dino import DinoFeatureEncoder
from ccdm_tpu_torch.parallel import mesh
from ccdm_tpu_torch.parallel.tensor import shard_modules
from ccdm_tpu_torch.train.optimizer import build_optimizer
from ccdm_tpu_torch.train.state import create_train_state, master_params
from ccdm_tpu_torch.train.step import make_train_step
from ccdm_tpu_torch.train.trainer import TrainingRun
from torch_parallel_worker import shrink_synthetic
from torch_port_util import TINY_PARAMS, load_port_weights, unzero

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
LAYOUTS = ((1, 2), (2, 2))  # (data, model)
B, H, W, C = 4, 16, 16, 2  # the global batch: 2 rows a data index at data 2
ADAM_STEPS = 2

# base 64 (no GroupNorm group of one channel, as tests/test_torch_parallel.py),
# so the 64- and 128-wide convs, the 256-wide time MLP and the qkv split
STEP_PARAMS = dict(TINY_PARAMS, polyak_alpha=0.9, max_epochs=1,
                   unet_openai=dict(TINY_PARAMS["unet_openai"], base_channels=64,
                                    num_head_channels=32),
                   optim={"name": "Adam", "learning_rate": 1e-4, "lr_function": "polynomial",
                          "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 1})
# base 8: every leaf narrower than the rule's 64, so nothing splits
NARROW_PARAMS = dict(STEP_PARAMS, unet_openai=dict(TINY_PARAMS["unet_openai"], base_channels=8,
                                                   num_head_channels=4))
RUN_PARAMS = {
    "dataset_file": "ccdm_tpu.data.synthetic", "batch_size": 4, "samples": 2,
    "max_epochs": 1, "time_steps": 4, "beta_schedule": "cosine", "polyak_alpha": 0.9,
    "compute_dtype": "float32",
    "unet_openai": {"base_channels": 64, "channel_mult": [1, 2], "attention_resolutions": [2],
                    "num_head_channels": 32},
    "optim": {"name": "Adam", "learning_rate": 1e-4, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 1},
    "display_freq": 1, "save_freq": 2, "validation_freq": 2, "dataset_val_max_size": 4,
    "validation_max_batches": 1, "n_validation_images": 1, "n_validation_predictions": 1,
    "progress_bar": False, "mesh": {"data": 1, "model": 2},
}


# ---- (a) the rule, without processes ------------------------------------


def _flax_split(tree, model: int):
    """The flax leaves `param_partition_spec` splits: path -> True."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): MODEL_AXIS in param_partition_spec(path, leaf, model)
            for path, leaf in flat}


def _marked(tree, split):
    """`tree` with each split leaf replaced by its trailing-dim index
    (0, 1, 2, ... broadcast) and every other leaf by -1: after the
    converter, the port's split dim is where the index runs."""
    def mark(path, leaf):
        key = tuple(k.key for k in path)
        if not split[key]:
            return np.full(leaf.shape, -1, np.float32)
        return np.broadcast_to(np.arange(leaf.shape[-1], dtype=np.float32), leaf.shape).copy()
    return jax.tree_util.tree_map_with_path(mark, tree)


def _expected_dims(state_dict):
    dims = {}
    for name, v in state_dict.items():
        if (v < 0).all():
            continue
        for dim in range(v.dim()):
            idx = torch.arange(v.shape[dim], dtype=torch.float32).reshape(
                [-1 if d == dim else 1 for d in range(v.dim())])
            if v.shape[dim] > 1 and torch.equal(v, idx.expand_as(v)):
                dims[name] = dim
    return dims


def _cityscapes_trees():
    """The Cityscapes-DINO config with DINO trainable: the JAX UNet's and
    encoder's shapes, each with its converter, and a maker of the port's
    module (CPU) and its master prefix."""
    params = dict(CITYSCAPES_DINO_TRAIN_PARAMS, feature_cond_encoder=dict(
        CITYSCAPES_DINO_TRAIN_PARAMS["feature_cond_encoder"], train=True))
    fce = params["feature_cond_encoder"]
    jmodel = jax_build_model(params, num_classes=20, image_channels=3, image_size=128)
    shape = (128, 256, 3)
    unet = jax.eval_shape(lambda k: jmodel.init(k, shape, feature_shape=(16, 32, 384)),
                          jax.random.PRNGKey(0))
    enc = jax.eval_shape(lambda k: JaxDino(fce).init(k, shape), jax.random.PRNGKey(7))
    return [(unet, flax_params_to_state_dict,
             lambda: build_model(params, 20, 3, 128, device="cpu").unet, "unet."),
            (enc, flax_dino_to_state_dict,
             lambda: DinoFeatureEncoder(fce).init(device="cpu"), "encoder.")]


def _flagship_trees():
    jmodel = jax_build_model(DEMO_TRAIN_PARAMS, num_classes=2, image_channels=1,
                             image_size=128)
    unet = jax.eval_shape(lambda k: jmodel.init(k, (128, 128, 1)), jax.random.PRNGKey(0))
    return [(unet, flax_params_to_state_dict,
             lambda: build_model(DEMO_TRAIN_PARAMS, 2, 1, 128, device="cpu").unet, "")]


@pytest.mark.parametrize("config", ["flagship", "cityscapes_dino_trainable"])
def test_split_leaves_and_dims_equal_jax_partition_spec(config, ranks):
    """At model 1, 2 and 4, `shard_modules` splits exactly the leaves that
    `param_partition_spec` shards, each on the dim that holds flax's
    trailing one (found by carrying an index along it through the
    converter), and keeps 1/model of each; nothing splits at model 1.
    (`ranks` only starts the rank processes, which run meanwhile.)"""
    trees = _flagship_trees() if config == "flagship" else _cityscapes_trees()
    for model in (1, 2, 4):
        layout = mesh.Mesh(mesh.MeshConfig(data=1, model=model), 0, 0)
        total = 0
        for tree, convert, make, prefix in trees:
            split = _flax_split(tree, model)
            want = {prefix + k: d for k, d in _expected_dims(convert(_marked(tree, split))).items()}
            net = make()
            whole = {prefix + k: tuple(v.shape) for k, v in net.named_parameters()}
            got = shard_modules(net, layout, prefix)
            assert got == want, (config, model, sorted(set(got) ^ set(want))[:5])
            for name, p in net.named_parameters():
                shape = list(whole[prefix + name])
                if prefix + name in got:
                    shape[got[prefix + name]] //= model
                assert tuple(p.shape) == tuple(shape), (name, model)
            total += len(got)
        assert (total == 0) == (model == 1), (config, model, total)


# ---- (b), (c) gloo ranks -------------------------------------------------


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
    """Both layouts' rank processes, started once for the module."""

    def __init__(self, root: Path):
        self.root = root
        self.jmodel, self.jparams, self.batch, self.key, self.t, self.xt = _step_inputs()
        model = build_model(STEP_PARAMS, C, 1, device="cpu")
        load_port_weights(model.unet, self.jparams)
        self.masters = model.unet.state_dict()
        torch.save({"masters": self.masters, "t": self.t, "xt": self.xt,
                    "batch": {k: torch.from_numpy(v) for k, v in self.batch.items()}},
                   root / "step_inputs.pt")
        narrow = build_model(NARROW_PARAMS, C, 1, device="cpu")
        self.narrow = narrow.unet.state_dict()
        torch.save({"masters": self.narrow, "t": self.t, "xt": self.xt,
                    "batch": {k: torch.from_numpy(v) for k, v in self.batch.items()}},
                   root / "narrow_inputs.pt")
        spec = {"dir": str(root), "step_params": STEP_PARAMS, "narrow_params": NARROW_PARAMS,
                "run_params": dict(RUN_PARAMS, output_path=str(root / "run"))}
        (root / "spec.json").write_text(json.dumps(spec))
        self.procs = []
        for data, model in LAYOUTS:
            with socket.socket() as s:  # a free port for each group's rendezvous
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            for rank in range(data * model):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE=str(data * model), MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port), OMP_NUM_THREADS="1")
                log = open(root / f"{data}x{model}_rank{rank}.log", "w")
                self.procs.append((subprocess.Popen(
                    [sys.executable, str(HERE / "torch_tp_worker.py"), str(root), str(data),
                     str(model)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
        self._results = None

    def results(self):
        """Every rank's results by layout, once all exit 0."""
        if self._results is None:
            deadline = time.monotonic() + 300
            while any(p.poll() is None for p, _ in self.procs) and \
                    not any(p.poll() for p, _ in self.procs) and time.monotonic() < deadline:
                time.sleep(0.2)
            rcs = [p.poll() for p, _ in self.procs]
            self.close()
            logs = "\n".join(f.read_text()[-3000:] for f in sorted(self.root.glob("*.log")))
            assert all(rc == 0 for rc in rcs), f"exit codes {rcs}\n{logs}"
            self._results = {(d, m): [torch.load(self.root / f"{d}x{m}_rank{r}.pt",
                                                 weights_only=False) for r in range(d * m)]
                             for d, m in LAYOUTS}
        return self._results

    def close(self):
        for proc, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("tp_ranks"))
    yield r
    r.close()


def _one_process(ranks):
    """The port's one-process step on the global batch: the loss, grad norm
    and gradients under the injected draws, and the masters after
    `ADAM_STEPS` steps with the step's own draws."""
    model = build_model(STEP_PARAMS, C, 1, device="cpu")
    model.unet.load_state_dict(ranks.masters)
    tx, schedule = build_optimizer(STEP_PARAMS, steps_per_epoch=20)
    state = create_train_state(master_params(model.unet), tx, polyak_alpha=0.9)
    step = make_train_step(model, torch.ones(C), schedule)
    batch = {k: torch.from_numpy(v) for k, v in ranks.batch.items()}
    grads, m = step.gradients(state, model.unet, batch, 0, t=ranks.t, xt=ranks.xt)
    for _ in range(ADAM_STEPS):
        step(state, model.unet, batch, 7)
    return float(m["loss"]), float(m["grad_norm"]), grads, state.tree()


def _err_to_max(ours, ref):
    return float((ours - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _adam_close(ours, ref, rel: float, steps: int, params) -> None:
    """Masters after `steps` Adam steps against a reference: every weight
    within steps x 2 lr (Adam moves a weight by up to lr whatever its
    gradient's size, so a gradient at its rounding floor moves by a share
    of lr that the order of the sums decides: the zero-initialised convs
    show it most), and all but 1e-4 of the weights (the key rows of the qkv
    bias, zero gradients in exact arithmetic, left out) within `rel` of
    their tensor's largest."""
    lr, dh = params["optim"]["learning_rate"], params["unet_openai"]["num_head_channels"]
    beyond, total = {}, 0
    for name, v in ref.items():
        diff = (ours[name] - v).abs()
        assert float(diff.max()) <= steps * 2 * lr, name
        if name.endswith("qkv.bias"):
            diff = diff[(torch.arange(v.numel()) // dh) % 3 != 1]
        beyond[name] = int((diff > rel * float(v.abs().max())).sum())
        total += diff.numel()
    assert sum(beyond.values()) <= 1e-4 * total, {k: n for k, n in beyond.items() if n}


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"data{l[0]}_model{l[1]}")
def test_tp_step_loss_matches_jax_unsharded_step(ranks, layout):
    """Each data index's rows of the injected `t` and `x_t`: the reduced
    loss equals the JAX package's loss of the global batch (unsharded) at
    rtol 1e-4, as the JAX package's own 4x2 mesh test holds its step."""
    loss, _ = jax.jit(lambda p: jax_train_loss(
        ranks.jmodel, p, jax.tree.map(jnp.asarray, ranks.batch), ranks.key,
        jnp.ones(C)))(ranks.jparams)
    for r in ranks.results()[layout]:
        np.testing.assert_allclose(r["injected"]["loss"], float(loss), rtol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"data{l[0]}_model{l[1]}")
def test_tp_gradients_and_masters_match_one_process(ranks, layout):
    """The gathered gradients (and the global `grad_norm`) against the
    port's one-process step at 1e-4 of each tensor's largest. The masters
    after 2 Adam steps, gathered: every weight within 2 steps x 2 lr of
    one process's (Adam moves a weight by up to lr whatever its gradient's
    size, so a gradient at its rounding floor moves by a share of lr that
    the order of the sums decides), and all but 1e-4 of the weights (the
    key rows of the qkv bias, zero gradients in exact arithmetic, left out)
    within 1e-4 of their tensor's largest. Whole leaves' masters are
    bit-equal on every rank; each split master holds 1/model of its leaf."""
    ref_loss, ref_norm, ref_grads, ref_tree = _one_process(ranks)
    results = ranks.results()[layout]
    data, model = layout
    for r in results:
        assert (r["data_index"], r["model_index"]) == (r["rank"] // model, r["rank"] % model)
        assert r["counts"] == layout
        np.testing.assert_allclose(r["injected"]["grad_norm"], ref_norm, rtol=1e-4)
        grads = r["injected"]["grads"]
        assert set(grads) == set(ref_grads)
        for name, g in ref_grads.items():
            assert _err_to_max(grads[name], g) <= 1e-4, name
        _adam_close(r["tree"]["model"], ref_tree["model"], 1e-4, ADAM_STEPS, STEP_PARAMS)
        split = r["split"]
        assert split and all(d == 0 for d in split.values())
        for name, v in r["local"].items():
            whole = ref_tree["model"][name]
            if name in split:
                assert v.numel() * model == whole.numel(), name
                share = whole.shape[0] // model
                assert torch.equal(r["tree"]["model"][name].narrow(0, r["model_index"] * share,
                                                                   share), v), name
            else:
                assert torch.equal(v, results[0]["local"][name]), name
        for key in ("model", "average_model"):  # the gathered trees agree on every rank
            for name, v in r["tree"][key].items():
                assert torch.equal(v, results[0]["tree"][key][name]), (key, name)


def test_tp_step_with_use_checkpoint_equals_one_process(ranks):
    """`use_checkpoint` on over {data 1, model 2}: every ResBlock and
    attention block recomputed in the backward, its split convs gathering
    again. The loss, `grad_norm` and gathered gradients against the port's
    one-process step (no ResBlock remat) at 1e-4, the tolerance of the step
    without it (the split sums round apart from one process's)."""
    ref_loss, ref_norm, ref_grads, _ = _one_process(ranks)
    for r in ranks.results()[(1, 2)]:
        np.testing.assert_allclose(r["remat"]["loss"], ref_loss, rtol=1e-5)
        np.testing.assert_allclose(r["remat"]["grad_norm"], ref_norm, rtol=1e-4)
        assert set(r["remat"]["grads"]) == set(ref_grads)
        for name, g in ref_grads.items():
            assert _err_to_max(r["remat"]["grads"][name], g) <= 1e-4, name


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"data{l[0]}_model{l[1]}")
def test_tp_step_with_nothing_split_equals_one_process(ranks, layout):
    """A UNet too narrow for the rule over the same meshes: nothing splits,
    every rank of a model group computes the whole step on its data rows,
    and the reduction (over all ranks, divided by the world size) gives one
    process's loss at 1e-5 and gradients at 1e-5 of each tensor's largest."""
    model = build_model(NARROW_PARAMS, C, 1, device="cpu")
    model.unet.load_state_dict(ranks.narrow)
    tx, schedule = build_optimizer(NARROW_PARAMS, steps_per_epoch=20)
    state = create_train_state(master_params(model.unet), tx)
    step = make_train_step(model, torch.ones(C), schedule)
    batch = {k: torch.from_numpy(v) for k, v in ranks.batch.items()}
    ref, m = step.gradients(state, model.unet, batch, 0, t=ranks.t, xt=ranks.xt)
    for r in ranks.results()[layout]:
        assert r["narrow"]["split"] == {}
        np.testing.assert_allclose(r["narrow"]["loss"], float(m["loss"]), rtol=1e-5)
        for name, g in ref.items():
            assert _err_to_max(r["narrow"]["grads"][name], g) <= 1e-5, name


def test_tp_checkpoint_loads_at_model_1_and_validation_equals_one_process(ranks, tmp_path,
                                                                          monkeypatch):
    """The `{data 1, model 2}` run's step-2 checkpoint (written by rank 0
    from the gathered state) loads into a one-process `TrainingRun` at
    model 1 bit for bit and equals a one-process run of the same 2 steps
    within 1e-5 of each tensor's largest (below); the ranks' validation (GED,
    diversity, HM-IoU with the whole EMA gathered on every rank) equals the
    one-process run's on that checkpoint at 1e-6. Against the one-process
    run the masters and the EMA are held as `_adam_close` says, at 1e-5."""
    import ccdm_tpu_torch.data.synthetic as tsyn

    for name in ("training_dataset", "validation_dataset", "test_dataset"):
        monkeypatch.setattr(tsyn, name, getattr(tsyn, name))
    shrink_synthetic()
    results = ranks.results()[(1, 2)]
    r0 = results[0]
    saved = ranks.root / "run" / "model" / "2" / "state.pt"
    assert sorted(p.name for p in (ranks.root / "run" / "model").iterdir()) == ["2"]
    assert r0["run_split"] and r0["run_local"] != {
        k: tuple(v.shape) for k, v in r0["run_tree"]["model"].items()}
    one = dict(RUN_PARAMS, mesh={"model": 1})
    run = TrainingRun(dict(one, load_from=str(saved), output_path=str(tmp_path / "load")),
                      device="cpu")
    tree = torch.load(saved, weights_only=False)
    for key in ("model", "average_model"):
        for name, v in tree[key].items():
            target = run.state.params if key == "model" else run.state.ema_params
            assert torch.equal(target[name], v) and torch.equal(r0["run_tree"][key][name], v)
    for moment in ("mu", "nu"):
        for name, v in tree["opt_state"][moment].items():
            assert torch.equal(run.state.opt_state[moment][name], v), (moment, name)
    ref = TrainingRun(dict(one, output_path=str(tmp_path / "one")), device="cpu")
    ref.run(max_steps=2)
    for key, d in (("model", ref.state.params), ("average_model", ref.state.ema_params)):
        _adam_close(tree[key], d, 1e-5, 2, RUN_PARAMS)
    want = run.validate()
    for r in results:
        assert len(r["val"]) == 1
        for k in ("GED", "diversity", "HMIoU"):
            assert r["val"][0][k] == pytest.approx(want[k], rel=1e-6), k


def test_tp_dino_gathered_leaves_match_whole(ranks):
    """A small DINO ViT at `{data 1, model 2}`: `pos_embed` and `cls_token`
    split on their last dim and read whole through the gathering subclass
    (same class name), every conv and linear column parallel; the output
    and the gathered gradients equal the whole net's at 1e-5 of each
    tensor's largest."""
    for r in ranks.results()[(1, 2)]:
        d = r["dino"]
        assert d["type"] == "DinoViT"
        assert d["split"]["pos_embed"] == 2 and d["split"]["cls_token"] == 2
        assert d["split"]["patch_embed.proj.weight"] == 0
        assert _err_to_max(d["out"], d["ref"]) <= 1e-5
        assert set(d["grads"]) == set(d["ref_grads"])
        for name, g in d["ref_grads"].items():
            assert d["grads"][name].shape == g.shape, name
            assert _err_to_max(d["grads"][name], g) <= 1e-5, name

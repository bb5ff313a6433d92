"""One rank of the port's tensor-parallel CPU checks
(`tests/test_torch_tensor_parallel.py`).

    RANK=r WORLD_SIZE=P MASTER_ADDR=127.0.0.1 MASTER_PORT=port \\
        python tests/torch_tp_worker.py <dir> <data> <model>

Joins a `gloo` group, lays the ranks out as a `data x model` mesh, runs the
step jobs (and, with `data == 1`, the remat, DINO and training-run jobs) on the inputs the
test wrote into `<dir>`, and saves this rank's results as
`<dir>/<data>x<model>_rank<r>.pt`. Imports torch, numpy and the port only
(no jax).
"""

import json
import os
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from ccdm_tpu_torch.parallel import mesh  # noqa: E402
from torch_parallel_worker import shrink_synthetic  # noqa: E402

ADAM_STEPS = 2


def narrow_job(spec, layout, out):
    """The step of a UNet too narrow for the rule to split anything, over
    the mesh: the loss and gradients under the injected draws."""
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.parallel.tensor import Sharding, shard_modules
    from ccdm_tpu_torch.train.optimizer import build_optimizer
    from ccdm_tpu_torch.train.state import create_train_state, master_params
    from ccdm_tpu_torch.train.step import make_train_step

    params = spec["narrow_params"]
    inputs = torch.load(Path(spec["dir"]) / "narrow_inputs.pt")
    model = build_model(params, 2, 1, device="cpu")
    model.unet.load_state_dict(inputs["masters"])
    split = shard_modules(model.unet, layout)
    d, n = layout.data_index, layout.data_count
    rows = {k: v[d::n] for k, v in inputs["batch"].items()}
    tx, schedule = build_optimizer(params, steps_per_epoch=20)
    state = create_train_state(master_params(model.unet), tx)
    step = make_train_step(model, torch.ones(2), schedule, sharding=Sharding(split, layout))
    grads, m = step.gradients(state, model.unet, rows, 0, t=inputs["t"][d::n],
                              xt=inputs["xt"][d::n])
    out["narrow"] = {"split": split, "loss": float(m["loss"]), "grads": grads}


def _mesh_step(params, inputs, layout):
    """The model of `params` with the test's whole masters, split over the
    mesh, and its step's loss and gradients (this rank's shares gathered
    whole) under the injected draws of this rank's data rows: `(model,
    sharding, state, step, rows, metrics, gathered gradients)`."""
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.parallel.tensor import Sharding, shard_modules
    from ccdm_tpu_torch.train.optimizer import build_optimizer
    from ccdm_tpu_torch.train.state import create_train_state, master_params
    from ccdm_tpu_torch.train.step import make_train_step

    model = build_model(params, 2, 1, device="cpu")
    model.unet.load_state_dict(inputs["masters"])
    sharding = Sharding(shard_modules(model.unet, layout), layout)
    d, n = layout.data_index, layout.data_count
    rows = {k: v[d::n] for k, v in inputs["batch"].items()}
    tx, schedule = build_optimizer(params, steps_per_epoch=20)
    state = create_train_state(master_params(model.unet), tx, polyak_alpha=0.9,
                               sharding=sharding)
    step = make_train_step(model, torch.ones(2), schedule, sharding=sharding)
    grads, m = step.gradients(state, model.unet, rows, 0, t=inputs["t"][d::n],
                              xt=inputs["xt"][d::n])
    gathered = {**grads, **sharding.gather({k: grads[k] for k in sharding.dims})}
    return model, sharding, state, step, rows, m, gathered


def step_job(spec, layout, out):
    """The step over the mesh from the test's whole masters: the loss and
    the gathered gradients under the injected draws of this rank's data
    rows, then the state after `ADAM_STEPS` steps with the step's own draws
    (gathered whole, and this rank's own shares and whole leaves)."""
    inputs = torch.load(Path(spec["dir"]) / "step_inputs.pt")
    model, sharding, state, step, rows, m, grads = _mesh_step(spec["step_params"], inputs,
                                                              layout)
    out["split"] = dict(sharding.dims)
    out["injected"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                       "grads": grads}
    for _ in range(ADAM_STEPS):
        step(state, model.unet, rows, 7)
    out["local"] = {k: v.clone() for k, v in state.params.items()}
    out["tree"] = state.tree()


def remat_job(spec, layout, out):
    """The step of `step_job` with `use_checkpoint` on: every ResBlock (and,
    by default, every attention block) recomputed in the backward, its
    split convs gathering again. The loss and the gathered gradients under
    the injected draws."""
    params = dict(spec["step_params"],
                  unet_openai=dict(spec["step_params"]["unet_openai"], use_checkpoint=True))
    inputs = torch.load(Path(spec["dir"]) / "step_inputs.pt")
    *_, m, grads = _mesh_step(params, inputs, layout)
    out["remat"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "grads": grads}


def dino_job(layout, out):
    """A small DINO ViT split over the model axis (its patch conv, qkv,
    projections and MLP column parallel, `pos_embed` and `cls_token`
    gathered where it reads them) against the same net whole, in this
    process: the output, and the split net's gradients gathered whole
    against the whole net's."""
    from ccdm_tpu_torch.models.dino import DinoViT
    from ccdm_tpu_torch.parallel.tensor import Sharding, shard_modules

    torch.manual_seed(3)
    whole = DinoViT(64, 2, 2, 8, 4, source_layer=1, facet="token", pretrain_size=32)
    with torch.no_grad():  # the zero-initialised tokens redrawn
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape) * 0.2)
    split = DinoViT(64, 2, 2, 8, 4, source_layer=1, facet="token", pretrain_size=32)
    split.load_state_dict(whole.state_dict())
    dims = shard_modules(split, layout)
    images = torch.randn(2, 24, 24, 3)
    ref = whole(images)
    ours = split(images)
    ref.square().sum().backward()
    ours.square().sum().backward()
    grads = {k: p.grad for k, p in split.named_parameters()}
    grads.update(Sharding(dims, layout).gather({k: grads[k] for k in dims}))
    out["dino"] = {"split": dims, "out": ours.detach(), "ref": ref.detach(),
                   "grads": grads, "ref_grads": {k: p.grad for k, p in whole.named_parameters()},
                   "type": type(split).__name__}


def run_job(spec, out):
    """A 2-step `TrainingRun` over the mesh with a GED validation and a
    save at step 2."""
    from ccdm_tpu_torch.train.trainer import TrainingRun

    run = TrainingRun(spec["run_params"], device="cpu")
    scores = []
    validate = run.validate
    run.validate = lambda: scores.append(validate()) or scores[-1]
    run.run(max_steps=2)
    out["val"] = scores
    out["run_tree"] = run.state.tree()
    out["run_local"] = {k: tuple(v.shape) for k, v in run.state.params.items()}
    out["run_split"] = dict(run.sharding.dims)


def main():
    root, data, model = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    spec = json.loads((root / "spec.json").read_text())
    torch.set_num_threads(1)
    shrink_synthetic()
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    layout = mesh.make_mesh(mesh.MeshConfig(data=data, model=model))
    out = {"rank": mesh.process_index(), "data_index": mesh.data_index(),
           "model_index": mesh.model_index(), "counts": (mesh.data_count(), mesh.model_count())}
    step_job(spec, layout, out)
    narrow_job(spec, layout, out)
    if data == 1:
        remat_job(spec, layout, out)
        dino_job(layout, out)
        run_job(spec, out)
    torch.save(out, root / f"{data}x{model}_rank{mesh.process_index()}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()

"""One rank of the port's data-parallel CPU checks (`tests/test_torch_parallel.py`).

    RANK=r WORLD_SIZE=P MASTER_ADDR=127.0.0.1 MASTER_PORT=port \\
        python tests/torch_parallel_worker.py <dir>

Joins a `gloo` group through `parallel.mesh.init_distributed("cpu")`, runs
every job below on the inputs the test wrote into `<dir>`, and saves this
rank's results as `<dir>/rank<r>.pt`. Imports torch, numpy and the port
only (no jax).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import ccdm_tpu_torch.data.synthetic as syn  # noqa: E402
from ccdm_tpu_torch.parallel import mesh  # noqa: E402

LIDC_IMAGES = 5  # two ranks take 3 and 2: unequal shares, a padded tail


def shrink_synthetic():
    """The synthetic sets at test size (train 16, val 4, test 5, 32x32)."""
    syn.training_dataset = lambda: syn.synthetic_training_dataset(n=16, resolution=32)
    syn.validation_dataset = lambda max_size=4: syn.synthetic_test_dataset(n=4, resolution=32)
    syn.test_dataset = lambda max_size=None, indices=None: syn.synthetic_test_dataset(
        n=LIDC_IMAGES, resolution=32)


def stub_probs(indices, samples, h, w, c):
    """Dirichlet probability maps keyed on each image's global index (the
    stub `test_torch_eval_harness.py` hands both packages' harnesses)."""
    return np.stack([np.random.default_rng(1000 + int(i)).dirichlet(
        np.full(c, 0.5), size=(samples, h, w)).astype(np.float32) for i in indices])


def stubbed_sampler(model, num_samples, *args, **kwargs):
    def run(net, images, key=0, indices=None, *, feature_net=None):
        return torch.from_numpy(stub_probs(indices, num_samples, *images.shape[1:3], 2))
    return run


def train_step_job(spec, out):
    """The data-parallel step on this rank's rows of the global batch: the
    gradients with injected draws, the gradients with the step's own draws,
    then the masters after 3 Adam steps."""
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.train.optimizer import build_optimizer
    from ccdm_tpu_torch.train.state import create_train_state, master_params
    from ccdm_tpu_torch.train.step import make_train_step

    p, n = mesh.process_index(), mesh.process_count()
    params = spec["step_params"]
    inputs = torch.load(Path(spec["dir"]) / "step_inputs.pt")
    model = build_model(params, 2, 1, device="cpu")
    model.unet.load_state_dict(inputs["masters"])
    rows = {k: v[p::n] for k, v in inputs["batch"].items()}
    tx, schedule = build_optimizer(params, steps_per_epoch=20)
    state = create_train_state(master_params(model.unet), tx, polyak_alpha=0.9)
    step = make_train_step(model, torch.ones(2), schedule)
    grads, m = step.gradients(state, model.unet, rows, 0, t=inputs["t"][p::n],
                              xt=inputs["xt"][p::n])
    out["injected"] = {"loss": float(m["loss"]), "grads": grads}
    grads, m = step.gradients(state, model.unet, rows, 7)
    out["own"] = {"loss": float(m["loss"]), "grads": grads, "kl_min": float(m["kl_min"]),
                  "grad_norm": float(m["grad_norm"])}
    for _ in range(3):
        step(state, model.unet, rows, 7)
    out["masters"] = {k: v.clone() for k, v in state.params.items()}


def training_run_job(spec, out):
    """A 2-step `TrainingRun` with a validation and a save at step 2; then
    `compute_ged` (with the group's rank and size, and with them given) and
    `validate_miou` on its EMA."""
    from ccdm_tpu_torch.eval.ged_eval import compute_ged
    from ccdm_tpu_torch.train.step import step_seed
    from ccdm_tpu_torch.train.trainer import TrainingRun

    run = TrainingRun(spec["run_params"], device="cpu")
    run.run(max_steps=2)
    out["state"] = run.state.tree()
    out["steps_per_epoch"] = run.steps_per_epoch
    out["ged"] = compute_ged(run.model, run.ema_unet(), run.val_ds, 2, 3,
                             step_seed(5, run.state.step), sampler=run._sampler(2))
    out["ged_explicit"] = compute_ged(run.model, run.ema_unet(), run.val_ds, 2, 3,
                                      step_seed(5, run.state.step), sampler=run._sampler(2),
                                      process_index=mesh.process_index(),
                                      process_count=mesh.process_count())
    out["miou"] = run.validate_miou(max_images=3)


def sigterm_job(spec, out):
    """A SIGTERM on rank 1 during step 1 of a 4-step run: both ranks stop
    at step 1 and save it together."""
    import signal

    from ccdm_tpu_torch.train.trainer import TrainingRun

    run = TrainingRun(dict(spec["run_params"], output_path=os.path.join(spec["dir"], "stop"),
                           validation_freq=100, save_freq=100), device="cpu")
    step_fn = run.step_fn

    def step(*args, **kwargs):
        metrics = step_fn(*args, **kwargs)
        if mesh.process_index() == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    run.step_fn = step
    out["stopped_at"] = run.run(max_steps=4).step


def harness_job(spec, out):
    """The LIDC harness with the model's sampler and with the stub."""
    import ccdm_tpu_torch.eval.lidc_uncertainty as tlu

    out["lidc"] = tlu.eval_lidc_uncertainty(
        dict(spec["lidc_params"], output_path=os.path.join(spec["dir"], "lidc")), device="cpu")
    real = tlu.make_prob_sampler
    tlu.make_prob_sampler = stubbed_sampler
    try:
        out["lidc_stub"] = tlu.eval_lidc_uncertainty(dict(spec["lidc_params"], batch_size=2),
                                                     device="cpu")
    finally:
        tlu.make_prob_sampler = real


def cityscapes_job(spec, out):
    from ccdm_tpu_torch.eval.cityscapes_eval import run_inference

    os.environ["CCDM_CITYSCAPES_PATH"] = spec["cityscapes_root"]
    out["cityscapes"] = run_inference(spec["cityscapes_params"], device="cpu")


def main():
    spec = json.loads((Path(sys.argv[1]) / "spec.json").read_text())
    torch.set_num_threads(2)
    shrink_synthetic()
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    out = {"rank": mesh.process_index(), "count": mesh.process_count(),
           "host_slice": mesh.host_slice(7), "ranks_main": mesh.broadcast_from_main(
               mesh.process_index() + 0.5)}
    # an integer past 2^24 (float32 would round it) from each rank
    out["gathered"] = mesh.allgather_f64([2 ** 24 + 1 + mesh.process_index(), 0.25])
    for job in (train_step_job, training_run_job, sigterm_job, harness_job, cityscapes_job):
        job(spec, out)
    torch.save(out, Path(spec["dir"]) / f"rank{mesh.process_index()}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""Port parity: `ccdm_tpu_torch.core.schedules` against `ccdm_tpu.core.schedules`."""

import numpy as np
import pytest
import torch

from ccdm_tpu.core.schedules import make_schedule as jax_make_schedule
from ccdm_tpu_torch.core.schedules import make_schedule

torch.set_num_threads(2)

FIELDS = ("betas", "alphas", "cumalphas", "alphas_eff", "cumalphas_prev")


@pytest.mark.parametrize("name,steps,params", [
    ("cosine", 250, None),
    ("cosine", 250, {"s": 0.008}),
    ("cosine", 1000, {"s": 0.5}),   # s is overridden to 0.008 by both
    ("linear", 250, None),
    ("linear", 100, {"start": 1e-3, "end": 0.05}),
])
def test_schedule_arrays_match_jax(name, steps, params):
    ours = make_schedule(name, steps, params)
    ref = jax_make_schedule(name, steps, params)
    assert ours.time_steps == ref.time_steps == steps
    for field in FIELDS:
        a = getattr(ours, field)
        assert a.dtype == torch.float32 and a.shape == (steps,)
        # both round the same float64 values to float32: 1e-7 is a bound,
        # the arrays are in fact identical
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(ref, field)),
                                   atol=1e-7, rtol=0, err_msg=field)


def test_boundary_baked_in():
    s = make_schedule("cosine", 250)
    assert float(s.alphas_eff[0]) == 0.0 and float(s.cumalphas_prev[0]) == 1.0
    assert float(s.betas.max()) <= 0.999 + 1e-7
    torch.testing.assert_close(s.cumalphas_prev[1:], s.cumalphas[:-1], rtol=0, atol=0)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown beta schedule"):
        make_schedule("sqrt", 10)

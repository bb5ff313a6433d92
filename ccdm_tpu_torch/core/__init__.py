from ccdm_tpu_torch.core.schedules import (
    Schedule,
    cosine_schedule,
    linear_schedule,
    make_schedule,
)

__all__ = ["Schedule", "linear_schedule", "cosine_schedule", "make_schedule"]

"""The LIDC sampler's share of the card's bf16 dense peak over its traced window:
the model FLOPs of the UNet calls (and of DINO's keys) it completed
(`drivers/sampling.mfu`)."""

from benchmark.drivers.sampling import mfu


def read(run):
    return mfu(run)

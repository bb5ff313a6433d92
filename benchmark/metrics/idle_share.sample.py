"""The share of the LIDC sampler's traced window in which no operation ran on
the device (`drivers/sampling.idle_share`)."""

from benchmark.drivers.sampling import idle_share


def read(run):
    return idle_share(run)

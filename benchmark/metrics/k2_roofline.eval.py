"""K2, the GroupNorm forward kernel family, in the Cityscapes evaluator's traced calls:
the summed least time of every GroupNorm site (bytes counted once, sites
worked out from the configuration) over the family's kernel time
(`drivers/sampling.roofline`)."""

from benchmark.drivers.sampling import roofline


def read(run):
    return roofline(run, "k2")

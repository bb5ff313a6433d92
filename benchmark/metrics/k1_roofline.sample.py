"""K1, the attention kernel, in the LIDC sampler's traced calls: the summed least
time of every attention site (the larger of bytes over 3.35 TB/s and
FLOPs over 989 TFLOP/s) over its kernel time (`drivers/sampling.roofline`)."""

from benchmark.drivers.sampling import roofline


def read(run):
    return roofline(run, "k1")

"""Device-busy milliseconds a reverse step of the LIDC sampler's traced calls
(`drivers/sampling.step_device_ms`)."""

from benchmark.drivers.sampling import step_device_ms


def read(run):
    return step_device_ms(run)

"""Device-busy milliseconds a reverse step of the Cityscapes evaluator's traced calls
(`drivers/sampling.step_device_ms`)."""

from benchmark.drivers.sampling import step_device_ms


def read(run):
    return step_device_ms(run)

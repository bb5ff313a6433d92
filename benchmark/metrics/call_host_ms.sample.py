"""Host milliseconds of a traced call of the LIDC sampler outside its reverse
steps (`spans.call_host_ms`)."""

from benchmark.spans import call_host_ms


def read(run):
    return call_host_ms(run)

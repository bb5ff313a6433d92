"""Chains completed a second: the samples of every whole sampler call in
the window over the time from its start to the last call's end."""


def read(run):
    return run.units / run.window_s if run.unit == "samples" and run.window_s else None

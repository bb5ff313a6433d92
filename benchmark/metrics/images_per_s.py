"""Images evaluated a second: the images of every whole evaluator call in
the window over the time from its start to the last call's end."""


def read(run):
    return run.units / run.window_s if run.unit == "images" and run.window_s else None

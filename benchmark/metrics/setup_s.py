"""Seconds from the process's start to the window's: imports, the kernels'
build or load, the program's and the inputs' making, and the warm-up."""


def read(run):
    return run.setup_s

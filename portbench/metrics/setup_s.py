"""Seconds from the process's start to the window's start: inputs drawn,
the index built, kernels loaded (built on a checkout's first run), every
ladder rung warmed, and the mix's warm-up traffic."""
UNIT, LAYER, SOURCE = "s", "end to end", "host_clock"


def read(run):
    return run.setup_s

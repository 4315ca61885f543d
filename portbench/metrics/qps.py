"""Queries answered in the window over the window's length."""
UNIT, LAYER, SOURCE = "queries/s", "end to end", "host_clock"


def read(run):
    return sum(r.error is None for r in run.in_window) / run.window_s

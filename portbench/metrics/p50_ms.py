"""The median latency of the requests answered in the window, each timed
from when its client sent it (open loop: when it was due) to when its
answer was on the host."""
import numpy as np

UNIT, LAYER, SOURCE = "ms", "end to end", "host_clock"


def read(run):
    lat = run.latencies_ms
    return float(np.percentile(lat, 50)) if lat.size else None

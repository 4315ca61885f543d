"""The 95th percentile latency of the requests answered in the window,
timed as ``p50_ms`` times them."""
import numpy as np

UNIT, LAYER, SOURCE = "ms", "end to end", "host_clock"


def read(run):
    lat = run.latencies_ms
    return float(np.percentile(lat, 95)) if lat.size else None

"""The whole search's share of the chip's peak: the sum, over the
window's searches, of each one's least time at the published peaks (all
its kernels' work: ``roofline``), over the traced window's length."""
UNIT, LAYER, SOURCE = "%", "the whole search", "device_trace"


def read(run):
    if run.trace is None or not run.window_searches():
        return None
    return 100.0 * run.least_s() / run.trace.window_s

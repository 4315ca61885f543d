"""``hamming_maxsim``'s least time for the window's searches over its
device time in the trace, in percent."""
UNIT, LAYER, SOURCE = "%", "kernels: kernels/hamming", "device_trace"


def read(run):
    return run.kernel_roofline_pct("hamming_maxsim")

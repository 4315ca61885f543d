"""``quantized_maxsim``'s least time for the window's searches (their
work at the published peaks: ``roofline``) over its device time in the
trace, in percent."""
UNIT, LAYER, SOURCE = "%", "kernels: kernels/quantized_maxsim", "device_trace"


def read(run):
    return run.kernel_roofline_pct("quantized_maxsim")

"""The most device memory allocated during the window
(``torch.cuda.max_memory_allocated``, reset when the window starts): what
a deployment of this index needs."""
UNIT, LAYER, SOURCE = "GiB", "end to end", "device_trace"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

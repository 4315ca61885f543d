"""The device memory the searches in flight add over what set-up left
allocated: the window's peak (``peak_gib``) less
``torch.cuda.memory_allocated`` once every rung was warmed and before any
traffic (the index, the pool, the server's buffers)."""
UNIT, LAYER = "GiB", "retrieval facade: retrieval/retriever.Retriever.search"
SOURCE = "device_trace"


def read(run):
    if not run.peak_bytes or not run.held_bytes:
        return None
    return (run.peak_bytes - run.held_bytes) / 2 ** 30

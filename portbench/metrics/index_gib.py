"""The bytes of the index state the search reads (every distinct tensor
storage of the ``RetrieverState`` that set-up built: codes, masks, float
rows, the rerank's full codes), counted once the index is built."""
UNIT, LAYER, SOURCE = "GiB", "index: core/index", "program_counter"


def read(run):
    return run.index_bytes / 2 ** 30 if run.index_bytes else None

"""The bytes of the query encoder's weights (every distinct tensor storage
of the port's encoder module that set-up built), counted once built: the
encoder's part of ``peak_gib``."""
UNIT, LAYER = "GiB", "encoder: models/colpali.ColPaliEncoder.encode_query"
SOURCE = "program_counter"


def read(run):
    return run.encoder_bytes / 2 ** 30 if run.encoder_bytes else None

"""Data of the port: the synthetic corpora and batches, and the
prefetching host pipeline."""

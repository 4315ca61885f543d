"""Async continuous-batching retrieval serving."""

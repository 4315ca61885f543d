"""Requests per batch the server coalesced over the window
(``AsyncRetrievalServer.stats()["mean_batch"]``, reset when the window
starts)."""
UNIT, LAYER, SOURCE = "queries", "serving: serving/server.AsyncRetrievalServer", "program_counter"


def read(run):
    return run.stats["mean_batch"] if run.stats.get("n") else None

"""The mean time of a search call inside the window: from the server's
call of the benchmark's search callable to the end of its work on the
device (the traced run waits for it there), so it holds what the search
queued behind the batch before it."""
UNIT, LAYER, SOURCE = "ms", "retrieval facade: retrieval/retriever.Retriever.search", "program_span"


def read(run):
    calls = run.window_searches()
    if not run.traced or not calls:
        return None
    return 1e3 * sum(c[1] - c[0] for c in calls) / len(calls)

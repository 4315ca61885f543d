"""The mean host time of a search call inside the window: the program's
``retrieval.search`` span, from the call of ``Retriever.search`` to its
return, before any wait for the device. Read from ``run.spans``, the
program's spans of the window; nothing where the run kept none."""
UNIT, LAYER, SOURCE = "ms", "retrieval facade: retrieval/retriever.Retriever.search", "program_span"


def read(run):
    calls = [s.end - s.start for s in getattr(run, "spans", None) or ()
             if s.name == "retrieval.search"]
    return 1e3 * sum(calls) / len(calls) if calls else None

"""The mean time a request waited in the server's queue, from its enqueue
to the start of its batch's staging (the program's ``serve.queue``
spans), over the requests whose batch staged inside the window. Read
from ``run.spans``, the program's spans of the window; nothing where the
run kept none."""
UNIT, LAYER, SOURCE = "ms", "serving: serving/server.AsyncRetrievalServer", "program_span"


def read(run):
    waits = [s.end - s.start for s in getattr(run, "spans", None) or ()
             if s.name == "serve.queue"]
    return 1e3 * sum(waits) / len(waits) if waits else None

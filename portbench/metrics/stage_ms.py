"""The mean time the server took to stage a batch inside the window: the
program's ``serve.stage`` span, padding to the ladder rung on the host and
the copies to the device. Read from ``run.spans``, the program's spans of
the window; nothing where the run kept none."""
UNIT, LAYER, SOURCE = "ms", "serving: serving/server.AsyncRetrievalServer", "program_span"


def read(run):
    stages = [s.end - s.start for s in getattr(run, "spans", None) or ()
              if s.name == "serve.stage"]
    return 1e3 * sum(stages) / len(stages) if stages else None

"""One traced run of a cell with the port's own tracer on over the window:
the device's idle gaps put down to the program's spans, the per-layer
metrics that read them, each span's host time and a request's path
through the server. The benchmark's runs never run it.

    python3 portbench/program_run.py --workload <cell> --seed <n> \
        --seconds <s>

prints one line: ``{"result": ..., "program": ...}``, ``result`` being
what ``run.py --trace 1`` prints, with its ``idle_gaps`` split by program
span. The tracer's cost is read against ``run.py --trace 1``, the same
run with it off.

It turns the tracer on by putting its own ``Profiler.start``/``stop``,
``summarize`` and ``Run`` in the place of ``portbench.trace``'s and
``portbench.harness``'s for the run, and fails where the harness no
longer reaches them by module attribute.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the per-layer metrics read from the program's spans
METRICS = ("queue_wait_ms", "dispatch_ms", "stage_ms")


@contextlib.contextmanager
def program_tracer():
    """While open, a traced ``harness.run`` also turns the program's tracer
    on over the window, splits the idle gaps by its spans and gives its
    ``Run`` their list as ``spans`` and the seconds the garbage collector
    held the interpreter in the window as ``gc_s``. Yields the list the
    runs' ``Run`` objects are appended to; each has ``summarized``, the
    calls of ``summarize`` in its run."""
    from portbench import harness, program_trace
    from portbench import trace as trace_mod
    from repro_torch import tracing

    runs, opened, collected, summarized = [], [], [], []
    start, stop = trace_mod.Profiler.start, trace_mod.Profiler.stop
    summarize, run_cls = trace_mod.summarize, harness.Run

    def timed(phase, info):          # "start", then "stop", in turn
        collected.append(time.perf_counter())

    def start_both(self):
        start(self)
        opened.append(self)
        collected.clear()
        summarized.clear()
        gc.callbacks.append(timed)
        tracing.reset()
        tracing.enable()

    def stop_both(self):
        tracing.disable()
        gc.callbacks.remove(timed)
        stop(self)

    def summarize_both(device, host, window):
        summarized.append(window)
        program = program_trace.in_trace(tracing.spans(), opened[-1].t_open,
                                         window[0])
        return program_trace.summarize(device, host, window, program)

    class SpanRun(run_cls):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.spans = program_trace.in_window(tracing.spans(), self.t0,
                                                 self.t1)
            self.gc_s = sum(b - a for a, b in
                            zip(collected[::2], collected[1::2]))
            self.summarized = len(summarized)
            runs.append(self)

    trace_mod.Profiler.start, trace_mod.Profiler.stop = start_both, stop_both
    trace_mod.summarize, harness.Run = summarize_both, SpanRun
    try:
        yield runs
    finally:
        if timed in gc.callbacks:
            gc.callbacks.remove(timed)
        trace_mod.Profiler.start, trace_mod.Profiler.stop = start, stop
        trace_mod.summarize, harness.Run = summarize, run_cls
        tracing.disable()
        tracing.reset()


def traced_run(cell: str, *, seed: int, seconds: float,
               device: str = "cuda", pb=None, t_process=None) -> dict:
    """One traced run of ``cell`` -> {"result": the result line's object,
    "program": what the program's spans say of the window}. Raises where
    the harness ran without the tracer's ``Run`` or ``summarize``."""
    from portbench import harness, program_trace
    kw = {} if pb is None else {"pb": pb}
    with program_tracer() as runs:
        result = harness.run(cell, seed=seed, seconds=seconds, traced=True,
                             device=device, t_process=t_process, **kw)
    if len(runs) != 1 or runs[0].summarized != 1:
        raise RuntimeError(
            "harness.run no longer builds its Run or calls summarize through "
            "portbench.harness.Run and portbench.trace.summarize: the "
            "program's spans did not reach the run")
    run = runs[0]
    stats = run.stats
    pbdir = harness.PB if pb is None else pb
    out = {"searches": len(run.window_searches()),
           "answered": len(run.in_window),
           "qps": len(run.in_window) / run.window_s,
           "busy_s": run.trace.busy_s if run.trace is not None else None,
           "gc_s": run.gc_s,
           "metrics": {name: harness.metric_module(name, pbdir).read(run)
                       for name in METRICS},
           # the server's own count of the window's batches
           "server": {"requests": stats["n"],
                      "batches": sum(v["batches"]
                                     for v in stats["rungs"].values()),
                      "slots": sum(b * v["batches"]
                                   for b, v in stats["rungs"].items())},
           "spans": program_trace.by_label(run.spans),
           "serving": program_trace.serving_split(run.spans)}
    return {"result": result, "program": out}


def main(argv=None) -> int:
    from portbench.run import _process_age
    t_process = time.perf_counter() - _process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch
    if not torch.cuda.is_available():
        print("portbench program_run: needs a CUDA device", file=sys.stderr)
        return 2
    out = traced_run(args.workload, seed=args.seed, seconds=args.seconds,
                     t_process=t_process)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())

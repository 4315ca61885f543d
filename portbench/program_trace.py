"""The port's own spans (``repro_torch.tracing``) in a traced window.

``in_trace`` maps the program's spans into the trace's microseconds, by
the same tie as ``trace.HostSpans.in_trace`` (the ``pb.window`` range,
opened at a known ``time.perf_counter()`` instant), each with its label
(its name under its parent's, ``cascade.stage1/scan.merge``) and its
depth in the program's span tree. ``summarize`` is ``trace.summarize``
with the device's idle gaps put down to the program's spans first:

  1. ``pb.sync`` and ``pb.client``, where they are open: the benchmark's
     own doing;
  2. the program's spans, the deepest open one on any thread; where spans
     on different threads overlap, one that launches device work
     (``LAUNCHERS``) wins over other host work, and that over one that waits
     (``WAITS``). A request's wait in the queue (``serve.queue``) is no
     host work and takes no gap;
  3. what is left, as ``trace.summarize`` does: ``trace.HOST_ORDER``, then
     ``trace.IDLE_NONE``.

Each gap only splits, so the idle total is unchanged; without program
spans the result is ``trace.summarize``'s. ``by_label`` and
``serving_split`` sum the spans of a window: each label's wall and self
time, and where a request's time from enqueue to answer goes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from portbench import trace

# program spans that launch device work, then those that wait
LAUNCHERS = ("retrieval.", "cascade.", "hamming.", "scan.", "serve.stage",
             "serve.h2d")
WAITS = ("serve.d2h", "serve.inflight_wait", "serve.coalesce")
# the benchmark's own host spans, which keep their gaps
OWN = ("pb.sync", "pb.client")
# a request's interval, not the host's work
REQUEST = "serve.queue"
# a request's path through the server, in order
SERVING = ("serve.stage", "serve.search", "serve.d2h", "serve.fanout")

# (label, start_us, end_us, depth)
ProgramSpan = Tuple[str, float, float, int]
# bound once: ``program_run`` puts ``summarize`` in its place in a run
_summarize = trace.summarize


def in_window(spans, t0: float, t1: float) -> list:
    """The spans that ended inside [t0, t1] (``time.perf_counter()``)."""
    return [s for s in spans if t0 <= s.end <= t1]


def depths(spans) -> Dict[int, int]:
    """Each span's depth under the spans of the list (0: no parent)."""
    parent = {s.span_id: s.parent_id for s in spans}
    out: Dict[int, int] = {}
    for sid in parent:
        chain, p = [], sid
        while p in parent and p not in out:
            chain.append(p)
            p = parent[p]
        d = out.get(p, -1)
        for c in reversed(chain):
            d += 1
            out[c] = d
    return out


def labels(spans) -> Dict[int, str]:
    """Each span's name under its parent's (``parent/name``), or its name
    alone where its parent is not in the list: a merge is told apart by
    the stage that ran it."""
    name = {s.span_id: s.name for s in spans}
    return {s.span_id: (f"{name[s.parent_id]}/{s.name}"
                        if s.parent_id in name else s.name) for s in spans}


def in_trace(spans, t_perf: float, t_trace_us: float) -> List[ProgramSpan]:
    """The spans in the trace's microseconds, given one instant on both
    clocks, with their labels and depths."""
    dep, lab = depths(spans), labels(spans)
    return [(lab[s.span_id], (s.start - t_perf) * 1e6 + t_trace_us,
             (s.end - t_perf) * 1e6 + t_trace_us, dep[s.span_id])
            for s in spans]


def _rank(label: str) -> int:
    name = label.rsplit("/", 1)[-1]
    if name.startswith(LAUNCHERS):
        return 0
    return 2 if name in WAITS else 1


def summarize(device, host, window,
              program: Optional[List[ProgramSpan]] = None
              ) -> Optional[trace.TraceSummary]:
    """``trace.summarize``, with the idle gaps put down to ``program``'s
    spans (in the trace's microseconds) where they are given, each gap
    under the label of the span it goes to."""
    base = _summarize(device, host, window)
    if base is None or program is None:
        return base
    w0, w1 = window
    busy = trace.merge((max(a, w0), min(b, w1)) for _, a, b in device
                       if min(b, w1) > max(a, w0))
    idle = trace.subtract([(w0, w1)], busy)
    gaps: Dict[str, float] = {}

    def take(name, intervals):
        nonlocal idle
        cover = trace.intersect(idle, trace.merge(intervals))
        if cover:
            gaps[name] = gaps.get(name, 0.0) + trace.length(cover) * 1e-6
            idle = trace.subtract(idle, cover)

    for name in OWN:
        take(name, [(a, b) for n, a, b in host if n == name])
    groups: Dict[tuple, list] = {}
    for label, a, b, depth in program:
        if label != REQUEST:
            groups.setdefault((_rank(label), -depth, label), []).append(
                (a, b))
    for (_, _, label), intervals in sorted(groups.items()):
        take(label, intervals)
    for name in trace.HOST_ORDER:
        if name not in OWN:
            take(name, [(a, b) for n, a, b in host if n == name])
    if idle:
        gaps[trace.IDLE_NONE] = trace.length(idle) * 1e-6
    return dataclasses.replace(
        base, idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def by_label(spans) -> Dict[str, Dict[str, float]]:
    """Per span label: how many, and their wall and self seconds summed
    (self: the wall time no child span of the list covers)."""
    children: Dict[int, list] = {}
    for s in spans:
        if s.parent_id is not None:
            children.setdefault(s.parent_id, []).append((s.start, s.end))
    lab = labels(spans)
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        e = out.setdefault(lab[s.span_id], {"n": 0, "wall_s": 0.0,
                                            "self_s": 0.0})
        e["n"] += 1
        e["wall_s"] += s.end - s.start
        kids = trace.merge(children.get(s.span_id, ()))
        e["self_s"] += (s.end - s.start) - trace.length(
            trace.intersect(kids, [(s.start, s.end)]))
    return out


def serving_split(spans) -> Optional[dict]:
    """Where a request's time from enqueue to answer goes, as mean ms a
    request: its wait in the queue, its batch's staging, the hand-off to
    the executor, the search call, the device-to-host copy, the return to
    the event loop and the fan-out; and the share of the whole that the
    serving spans cover. Over the requests whose batch has every serving
    span in the list; None without one."""
    per: Dict[int, dict] = {}
    for s in spans:
        if s.batch is not None and s.name in SERVING:
            per.setdefault(s.batch, {})[s.name] = s
    keys = ("queue", "stage", "handoff", "search", "d2h", "return", "fanout")
    sums = dict.fromkeys(keys, 0.0)
    total, n = 0.0, 0
    for q in spans:
        b = per.get(q.batch) if q.name == REQUEST else None
        if b is None or len(b) < len(SERVING):
            continue
        st, se, d, f = (b[name] for name in SERVING)
        for key, a, z in (("queue", q.start, q.end),
                          ("stage", st.start, st.end),
                          ("handoff", st.end, se.start),
                          ("search", se.start, se.end),
                          ("d2h", d.start, d.end),
                          ("return", d.end, f.start),
                          ("fanout", f.start, f.end)):
            sums[key] += z - a
        total += f.end - q.start
        n += 1
    if n == 0 or total <= 0:
        return None
    covered = sum(sums[k] for k in ("queue", "stage", "search", "d2h",
                                    "fanout"))
    return {"requests": n, "total_ms": 1e3 * total / n,
            "mean_ms": {k: 1e3 * v / n for k, v in sums.items()},
            "covered_pct": 100.0 * covered / total}

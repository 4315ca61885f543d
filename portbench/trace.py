"""A traced window: the device's busy time, each kernel's time, and the
device's idle gaps by what the host was doing.

``Profiler`` runs ``torch.profiler`` over the window and hands its events
on as plain tuples; ``summarize`` does the arithmetic on them, so it is
tested without a card. Host spans are kept by ``HostSpans`` around the
benchmark's own code and its calls into the port (``pb.search``: a
search call launching its work; ``pb.sync``: the traced run's wait for
that work; ``pb.stage``: the server staging a batch; ``pb.client``: the
traffic generator's own code), on every thread; a ``record_function``
range, ``pb.window``, marks the window in the trace and ties the two
clocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

Interval = Tuple[float, float]

WINDOW = "pb.window"
# an idle gap goes to the first of these host spans open during it
HOST_ORDER = ("pb.search", "pb.stage", "pb.sync", "pb.client")
IDLE_NONE = "no span (event loop: coalescing, fan-out)"
TOP = 10


def kernel_name(name: str) -> str:
    """A device op's name without return type, anonymous namespace,
    template arguments and parameters: ``void (anonymous
    namespace)::qmaxsim_kernel<...>(Params, int)`` -> ``qmaxsim_kernel``.
    A generic PyTorch kernel keeps the op it runs:
    ``at::native::elementwise_kernel[where]``. Copies and others stay as
    they are."""
    s = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    m = re.match(r"^([A-Za-z_][\w:]*)\s*[<(]", s)
    if not m:
        return name
    base = m.group(1)
    hint = re.search(r"(\w+?)_kernel(?:_impl|_cuda)\b", s[m.end():])
    if hint and base.startswith("at::native::"):
        return f"{base}[{hint.group(1)}]"
    return base


def merge(spans: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """Both merged and sorted."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """xs minus ys, both merged and sorted."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > cur:
                out.append((cur, ys[k][0]))
            cur = max(cur, ys[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def length(xs: Iterable[Interval]) -> float:
    return sum(b - a for a, b in xs)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]            # device time by function name
    device_ops: List[Tuple[str, float]]   # the TOP longest, seconds
    idle_gaps: List[Tuple[str, float]]    # idle seconds by host activity


def summarize(device: List[Tuple[str, float, float]],
              host: List[Tuple[str, float, float]],
              window: Interval) -> Optional[TraceSummary]:
    """device: (name, start_us, end_us) of every device op; host: (span
    name, start_us, end_us); window in the same microseconds. None when
    no device op ran in the window."""
    w0, w1 = window
    clipped = [(kernel_name(n), max(a, w0), min(b, w1))
               for n, a, b in device if min(b, w1) > max(a, w0)]
    if not clipped:
        return None
    busy = merge((a, b) for _, a, b in clipped)
    by_name: Dict[str, float] = {}
    for n, a, b in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    idle = subtract([(w0, w1)], busy)
    gaps: Dict[str, float] = {}
    for name in HOST_ORDER:
        cover = intersect(idle, merge((a, b) for n, a, b in host
                                      if n == name))
        if cover:
            gaps[name] = length(cover) * 1e-6
        idle = subtract(idle, cover)
    if idle:
        gaps[IDLE_NONE] = length(idle) * 1e-6
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=length(busy) * 1e-6,
        kernel_s=by_name, device_ops=rank[:TOP],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP])


class HostSpans:
    """The traced run's host spans, kept in memory: ``spans(name)`` is a
    context manager that records (name, start, end) on the host's clock,
    from any thread."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter()))

    def in_trace(self, t_perf: float, t_trace_us: float):
        """The spans in the trace's microseconds, given one instant on both
        clocks."""
        return [(n, (a - t_perf) * 1e6 + t_trace_us,
                 (b - t_perf) * 1e6 + t_trace_us) for n, a, b in self.spans]


class Profiler:
    """``torch.profiler`` over the window (CPU and CUDA activities). The
    window's ``pb.window`` range, opened on the host at a known instant,
    ties the trace's clock to the host's."""

    def __init__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._mark = None
        self.t_open = None

    def start(self):
        import torch
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.t_open = time.perf_counter()

    def stop(self):
        self._mark.__exit__(None, None, None)
        self._prof.stop()

    def events(self):
        """(device, window): the device's ops as (name, start_us, end_us),
        without annotations, and the ``pb.window`` range."""
        from torch.autograd import DeviceType
        device, window = [], None
        for e in self._prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.name.startswith("pb.") or getattr(
                    e, "is_user_annotation", False):
                if e.name == WINDOW and e.device_type == DeviceType.CPU:
                    window = (a, b)
                continue
            if e.device_type == DeviceType.CUDA:
                device.append((e.name, a, b))
        return device, window

"""The port's spans, kept in memory, off unless enabled.

``span(name)`` is a context manager around a piece of host work: with
tracing off it returns one shared no-op context (a flag test, nothing
allocated, no clock read, no lock); with tracing on it records a `Span`:
its name, id, the id of the span open around it on the same thread, the
server's batch sequence number (given, or taken from that parent), the
thread's name, and its ``time.perf_counter()`` start and end. Every span
measures the host: how long it took to launch the work, not how long the
device ran it.

``record(name, start, end)`` keeps an interval whose ends are already
known, such as a request's wait in the server's queue. An interval open
across an ``await`` goes through it, not through ``span``: the event
loop's other coroutines run during the await, and the parent stack is
the thread's.

Nothing is written to a file: a caller ``enable()``s the tracer over the
stretch it measures, reads ``spans()`` and ``disable()``s it. ``reset()``
drops what was kept.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: Optional[int]
    batch: Optional[int]
    thread: str
    start: float                 # time.perf_counter() seconds
    end: float


_on = False
_spans: List[Span] = []
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Open:
    __slots__ = ("name", "batch", "span_id", "parent_id", "stack", "t0")

    def __init__(self, name: str, batch: Optional[int]):
        self.name, self.batch = name, batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent_id = parent.span_id if parent is not None else None
        if self.batch is None and parent is not None:
            self.batch = parent.batch
        self.span_id = next(_ids)
        self.stack = stack
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.stack.pop()
        _spans.append(Span(self.name, self.span_id, self.parent_id,
                           self.batch, threading.current_thread().name,
                           self.t0, t1))
        return False


def span(name: str, batch: Optional[int] = None):
    """A context manager that records ``name`` over its body while tracing
    is on. ``batch`` tags it with the server's batch sequence number; left
    out, the span takes its parent's."""
    if not _on:
        return OFF
    return _Open(name, batch)


def record(name: str, start: float, end: float,
           batch: Optional[int] = None) -> None:
    """Keep an interval of known ``time.perf_counter()`` ends, with no
    parent."""
    if _on:
        _spans.append(Span(name, next(_ids), None, batch,
                           threading.current_thread().name, start, end))


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; a span open now is still kept when it closes."""
    global _on
    _on = False


def reset() -> None:
    _spans.clear()


def spans() -> List[Span]:
    return list(_spans)

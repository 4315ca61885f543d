"""Async continuous-batching retrieval serving, in PyTorch.

The counterpart of ``repro.serving.server``. ``AsyncRetrievalServer`` is
asyncio-native: clients ``await server.query(...)``; a coalescing loop
drains the request queue under ``max_wait_ms`` and pads each batch up a
power-of-two ladder of batch sizes (B in {1, 2, 4, ..., max_batch}), so a
batch of 3 pads to 4.

Staging overlaps compute: the dispatcher pads batch n+1 on the host and
copies it to the device on the event loop while batch n's search runs in
a bounded executor (``max_inflight`` threads). Each search launches its
kernels on the calling thread's current stream; the device-to-host copy
of the results, on the executor thread, is what ends the wait, so the
event loop never blocks on the device.

Fault tolerance (opt-in via ``ServeConfig.resilience``) threads the
``repro_torch.serving.resilience`` controllers through the loop:
per-request deadlines (expired items are dropped before staging and
cancelled at fan-out), bounded admission with explicit `Overloaded`
rejection and per-SLO-class token buckets, a degradation ladder that
serves overload bursts from cheaper search functions (``degraded_fns``:
the cascade's smaller (p1, p2) rungs down to the Hamming-only floor) and
steps back up under hysteresis, a watchdog that restarts a dead or hung
dispatcher and fails its claimed requests with `DispatcherFailed`, and a
`FaultInjector` with named sites (dispatch/stage/compute/fanout) for the
chaos tests. Every successful response is a `Served` tuple tagged with
the degradation level that produced it. With ``guard_recompiles`` the
degraded functions are part of the recompile sentry's declared signature
set, so shedding and degrading never run an off-ladder batch shape.

`RetrievalServer` is the sync facade (a thread-backed event loop):
``submit`` returns a waitable request, ``query`` blocks. ``close`` drains:
in-flight batches complete and deliver results; requests still queued get
a terminal `ServerClosed` error. A facade ``query`` that times out cancels
its queued item and counts in ``stats()["timeouts"]``.

Latency percentiles (p50/p99) are per request; ``stats()`` also reports
per-rung batch occupancy. With ``repro_torch.tracing`` on, each batch's
coalescing, in-flight wait, staging (its host-to-device copy a child),
search call, device-to-host copy and fan-out are spans tagged with its
sequence number, and each request's wait in the queue is one more.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.serving.resilience import (AdmissionController,
                                            DeadlineExceeded,
                                            DegradationController,
                                            DispatcherFailed, FaultInjector,
                                            Overloaded, ResilienceConfig)

logger = logging.getLogger(__name__)


class ServerClosed(RuntimeError):
    """Terminal error set on requests the server will never serve."""


class Served(tuple):
    """A ``(scores, ids)`` result tagged with the degradation level that
    served it (0 = full quality). Unpacks as a plain 2-tuple, so
    ``scores, ids = await server.query(...)`` works unchanged."""

    def __new__(cls, pair, level: int = 0):
        self = tuple.__new__(cls, pair)
        self.level = int(level)
        return self


def padding_ladder(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (always ending at ``max_batch``)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    rungs: List[int] = []
    b = 1
    while b < max_batch:
        rungs.append(b)
        b *= 2
    rungs.append(max_batch)
    return tuple(rungs)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_wait_ms: float = 2.0
    top_k: int = 10
    # Batch shapes. None -> power-of-two ladder up to max_batch; a
    # single-element tuple (max_batch,) pads every batch to max_batch.
    ladder: Optional[Tuple[int, ...]] = None
    # Batches in flight at once: 2 = stage n+1 while n computes.
    max_inflight: int = 2
    # Wrap the search functions in a RecompileSentry: every call's
    # (B, Mq, dtypes, level) signature is recorded, and a batch whose B is
    # not a ladder rung (or whose level does not exist) raises
    # RecompileGuardError before any kernel launches.
    guard_recompiles: bool = False
    # Deadlines, bounded admission + load shedding, degradation ladder,
    # watchdog. None: unbounded queue, no deadlines, no watchdog.
    resilience: Optional[ResilienceConfig] = None

    def resolved_ladder(self) -> Tuple[int, ...]:
        if self.ladder is None:
            return padding_ladder(self.max_batch)
        rungs = tuple(sorted(set(int(b) for b in self.ladder)))
        if not rungs or rungs[0] < 1:
            raise ValueError(f"invalid ladder {self.ladder}")
        if rungs[-1] != self.max_batch:
            raise ValueError(
                f"ladder {rungs} must end at max_batch={self.max_batch}")
        return rungs


class _Item:
    """One queued query."""

    __slots__ = ("q_emb", "q_mask", "q_sal", "future", "t_enqueue",
                 "deadline", "slo")

    def __init__(self, q_emb, q_mask, q_sal, future, t_enqueue,
                 deadline=None, slo="interactive"):
        self.q_emb, self.q_mask, self.q_sal = q_emb, q_mask, q_sal
        self.future = future
        self.t_enqueue = t_enqueue
        # absolute time.perf_counter() deadline, or None
        self.deadline = deadline
        self.slo = slo


_STOP = object()


class AsyncRetrievalServer:
    """search_fn(q_emb (B,Mq,D), q_mask, q_sal) -> (scores (B,k), ids (B,k)),
    called with tensors on ``device``.

    Bind to one event loop: the first ``query`` (or an explicit ``start``)
    captures the running loop; all queries must come from that loop.

    ``degraded_fns`` is an ordered sequence of cheaper search functions
    with the same signature and output shapes as ``search_fn``; level
    L > 0 of the degradation ladder serves from ``degraded_fns[L - 1]``.
    """

    def __init__(self, search_fn: Callable, cfg: ServeConfig,
                 degraded_fns: Sequence[Callable] = (), *, device="cuda"):
        self.search_fns: List[Callable] = [search_fn, *degraded_fns]
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ladder = cfg.resolved_ladder()
        self.recompile_sentry = None
        if cfg.guard_recompiles:
            from repro_torch.analysis.recompile import RecompileSentry
            rungs = set(self.ladder)

            def _serve(q, qm, qs, level=0):
                return self.search_fns[level](q, qm, qs)

            def serve_signature(q, qm, qs, level=0):
                # B stays at position 0 (reports key rungs off sig[0]);
                # the degradation level rides at the end
                return (int(q.shape[0]), int(q.shape[1]), str(q.dtype),
                        str(qm.dtype), str(qs.dtype), int(level))

            n_levels = len(self.search_fns)
            self.recompile_sentry = RecompileSentry(
                _serve, name="serve.search_fn", key_fn=serve_signature,
                allowed=lambda key: key[0] in rungs
                and 0 <= key[-1] < n_levels)
        self._queue: Optional[asyncio.Queue] = None
        self._dispatcher: Optional[asyncio.Task] = None
        self._watchdog_task: Optional[asyncio.Task] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._fanout_tasks: set = set()
        self._pool = ThreadPoolExecutor(max_workers=max(1, cfg.max_inflight),
                                        thread_name_prefix="serve-compute")
        self._closing = False
        self._closed = False
        # (B, Mq) shapes that have run at least once
        self._warmed: set = set()
        # batches staged so far: each batch's sequence number, which tags
        # its spans (repro_torch.tracing)
        self._n_staged = 0
        # -- resilience (None / no-op when cfg.resilience is None) --
        res = cfg.resilience
        self.fault_injector = FaultInjector()
        self._admission = AdmissionController(res) if res else None
        self._degrade = (DegradationController(len(self.search_fns), res)
                         if res else None)
        # items dequeued by the dispatcher but not yet handed to fan-out;
        # the watchdog fails these with DispatcherFailed on restart. Only
        # the event loop touches it, so it takes no lock.
        self._claimed: Dict[_Item, float] = {}
        self._beat = 0.0  # dispatcher heartbeat (loop.time())
        # stats: written by fan-out tasks, read from any thread
        self._lock = threading.Lock()
        self.latencies_ms: List[float] = []
        self.batch_sizes: List[int] = []
        self._rung_counts: Dict[int, int] = {}
        self._rung_occupied: Dict[int, int] = {}
        self._level_served: Dict[int, int] = {}
        self._recent_lat: collections.deque = collections.deque(maxlen=256)
        self._n_timeouts = 0
        self._n_deadline_expired = 0
        self._n_watchdog_restarts = 0
        self._t_first_enqueue: Optional[float] = None
        self._t_last_done: Optional[float] = None

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Idempotent: bind to the running loop and start the dispatcher
        (and, with ``resilience``, the watchdog)."""
        if self._closed:
            raise ServerClosed("server already closed")
        if self._queue is None:
            loop = asyncio.get_running_loop()
            self._queue = asyncio.Queue()
            self._inflight = asyncio.Semaphore(max(1, self.cfg.max_inflight))
            self._beat = loop.time()
            self._dispatcher = loop.create_task(self._dispatch())
            if self.cfg.resilience is not None:
                self._watchdog_task = loop.create_task(self._watchdog())

    async def aclose(self) -> None:
        """Stop serving. In-flight batches complete and deliver results;
        still-queued requests get a terminal `ServerClosed` error."""
        if self._closed:
            return
        self._closing = True
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            await asyncio.gather(self._watchdog_task, return_exceptions=True)
            self._watchdog_task = None
        if self._queue is not None:
            await self._queue.put(_STOP)
            # a dispatcher crash must not skip the drain below
            await asyncio.gather(self._dispatcher, return_exceptions=True)
            while True:
                try:
                    item = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if item is not _STOP and not item.future.done():
                    item.future.set_exception(
                        ServerClosed("server closed before request ran"))
        if self._fanout_tasks:
            await asyncio.gather(*list(self._fanout_tasks),
                                 return_exceptions=True)
        # a dispatcher that died mid-claim leaves orphans; never strand them
        self._fail_claimed(ServerClosed("server closed before request ran"))
        self._pool.shutdown(wait=True)
        self._closed = True

    # -- client API ---------------------------------------------------------

    async def _enqueue(self, q_emb, q_mask, q_sal, *, _t_enqueue=None,
                       deadline_ms=None, slo="interactive") -> _Item:
        """Admission + enqueue; returns the queued `_Item` so a caller (the
        sync facade) can cancel its future on its own timeout."""
        if self._closing or self._closed:
            raise ServerClosed("server is closed")
        await self.start()
        if self._admission is not None:
            reason = self._admission.admit(slo, self._queue.qsize())
            if reason is not None:
                raise Overloaded(reason)
        res = self.cfg.resilience
        t_enq = time.perf_counter() if _t_enqueue is None else _t_enqueue
        if deadline_ms is None and res is not None \
                and res.default_deadline_ms > 0:
            deadline_ms = res.default_deadline_ms
        deadline = None if deadline_ms is None else t_enq + deadline_ms / 1e3
        fut = asyncio.get_running_loop().create_future()
        # a request arrives as host arrays (client.drive, launch.serve)
        item = _Item(np.asarray(q_emb), np.asarray(q_mask), np.asarray(q_sal),  # noqa: TORCH05
                     fut, t_enq, deadline, slo)
        with self._lock:
            if self._t_first_enqueue is None:
                self._t_first_enqueue = t_enq
        await self._queue.put(item)
        return item

    async def query(self, q_emb, q_mask, q_sal, *, _t_enqueue=None,
                    deadline_ms=None, slo="interactive"):
        """Awaitable single-query search on host arrays (Mq, D), (Mq,),
        (Mq,) -> a `Served` (scores (k,), ids (k,)) of numpy arrays
        carrying ``.level``.

        Raises `Overloaded` when admission sheds the request and
        `DeadlineExceeded` when ``deadline_ms`` (or the configured
        default) passes before the results are ready. A caller that stops
        waiting cancels its queued item, so it frees its batch slot.
        """
        item = await self._enqueue(q_emb, q_mask, q_sal, _t_enqueue=_t_enqueue,
                                   deadline_ms=deadline_ms, slo=slo)
        try:
            return await item.future
        except asyncio.CancelledError:
            if not item.future.done():
                item.future.cancel()
            raise

    def rung_for(self, n: int) -> int:
        """Smallest ladder rung that fits a batch of n requests."""
        for b in self.ladder:
            if b >= n:
                return b
        return self.ladder[-1]

    def warm_shapes(self, q_emb, q_mask, q_sal, rungs=None,
                    levels=None) -> None:
        """Run the search once at every ladder rung and, by default, every
        degradation level, for one example query (blocking). Eager PyTorch
        compiles nothing per shape, so this moves first-use costs (library
        loads, allocator growth) out of the serving window, and it records
        every (rung, level) signature in the recompile sentry."""
        if levels is None:
            levels = range(len(self.search_fns))
        q = np.asarray(q_emb)
        for b in rungs if rungs is not None else self.ladder:
            batch = [np.repeat(np.asarray(a)[None], b, axis=0)
                     for a in (q_emb, q_mask, q_sal)]
            qb, qmb, qsb = (torch.from_numpy(a).to(self.device)
                            for a in batch)
            for level in levels:
                for out in self._call_search(level, qb, qmb, qsb):
                    out.cpu()  # waits for the device
            self._warmed.add((b, q.shape[0]))

    @property
    def compiled_shapes(self) -> set:
        """(B, Mq) pairs that have run at least once (the reference's
        name: its shapes each compile on first use)."""
        return set(self._warmed)

    @property
    def search_fn(self) -> Callable:
        """The level-0 (full quality) search function."""
        return self.search_fns[0]

    @search_fn.setter
    def search_fn(self, fn: Callable) -> None:
        self.search_fns[0] = fn

    def _call_search(self, level: int, q, qm, qs):
        if self.recompile_sentry is not None:
            return self.recompile_sentry(q, qm, qs, level)
        return self.search_fns[level](q, qm, qs)

    def swap_search_fn(self, search_fn: Callable,
                       degraded_fns: Optional[Sequence[Callable]] = None
                       ) -> None:
        """Swap the underlying search functions (a live index mutation).
        The recompile sentry and its signature history stay: the ladder's
        rung set belongs to the server. Batches already staged finish on
        whichever function they read. The level count is fixed at
        construction (it sizes the degradation controller), so
        ``degraded_fns`` must match it."""
        if degraded_fns is not None:
            if len(degraded_fns) + 1 != len(self.search_fns):
                raise ValueError(
                    f"got {len(degraded_fns)} degraded fns for a server "
                    f"with {len(self.search_fns) - 1} degraded levels")
            self.search_fns[1:] = list(degraded_fns)
        self.search_fns[0] = search_fn

    # -- dispatcher ---------------------------------------------------------

    def _resolve_exc(self, item: _Item, exc: BaseException) -> None:
        self._claimed.pop(item, None)
        if not item.future.done():
            item.future.set_exception(exc)

    def _fail_claimed(self, exc: BaseException) -> None:
        for it in list(self._claimed):
            self._resolve_exc(it, exc)

    def _drop_stale(self, item: _Item) -> bool:
        """Drop cancelled or expired items before they take a batch slot."""
        if item.future.done():
            # the caller stopped waiting (a facade timeout, a cancel)
            self._claimed.pop(item, None)
            return True
        if item.deadline is not None \
                and time.perf_counter() >= item.deadline:
            with self._lock:
                self._n_deadline_expired += 1
            self._resolve_exc(item, DeadlineExceeded(
                "deadline passed while queued — dropped before staging"))
            return True
        return False

    def _observe_level(self) -> int:
        """One degradation-controller observation per coalesced batch."""
        if self._degrade is None:
            return 0
        res = self.cfg.resilience
        depth_frac = self._queue.qsize() / max(1, res.max_queue)
        with self._lock:
            recent = list(self._recent_lat)
        p99 = float(np.percentile(np.asarray(recent), 99)) if recent else 0.0
        return self._degrade.observe(depth_frac, p99)

    async def _dispatch(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            self._beat = loop.time()
            item = await self._queue.get()
            self._beat = loop.time()
            if item is _STOP:
                return
            self._claimed[item] = t_first = time.perf_counter()
            self.fault_injector.fire("dispatch")
            if self._closing:
                self._resolve_exc(item, ServerClosed(
                    "server closed before request ran"))
                continue
            if self._drop_stale(item):
                continue
            batch = [item]
            stop_after = False
            deadline = loop.time() + self.cfg.max_wait_ms / 1e3
            while len(batch) < self.cfg.max_batch:
                rem = deadline - loop.time()
                if rem <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), rem)
                except asyncio.TimeoutError:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                self._claimed[nxt] = time.perf_counter()
                if not self._drop_stale(nxt):
                    batch.append(nxt)
            # deadlines and cancellations may have landed while coalescing
            batch = [r for r in batch if not self._drop_stale(r)]
            if not batch:
                if stop_after:
                    return
                continue
            level = self._observe_level()
            traced = tracing.enabled()
            t_closed = time.perf_counter() if traced else 0.0
            # bound in-flight batches (double buffer), then re-check for
            # cancellations and deadlines that landed during the wait
            await self._inflight.acquire()
            t_acquired = time.perf_counter() if traced else 0.0
            batch = [r for r in batch if not self._drop_stale(r)]
            if not batch:
                self._inflight.release()
                if stop_after:
                    return
                continue
            try:
                staged = self._stage(batch)
            except Exception as e:  # noqa: BLE001 - e.g. mixed shapes
                # fail this batch, keep the dispatcher alive
                self._inflight.release()
                for r in batch:
                    self._resolve_exc(r, e)
                if stop_after:
                    return
                continue
            for r in batch:
                # fan-out owns resolution from here; the watchdog covers
                # only the dequeue -> stage window
                self._claimed.pop(r, None)
            if traced:
                # both intervals span an await, so they are kept as records
                tracing.record("serve.coalesce", t_first, t_closed, staged[0])
                tracing.record("serve.inflight_wait", t_closed, t_acquired,
                               staged[0])
            task = loop.create_task(self._fanout(batch, level, *staged))
            self._fanout_tasks.add(task)
            task.add_done_callback(self._fanout_tasks.discard)
            if stop_after:
                return

    async def _watchdog(self) -> None:
        """Detect a dead or hung dispatcher, restart it, and fail the
        requests it had claimed with `DispatcherFailed` instead of letting
        them hang. Runs only when `ServeConfig.resilience` is set.

        It watches the coalescing loop, not the executor threads: a thread
        inside a CUDA call cannot be stopped from Python. A batch whose
        search hangs on the device keeps its compute slot; the watchdog
        restarts the dispatcher once the heartbeat goes stale with work
        pending, and fails the requests the old loop had claimed."""
        res = self.cfg.resilience
        loop = asyncio.get_running_loop()
        while not (self._closing or self._closed):
            await asyncio.sleep(res.watchdog_interval_s)
            if self._closing or self._closed:
                return
            d = self._dispatcher
            if d is None:
                continue
            if d.done():
                err = None if d.cancelled() else d.exception()
                logger.error("serve dispatcher died (%r); restarting", err)
                self._restart_dispatcher(loop, DispatcherFailed(
                    f"dispatcher died ({err!r}) while this request was "
                    "claimed; restarted by watchdog"))
                continue
            pending = bool(self._claimed) or self._queue.qsize() > 0
            if pending and (loop.time() - self._beat) > res.stall_timeout_s:
                logger.error(
                    "serve dispatcher hung (heartbeat %.1fs stale, "
                    "%d claimed, depth %d); restarting",
                    loop.time() - self._beat, len(self._claimed),
                    self._queue.qsize())
                d.cancel()
                await asyncio.gather(d, return_exceptions=True)
                self._restart_dispatcher(loop, DispatcherFailed(
                    "dispatcher hung past stall_timeout_s while this "
                    "request was claimed; restarted by watchdog"))

    def _restart_dispatcher(self, loop, exc: DispatcherFailed) -> None:
        self._fail_claimed(exc)
        with self._lock:
            self._n_watchdog_restarts += 1
        self._beat = loop.time()
        self._dispatcher = loop.create_task(self._dispatch())

    def _stage(self, batch: List[_Item]):
        """Pad to the ladder rung on the host and copy to the device ->
        (batch sequence number, rung, q, qm, qs)."""
        self.fault_injector.fire("stage")
        self._n_staged += 1
        seq = self._n_staged
        if tracing.enabled():
            t_stage = time.perf_counter()
            for r in batch:
                tracing.record("serve.queue", r.t_enqueue, t_stage, seq)
        with tracing.span("serve.stage", seq):
            rung = self.rung_for(len(batch))
            first = batch[0]
            q = np.zeros((rung,) + first.q_emb.shape, first.q_emb.dtype)
            qm = np.zeros((rung,) + first.q_mask.shape, bool)
            qs = np.zeros((rung,) + first.q_sal.shape, first.q_sal.dtype)
            for i, r in enumerate(batch):
                q[i], qm[i], qs[i] = r.q_emb, r.q_mask, r.q_sal
            self._warmed.add((rung, first.q_emb.shape[0]))
            with tracing.span("serve.h2d"):
                on_device = tuple(torch.from_numpy(a).to(self.device)
                                  for a in (q, qm, qs))
        return (seq, rung, *on_device)

    async def _fanout(self, batch: List[_Item], level: int, seq: int,
                      rung: int, q, qm, qs) -> None:
        loop = asyncio.get_running_loop()

        def _compute():
            self.fault_injector.fire("compute")
            with tracing.span("serve.search", seq):
                scores, ids = self._call_search(level, q, qm, qs)
            # the device-to-host copy waits for the device, off the loop
            with tracing.span("serve.d2h", seq):
                return scores.cpu().numpy(), ids.cpu().numpy()

        try:
            scores, ids = await loop.run_in_executor(self._pool, _compute)
            self.fault_injector.fire("fanout")
        except Exception as e:  # noqa: BLE001 - forwarded to every waiter
            for r in batch:
                self._resolve_exc(r, e)
            self._inflight.release()
            return
        with tracing.span("serve.fanout", seq):
            now = time.perf_counter()
            with self._lock:
                self._t_last_done = now
                self.batch_sizes.append(len(batch))
                self._rung_counts[rung] = self._rung_counts.get(rung, 0) + 1
                self._rung_occupied[rung] = (self._rung_occupied.get(rung, 0)
                                             + len(batch))
                if self._t_first_enqueue is None:
                    # reset_stats() ran while this batch was in flight
                    self._t_first_enqueue = min(r.t_enqueue for r in batch)
                for r in batch:
                    lat_ms = (now - r.t_enqueue) * 1e3
                    self.latencies_ms.append(lat_ms)
                    self._recent_lat.append(lat_ms)
            for i, r in enumerate(batch):
                if r.deadline is not None and now >= r.deadline:
                    # the result came, but nobody waits for it any more
                    with self._lock:
                        self._n_deadline_expired += 1
                    self._resolve_exc(r, DeadlineExceeded(
                        "deadline passed during compute"))
                    continue
                if not r.future.done():
                    r.future.set_result(Served((scores[i], ids[i]), level))
                    with self._lock:
                        self._level_served[level] = (
                            self._level_served.get(level, 0) + 1)
        self._inflight.release()

    # -- stats --------------------------------------------------------------

    def _resilience_stats(self) -> Dict[str, Any]:
        """Caller holds self._lock. The timeout counter is unconditional
        (facade timeouts cancel their queued item on any server); the
        overload and degradation counters exist only with resilience."""
        out: Dict[str, Any] = {"timeouts": self._n_timeouts}
        if self.cfg.resilience is None:
            return out
        shed = (self._admission.stats() if self._admission is not None
                else {"interactive": 0, "batch": 0})
        out.update({
            "deadline_expired": self._n_deadline_expired,
            "shed": sum(shed.values()),
            "shed_interactive": shed["interactive"],
            "shed_batch": shed["batch"],
            "degrade_level": (self._degrade.level
                              if self._degrade is not None else 0),
            "level_served": dict(self._level_served),
            "watchdog_restarts": self._n_watchdog_restarts,
        })
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lat = np.array(self.latencies_ms)
            batch_sizes = list(self.batch_sizes)
            rungs = {b: {"batches": self._rung_counts[b],
                         "occupancy": self._rung_occupied[b]
                         / (self._rung_counts[b] * b)}
                     for b in sorted(self._rung_counts)}
            t0, t1 = self._t_first_enqueue, self._t_last_done
            res = self._resilience_stats()
        if lat.size == 0:
            return {"n": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_batch": 0.0,
                    "qps": 0.0, "rungs": {}, **res}
        # the span comes from the first/last timestamps only; with no
        # completed window, qps is 0
        qps = 0.0 if t0 is None or t1 is None else lat.size / max(t1 - t0,
                                                                  1e-9)
        return {"n": int(lat.size),
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "mean_batch": (float(np.mean(batch_sizes)) if batch_sizes
                               else 0.0),
                "qps": qps, "rungs": rungs, **res}

    def recompile_report(self) -> Optional[Dict[str, Any]]:
        """The recompile sentry's signature report (None when the guard
        is off — see ServeConfig.guard_recompiles)."""
        if self.recompile_sentry is None:
            return None
        return self.recompile_sentry.report()

    def reset_stats(self) -> None:
        """Drop recorded latencies and the serving window. Resilience
        counters reset too, except watchdog_restarts (lifetime health)."""
        with self._lock:
            self.latencies_ms = []
            self.batch_sizes = []
            self._rung_counts = {}
            self._rung_occupied = {}
            self._level_served = {}
            self._recent_lat.clear()
            self._n_timeouts = 0
            self._n_deadline_expired = 0
            self._t_first_enqueue = None
            self._t_last_done = None
        if self._admission is not None:
            self._admission.reset()


class _Request:
    """A sync-facade request handle: wait on ``event``, then read
    ``result`` or ``error``."""

    __slots__ = ("q_emb", "q_mask", "q_sal", "event", "result", "error",
                 "t_enqueue", "deadline_ms", "slo", "item", "abandoned")

    def __init__(self, q_emb, q_mask, q_sal, deadline_ms=None,
                 slo="interactive"):
        self.q_emb, self.q_mask, self.q_sal = q_emb, q_mask, q_sal
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.deadline_ms = deadline_ms
        self.slo = slo
        self.item: Optional[_Item] = None   # set once enqueued (loop thread)
        self.abandoned = False              # set by the facade's timeout


class RetrievalServer:
    """Sync facade over `AsyncRetrievalServer` (a thread-backed event
    loop): ``submit`` -> waitable request, blocking ``query``."""

    def __init__(self, search_fn: Callable, cfg: ServeConfig,
                 degraded_fns: Sequence[Callable] = (), *, device="cuda"):
        self.cfg = cfg
        self._async = AsyncRetrievalServer(search_fn, cfg, degraded_fns,
                                           device=device)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="serve-loop", daemon=True)
        self._thread.start()
        self._run(self._async.start()).result(timeout=10.0)
        self._closed = False
        # serialises submit against close: a submit never schedules onto a
        # loop that close() has begun stopping
        self._lifecycle = threading.Lock()

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def submit(self, q_emb, q_mask, q_sal, *, deadline_ms=None,
               slo="interactive") -> _Request:
        req = _Request(np.asarray(q_emb), np.asarray(q_mask),
                       np.asarray(q_sal), deadline_ms, slo)

        async def _go():
            try:
                item = await self._async._enqueue(
                    req.q_emb, req.q_mask, req.q_sal,
                    _t_enqueue=req.t_enqueue, deadline_ms=req.deadline_ms,
                    slo=req.slo)
                req.item = item
                if req.abandoned and not item.future.done():
                    item.future.cancel()
                req.result = await item.future
            except BaseException as e:  # noqa: BLE001 - handed to the waiter
                req.error = e
            finally:
                req.event.set()

        with self._lifecycle:
            if self._closed:
                req.error = ServerClosed("server is closed")
                req.event.set()
                return req
            try:
                self._run(_go())
            except RuntimeError as e:   # the loop was torn down meanwhile
                req.error = ServerClosed(f"server is closed ({e})")
                req.event.set()
        return req

    def cancel(self, req: _Request) -> None:
        """Cancel a submitted request from any thread: its queued item is
        killed on the loop (freeing the batch slot) and the abandonment
        counts in ``stats()["timeouts"]``."""
        def _cancel():
            req.abandoned = True
            if req.item is not None and not req.item.future.done():
                req.item.future.cancel()
            with self._async._lock:
                self._async._n_timeouts += 1

        try:
            self._loop.call_soon_threadsafe(_cancel)
        except RuntimeError:
            pass  # the loop is closed: nothing left to cancel

    def query(self, q_emb, q_mask, q_sal, timeout: float = 30.0, *,
              deadline_ms=None, slo="interactive"):
        """Blocking single-query search -> `Served`; raises TimeoutError
        after ``timeout`` seconds, having cancelled the queued item."""
        req = self.submit(q_emb, q_mask, q_sal, deadline_ms=deadline_ms,
                          slo=slo)
        if not req.event.wait(timeout):
            self.cancel(req)
            raise TimeoutError("retrieval request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def warm_shapes(self, q_emb, q_mask, q_sal, rungs=None,
                    levels=None) -> None:
        self._async.warm_shapes(q_emb, q_mask, q_sal, rungs, levels)

    def swap_search_fn(self, search_fn: Callable,
                       degraded_fns: Optional[Sequence[Callable]] = None
                       ) -> None:
        self._async.swap_search_fn(search_fn, degraded_fns)

    @property
    def ladder(self) -> Tuple[int, ...]:
        return self._async.ladder

    @property
    def latencies_ms(self) -> List[float]:
        return self._async.latencies_ms

    @property
    def batch_sizes(self) -> List[int]:
        return self._async.batch_sizes

    def stats(self) -> Dict[str, Any]:
        return self._async.stats()

    @property
    def recompile_sentry(self):
        return self._async.recompile_sentry

    @property
    def fault_injector(self) -> FaultInjector:
        return self._async.fault_injector

    def recompile_report(self) -> Optional[Dict[str, Any]]:
        return self._async.recompile_report()

    def reset_stats(self) -> None:
        self._async.reset_stats()

    def close(self):
        """Drain and stop: in-flight batches deliver results, queued
        requests get a terminal `ServerClosed` error. Raises RuntimeError
        if the serving loop's thread fails to join."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
        try:
            self._run(self._async.aclose()).result(timeout=30.0)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                state = (f"thread={self._thread.name!r} alive=True "
                         f"daemon={self._thread.daemon} "
                         f"loop_running={self._loop.is_running()}")
                logger.error("serving loop failed to join within 5 s (%s)",
                             state)
                raise RuntimeError(
                    f"serving loop thread failed to join within 5 s ({state})")
            self._loop.close()

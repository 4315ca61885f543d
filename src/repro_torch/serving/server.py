"""Async continuous-batching retrieval serving, in PyTorch.

The counterpart of ``repro.serving.server.AsyncRetrievalServer``: clients
``await server.query(...)``; a coalescing loop drains the request queue
under ``max_wait_ms`` and pads each batch up a power-of-two ladder of
batch sizes (B in {1, 2, 4, ..., max_batch}), so a batch of 3 pads to 4.

Staging overlaps compute: the dispatcher pads batch n+1 on the host and
copies it to the device on the event loop while batch n's search runs in
a bounded executor (``max_inflight`` threads). Each search launches its
kernels on the calling thread's current stream; the device-to-host copy
of the results, on the executor thread, is what ends the wait, so the
event loop never blocks on the device.

Latency percentiles (p50/p99) are per request; ``stats()`` also reports
per-rung batch occupancy.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class ServerClosed(RuntimeError):
    """Terminal error set on requests the server will never serve."""


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

    __slots__ = ("q_emb", "q_mask", "q_sal", "future", "t_enqueue")

    def __init__(self, q_emb, q_mask, q_sal, future, t_enqueue):
        self.q_emb, self.q_mask, self.q_sal = q_emb, q_mask, q_sal
        self.future = future
        self.t_enqueue = t_enqueue


_STOP = object()


class AsyncRetrievalServer:
    """search_fn(q_emb (B,Mq,D), q_mask, q_sal) -> (scores (B,k), ids (B,k)),
    called with tensors on ``device``.

    Bind to one event loop: the first ``query`` (or an explicit ``start``)
    captures the running loop; all queries must come from that loop.
    """

    def __init__(self, search_fn: Callable, cfg: ServeConfig, *,
                 device="cuda"):
        self.search_fn = search_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ladder = cfg.resolved_ladder()
        self._queue: Optional[asyncio.Queue] = None
        self._dispatcher: Optional[asyncio.Task] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._fanout_tasks: set = set()
        self._pool = ThreadPoolExecutor(max_workers=max(1, cfg.max_inflight),
                                        thread_name_prefix="serve-compute")
        self._closing = False
        self._closed = False
        # stats: written by fan-out tasks, read from any thread
        self._lock = threading.Lock()
        self.latencies_ms: List[float] = []
        self.batch_sizes: List[int] = []
        self._rung_counts: Dict[int, int] = {}
        self._rung_occupied: Dict[int, int] = {}
        self._n_timeouts = 0
        self._t_first_enqueue: Optional[float] = None
        self._t_last_done: Optional[float] = None

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Idempotent: bind to the running loop and start the dispatcher."""
        if self._closed:
            raise ServerClosed("server already closed")
        if self._queue is None:
            self._queue = asyncio.Queue()
            self._inflight = asyncio.Semaphore(max(1, self.cfg.max_inflight))
            self._dispatcher = asyncio.get_running_loop().create_task(
                self._dispatch())

    async def aclose(self) -> None:
        """Stop serving. In-flight batches complete and deliver results;
        still-queued requests get a terminal `ServerClosed` error."""
        if self._closed:
            return
        self._closing = True
        if self._queue is not None:
            await self._queue.put(_STOP)
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
        self._pool.shutdown(wait=True)
        self._closed = True

    # -- client API ---------------------------------------------------------

    async def query(self, q_emb, q_mask, q_sal):
        """Awaitable single-query search on host arrays (Mq, D), (Mq,),
        (Mq,) -> (scores (k,), ids (k,)) as numpy arrays. A caller that
        stops waiting (a timeout, a cancellation) frees its batch slot and
        counts in ``stats()["timeouts"]``."""
        if self._closing or self._closed:
            raise ServerClosed("server is closed")
        await self.start()
        t_enq = time.perf_counter()
        fut = asyncio.get_running_loop().create_future()
        item = _Item(np.asarray(q_emb), np.asarray(q_mask), np.asarray(q_sal),
                     fut, t_enq)
        with self._lock:
            if self._t_first_enqueue is None:
                self._t_first_enqueue = t_enq
        await self._queue.put(item)
        try:
            return await fut
        except asyncio.CancelledError:
            fut.cancel()
            with self._lock:
                self._n_timeouts += 1
            raise

    def rung_for(self, n: int) -> int:
        """Smallest ladder rung that fits a batch of n requests."""
        for b in self.ladder:
            if b >= n:
                return b
        return self.ladder[-1]

    def warm_shapes(self, q_emb, q_mask, q_sal, rungs=None) -> None:
        """Run the search once at every ladder rung for one example query
        (blocking). Eager PyTorch compiles nothing per shape, so this only
        moves first-use costs (library loads, allocator growth) out of the
        serving window."""
        for b in rungs if rungs is not None else self.ladder:
            batch = [np.repeat(np.asarray(a)[None], b, axis=0)
                     for a in (q_emb, q_mask, q_sal)]
            q, qm, qs = (torch.from_numpy(a).to(self.device) for a in batch)
            for out in self.search_fn(q, qm, qs):
                out.cpu()  # waits for the device

    # -- dispatcher ---------------------------------------------------------

    async def _dispatch(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            item = await self._queue.get()
            if item is _STOP:
                return
            if self._closing:
                if not item.future.done():
                    item.future.set_exception(
                        ServerClosed("server closed before request ran"))
                continue
            if item.future.done():      # the caller stopped waiting
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
                if not nxt.future.done():
                    batch.append(nxt)
            # bound in-flight batches (double buffer), then drop requests
            # whose callers gave up during the wait for a slot
            await self._inflight.acquire()
            batch = [r for r in batch if not r.future.done()]
            if batch:
                try:
                    staged = self._stage(batch)
                except Exception as e:  # noqa: BLE001 - e.g. mixed shapes
                    # fail this batch, keep the dispatcher alive
                    self._inflight.release()
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                else:
                    task = loop.create_task(self._fanout(batch, *staged))
                    self._fanout_tasks.add(task)
                    task.add_done_callback(self._fanout_tasks.discard)
            else:
                self._inflight.release()
            if stop_after:
                return

    def _stage(self, batch: List[_Item]):
        """Pad to the ladder rung on the host and copy to the device."""
        rung = self.rung_for(len(batch))
        first = batch[0]
        q = np.zeros((rung,) + first.q_emb.shape, first.q_emb.dtype)
        qm = np.zeros((rung,) + first.q_mask.shape, bool)
        qs = np.zeros((rung,) + first.q_sal.shape, first.q_sal.dtype)
        for i, r in enumerate(batch):
            q[i], qm[i], qs[i] = r.q_emb, r.q_mask, r.q_sal
        return (rung, *(torch.from_numpy(a).to(self.device)
                        for a in (q, qm, qs)))

    async def _fanout(self, batch: List[_Item], rung: int, q, qm, qs) -> None:
        loop = asyncio.get_running_loop()

        def _compute():
            scores, ids = self.search_fn(q, qm, qs)
            # the device-to-host copy waits for the device, off the loop
            return scores.cpu().numpy(), ids.cpu().numpy()

        try:
            scores, ids = await loop.run_in_executor(self._pool, _compute)
        except Exception as e:  # noqa: BLE001 - forwarded to every waiter
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            self._inflight.release()
            return
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
                self.latencies_ms.append((now - r.t_enqueue) * 1e3)
        for i, r in enumerate(batch):
            if not r.future.done():
                r.future.set_result((scores[i], ids[i]))
        self._inflight.release()

    # -- stats --------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lat = np.array(self.latencies_ms)
            batch_sizes = list(self.batch_sizes)
            rungs = {b: {"batches": self._rung_counts[b],
                         "occupancy": self._rung_occupied[b]
                         / (self._rung_counts[b] * b)}
                     for b in sorted(self._rung_counts)}
            t0, t1 = self._t_first_enqueue, self._t_last_done
            timeouts = self._n_timeouts
        if lat.size == 0:
            return {"n": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_batch": 0.0,
                    "qps": 0.0, "rungs": {}, "timeouts": timeouts}
        qps = 0.0 if t0 is None or t1 is None else lat.size / max(t1 - t0,
                                                                  1e-9)
        return {"n": int(lat.size),
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "mean_batch": float(np.mean(batch_sizes)),
                "qps": qps, "rungs": rungs, "timeouts": timeouts}

    def reset_stats(self) -> None:
        """Drop recorded latencies and the serving window."""
        with self._lock:
            self.latencies_ms = []
            self.batch_sizes = []
            self._rung_counts = {}
            self._rung_occupied = {}
            self._n_timeouts = 0
            self._t_first_enqueue = None
            self._t_last_done = None

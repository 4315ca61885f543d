"""Open loop: independent users whose requests arrive as a Poisson process,
at a rate that may change on a fixed cycle (``"rates": [[seconds, qps],
...]``, repeated; one pair is a steady rate). Each request is sent at its
due time whatever the system does, and timed from that due time, so a
stall also counts against the requests queued behind it. How late the
generator sends is recorded as each request's lateness."""
from __future__ import annotations

import asyncio
import time
from typing import Iterator

import numpy as np

from portbench.traffic import QueryOrder


def arrivals(params, seed: int) -> Iterator[float]:
    """Due times in seconds from the start, endless: exponential gaps at
    the current segment's rate; a gap that would cross into the next
    segment is drawn anew from that segment's start at its rate."""
    rng = np.random.default_rng([int(seed), 2])
    rates = [(float(s), float(r)) for s, r in params["rates"]]
    seg, seg_start, t = 0, 0.0, 0.0
    while True:
        length, rate = rates[seg]
        nxt = t + rng.exponential(1.0 / rate) if rate > 0 else float("inf")
        if nxt < seg_start + length:
            t = nxt
            yield t
            continue
        seg_start += length
        t = seg_start
        seg = (seg + 1) % len(rates)


async def drive(send, params, *, seed, n_pool, stop, record, span):
    order = QueryOrder(n_pool, seed)
    pending = set()

    async def one(i, due):
        late = time.perf_counter() - due
        try:
            result, error = await send(i), None
        except Exception as e:  # noqa: BLE001 - a failed request counts
            result, error = None, e
        with span("pb.client"):
            record(i, due, time.perf_counter(), result, error, late)

    t0 = time.perf_counter()
    for offset in arrivals(params, seed):
        due = t0 + offset
        wait = due - time.perf_counter()
        if wait > 0:
            try:
                await asyncio.wait_for(stop.wait(), wait)
            except asyncio.TimeoutError:
                pass
        if stop.is_set():
            break
        with span("pb.client"):
            task = asyncio.ensure_future(one(order.next(), due))
        pending.add(task)
        task.add_done_callback(pending.discard)
    await asyncio.gather(*list(pending))

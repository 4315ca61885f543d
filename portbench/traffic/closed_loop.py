"""Closed loop: ``clients`` callers, each sending its next query only when
its last one has come back, so a slower system is offered less load. A
request is timed from when its client sent it."""
from __future__ import annotations

import asyncio
import time

from portbench.traffic import QueryOrder


async def drive(send, params, *, seed, n_pool, stop, record, span):
    order = QueryOrder(n_pool, seed)

    async def client():
        while not stop.is_set():
            with span("pb.client"):
                i = order.next()
                t_sent = time.perf_counter()
            try:
                result, error = await send(i), None
            except Exception as e:  # noqa: BLE001 - a failed request counts
                result, error = None, e
                await asyncio.sleep(0)   # a refusal at once must not spin
            with span("pb.client"):
                record(i, t_sent, time.perf_counter(), result, error)

    await asyncio.gather(*(client() for _ in range(int(params["clients"]))))

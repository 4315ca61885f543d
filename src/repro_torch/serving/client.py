"""Client-side load generator for the async retrieval server.

The counterpart of ``repro.serving.client.drive``.
"""
from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np


async def drive(server, q_embs, q_masks, q_sals,
                n_requests: Optional[int] = None, rate_qps: float = 0.0,
                seed: int = 0):
    """Submit queries through ``server.query``; returns results in
    submission order.

    Request *i* uses query index ``i % len(q_embs)``. ``rate_qps <= 0``
    is a closed loop (everything submitted at once); ``> 0`` is an
    open-loop Poisson arrival process at that rate.
    """
    rng = np.random.default_rng(seed)
    n = len(q_embs) if n_requests is None else n_requests
    nq = len(q_embs)
    tasks = []
    for i in range(n):
        j = i % nq
        tasks.append(asyncio.ensure_future(
            server.query(q_embs[j], q_masks[j], q_sals[j])))
        if rate_qps > 0:
            await asyncio.sleep(rng.exponential(1.0 / rate_qps))
    return await asyncio.gather(*tasks)

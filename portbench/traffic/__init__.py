"""Traffic mixes: a data file of parameters per mix, read by one generator.

A mix is ``traffic/<mix>.json``; its ``"generator"`` names a module here
(``closed_loop``, ``poisson``) whose ``drive`` sends the mix's requests:

    await drive(send, params, seed=..., n_pool=..., stop=..., record=...,
                span=...)

``send(i)`` sends pool query ``i`` and returns its result; ``record(i,
t_ref, t_done, result, error, late=0.0)`` logs one request, ``t_ref`` being
when its client sent it (closed loop) or when it was due (open loop, which
also passes how late it was sent); ``stop`` (an
``asyncio.Event``) ends the mix: no request is sent after it is set, and
``drive`` returns once every request it sent has come back. ``span(name)``
is a context manager around the generator's own host work (a no-op
outside a traced run). Every request draws its query from ``QueryOrder``,
so one seed gives one sequence of queries.
"""
from __future__ import annotations

import numpy as np


class QueryOrder:
    """Pool indices in an order drawn from the seed: a permutation of the
    pool, then another, and so on."""

    def __init__(self, n_pool: int, seed: int):
        self._rng = np.random.default_rng([int(seed), 1])
        self._n = int(n_pool)
        self._perm = self._rng.permutation(self._n)
        self._pos = 0

    def next(self) -> int:
        if self._pos == self._n:
            self._perm = self._rng.permutation(self._n)
            self._pos = 0
        i = int(self._perm[self._pos])
        self._pos += 1
        return i

"""Live-index serving: mutations interleaved with queries.

The counterpart of ``repro.serving.live``. `LiveIndexSession` couples a
`Retriever` over a *segmented* state (``core.index.SegmentedState``) with
the serving ladder, so the corpus can grow (`add`), shrink (`delete`) and
fold (`compact`) while queries keep flowing.

  * **Serving ladder** — the server's search functions are fixed wrappers
    that read the session's current state when a batch runs; the
    recompile sentry (``ServeConfig.guard_recompiles``) keys on
    (B, Mq, dtypes, level), and mutations never touch it. Swapping state
    never swaps the function the sentry wraps.
  * **State shapes** — deletes and upserts flip live bits (no new
    shapes); adds append segments whose capacity is bucketed to powers of
    two (``segment_capacity``), so the distinct segment-capacity tuples
    grow O(log N) with corpus size, not with the number of mutations, and
    ``compact`` folds everything back to one segment. ``state_signatures``
    exposes the set so soaks can assert it stays bounded: it is what a
    CUDA-graph capture per rung and state shape would key on.

Mutations are atomic swaps: the new state is built from the current one
(no tensor of a published state is written), then published with one
reference assignment. A batch reads the state once, so it runs entirely
against one published state and never sees a half-applied mutation. Every
search and every mutation takes the session's one lock, so they run one
at a time in one order. Searches run on the server's executor threads and
mutations on the caller's thread, all on the default stream, so the
caching allocator reuses a swapped-out state's memory only after the
kernels that read it.

**A placed state** (``Retriever.shard`` on a mesh of more than one rank)
is searched and mutated by every rank of the mesh together, each over its
own rows. Every rank makes the session alike. The mesh's first rank runs
the server: each search function, and each ``add``, ``delete`` and
``compact``, first broadcasts its operation and inputs
(``dist.collectives.broadcast_op``: the batch and its degradation level,
the delta and its ids, the ids to delete) under the lock, so the
broadcasts and the collectives inside the operations reach the other
ranks in the order that rank runs them. The other ranks call ``follow``,
which performs each operation received on their own copy of the state,
in order, until the first rank's ``close`` sends a stop. A fault armed at
the server's compute site fires before the search function, so it
reaches no follower; a follower that is gone makes the first rank's next
broadcast fail within the group's collective timeout.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.dist import collectives as coll
from repro_torch.retrieval.base import (Corpus, Query, RetrieverState,
                                        host_ids, state_mesh)
from repro_torch.retrieval.retriever import Retriever
from repro_torch.serving.server import RetrievalServer, ServeConfig

__all__ = ["LiveIndexSession"]


class LiveIndexSession:
    """Serve queries over an index that mutates between batches.

    ``device`` is where queries are staged; by default the device of the
    state's tensors (dispatch follows the tensors). Over a state placed on
    a mesh of more than one rank, only the mesh's first rank (``leader``)
    has a server; every other rank calls ``follow``.
    """

    def __init__(self, retriever: Retriever, state: RetrieverState,
                 cfg: ServeConfig, *, top_k: Optional[int] = None,
                 device=None):
        self.retriever = retriever
        self.top_k = cfg.top_k if top_k is None else top_k
        # normalize up front so the first add does not change the state's
        # form from monolithic to segmented mid-flight
        self._state = retriever.backend.to_segmented(state)
        self._lock = threading.Lock()
        self._signatures: Dict[Tuple, int] = {}
        self._record_signature()
        mesh = state_mesh(self._state)
        self._mesh = mesh if mesh is not None and mesh.size() > 1 else None
        self.leader = self._mesh is None or not any(
            self._mesh.get_coordinate())

        # the degradation ladder: one function per rung below the
        # configured budgets, each reading the current state the same way
        self.degrade_rungs: Tuple = ()
        if cfg.resilience is not None:
            self.degrade_rungs = retriever.degrade_rungs(self._state,
                                                         k=self.top_k)
        # level 0 the full search, level L rung L - 1 of the ladder
        self.search_fns = tuple(self._level_fn(level) for level in
                                range(1 + len(self.degrade_rungs)))
        self.server = None
        if self.leader:
            if device is None:
                device = self._state.codebook.device
            self.server = RetrievalServer(self.search_fns[0], cfg,
                                          self.search_fns[1:], device=device)

    # -- one order of operations across the mesh ----------------------------

    def _level_fn(self, level: int):
        def search_fn(q, qm, qs):
            return self._do("search", {"level": level}, (q, qm, qs))
        return search_fn

    def _do(self, op: str, meta: dict, tensors: Tuple = ()):
        """On the leader: ``op`` under the lock, broadcast first to the
        followers of a placed state."""
        with self._lock:
            if self._mesh is not None:
                _, _, tensors = coll.broadcast_op(self._mesh, op, meta,
                                                  tensors)
            return self._run(op, meta, tensors)

    def _run(self, op: str, meta: dict, tensors: Tuple):
        """One operation on this rank's state (the caller holds the lock,
        or is a follower)."""
        st = self._state
        if op == "search":
            # read once: the batch runs entirely against this state
            query, level = Query(*tensors), meta["level"]
            if level == 0:
                return self.retriever.search(st, query, k=self.top_k)
            return self.retriever.search_degraded(
                st, query, k=self.top_k, rung=self.degrade_rungs[level - 1])
        if op == "add":
            ids = tensors[3] if meta["doc_ids"] else None
            self._publish(self.retriever.add(st, Corpus(*tensors[:3]),
                                             doc_ids=ids))
        elif op == "delete":
            self._publish(self.retriever.delete(st, tensors[0]))
        elif op == "compact":
            self._publish(self.retriever.compact(st))
        else:
            raise ValueError(f"unknown session operation {op!r}")

    def follow(self) -> int:
        """On every rank but the leader of a placed state: perform each
        operation the leader's session broadcasts, in its order, until
        its ``close``; returns the count performed. An operation that
        fails raises here (the leader's next broadcast then fails too)."""
        if self.leader:
            raise RuntimeError("the leader serves; only the other ranks of "
                               "a placed state's mesh follow")
        n = 0
        while True:
            op, meta, tensors = coll.broadcast_op(self._mesh)
            if op == "stop":
                return n
            self._run(op, meta, tensors)
            n += 1

    # -- state registry ------------------------------------------------------

    def _signature(self, state: RetrieverState) -> Tuple:
        seg = self.retriever.backend._segmented(state)
        caps = tuple(tuple(lv.shape) for lv in seg.live) if seg else ()
        return (caps, state.rerank_codes.shape[0])

    def _record_signature(self) -> None:
        key = self._signature(self._state)
        self._signatures[key] = self._signatures.get(key, 0) + 1

    @property
    def state(self) -> RetrieverState:
        return self._state

    def state_signatures(self) -> Dict[Tuple, int]:
        """Distinct state shape signatures published so far: (segment
        capacities, rerank rows) -> times published."""
        return dict(self._signatures)

    def segment_shapes(self) -> Tuple:
        return self._signature(self._state)[0]

    # -- mutations -----------------------------------------------------------

    def _publish(self, new_state: RetrieverState) -> None:
        self._state = new_state       # atomic reference swap
        self._record_signature()

    def add(self, delta: Corpus, *, doc_ids=None) -> None:
        tensors = tuple(delta)
        if doc_ids is not None:
            tensors += (torch.from_numpy(host_ids(doc_ids)),)
        self._do("add", {"doc_ids": doc_ids is not None}, tensors)

    def delete(self, doc_ids) -> None:
        self._do("delete", {}, (torch.from_numpy(host_ids(doc_ids)),))

    def compact(self) -> None:
        self._do("compact", {})

    # -- serving passthrough -------------------------------------------------

    def query(self, q_emb, q_mask, q_sal, timeout: float = 30.0, *,
              deadline_ms=None, slo="interactive"):
        return self.server.query(q_emb, q_mask, q_sal, timeout=timeout,
                                 deadline_ms=deadline_ms, slo=slo)

    def submit(self, q_emb, q_mask, q_sal, *, deadline_ms=None,
               slo="interactive"):
        return self.server.submit(q_emb, q_mask, q_sal,
                                  deadline_ms=deadline_ms, slo=slo)

    def warm_shapes(self, q_emb, q_mask, q_sal, rungs=None,
                    levels=None) -> None:
        self.server.warm_shapes(q_emb, q_mask, q_sal, rungs, levels)

    def stats(self) -> Dict[str, Any]:
        return self.server.stats()

    def recompile_report(self) -> Optional[Dict[str, Any]]:
        return self.server.recompile_report()

    def build_stats(self) -> Dict[str, float]:
        return self.retriever.build_stats(self._state)

    def close(self) -> None:
        """Drain and stop the server; then, over a placed state, send the
        followers their stop (an error on the way is raised, not
        swallowed). Nothing on a follower."""
        if not self.leader:
            return
        try:
            self.server.close()
        finally:
            if self._mesh is not None:
                with self._lock:
                    coll.broadcast_op(self._mesh, "stop")

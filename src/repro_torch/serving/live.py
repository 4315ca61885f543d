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
reference assignment under ``_mutate_lock``. A batch reads the state once,
so it runs entirely against one published state and never sees a
half-applied mutation. Searches run on the server's executor threads and
mutations on the caller's thread, all on the default stream, so the
caching allocator reuses a swapped-out state's memory only after the
kernels that read it.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from repro_torch.retrieval.base import Corpus, Query, RetrieverState
from repro_torch.retrieval.retriever import Retriever
from repro_torch.serving.server import RetrievalServer, ServeConfig

__all__ = ["LiveIndexSession"]


class LiveIndexSession:
    """Serve queries over an index that mutates between batches.

    ``device`` is where queries are staged; by default the device of the
    state's tensors (dispatch follows the tensors).
    """

    def __init__(self, retriever: Retriever, state: RetrieverState,
                 cfg: ServeConfig, *, top_k: Optional[int] = None,
                 device=None):
        self.retriever = retriever
        self.top_k = cfg.top_k if top_k is None else top_k
        # normalize up front so the first add does not change the state's
        # form from monolithic to segmented mid-flight
        self._state = retriever.backend.to_segmented(state)
        self._mutate_lock = threading.Lock()
        self._signatures: Dict[Tuple, int] = {}
        self._record_signature()

        def search_fn(q, qm, qs):
            # read once: the batch runs entirely against this state
            st = self._state
            return retriever.search(st, Query(q, qm, qs), k=self.top_k)

        # the degradation ladder: one function per rung below the
        # configured budgets, each reading the current state the same way
        self.degrade_rungs: Tuple = ()
        if cfg.resilience is not None:
            self.degrade_rungs = retriever.degrade_rungs(self._state,
                                                         k=self.top_k)

        def _make_degraded(rung):
            def degraded_fn(q, qm, qs):
                st = self._state
                return retriever.search_degraded(st, Query(q, qm, qs),
                                                 k=self.top_k, rung=rung)
            return degraded_fn

        degraded_fns = tuple(_make_degraded(r) for r in self.degrade_rungs)
        if device is None:
            device = self._state.codebook.device
        self.server = RetrievalServer(search_fn, cfg, degraded_fns,
                                      device=device)

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
        with self._mutate_lock:
            self._publish(self.retriever.add(self._state, delta,
                                             doc_ids=doc_ids))

    def delete(self, doc_ids) -> None:
        with self._mutate_lock:
            self._publish(self.retriever.delete(self._state, doc_ids))

    def compact(self) -> None:
        with self._mutate_lock:
            self._publish(self.retriever.compact(self._state))

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
        self.server.close()

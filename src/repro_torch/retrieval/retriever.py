"""`Retriever`: the facade over config-selected index backends.

The counterpart of ``repro.retrieval.retriever``. It owns the stages that
do not depend on the backend — query-side pruning (paper §III-C),
candidate over-fetch, and the rerank over the unpruned quantized corpus
(§III-E2 step 5), which runs through the scan's per-query layout — and
delegates the primary structure to the backend named by ``cfg.backend``.

``shard`` places a state on a ``DeviceMesh`` (each tensor a DTensor, by
the backend's logical-axis specs), and ``search``, ``search_degraded``
and the backends' ``search_candidates`` take such a state at any world
size, one rank included: every rank runs the per-rank programs of
``core.distributed`` over its own rows (a sweep's top k all-gathered and
merged in shard order; a candidate pool scored where its rows live and
all-reduced by MAX), and every rank gets the unsharded answer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import distributed as dist_core
from repro_torch.core import index as index_mod
from repro_torch.core import pruning
from repro_torch.core import scan as scan_mod
from repro_torch.dist.sharding import Sharder
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        RetrieverState, get_backend,
                                        place_state, state_mesh)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Retriever:
    """HPC-ColPali retrieval over a pluggable index backend."""

    cfg: HPCConfig

    @property
    def backend(self) -> IndexBackend:
        return get_backend(self.cfg.backend)

    def build(self, gen: torch.Generator, corpus: Corpus, *,
              mesh=None) -> RetrieverState:
        """Offline indexing (paper §III-E1); ``gen`` is a generator on the
        corpus' device.

        With ``mesh`` (a ``DeviceMesh`` on the corpus' device type, every
        rank holding the whole corpus), the shared encode stages run
        sharded: codebook training through the distributed k-means (points
        over the mesh's corpus axes, per-cluster sums all-reduced) and the
        corpus quantization split over the documents (the
        ``kmeans_assign`` kernel on a card). On one rank the result matches
        the single-host build within float rounding when
        ``kmeans_minibatch`` is 0 (the sharded fit is full-batch Lloyd
        whatever it is).
        """
        return self.backend.build(gen, corpus, self.cfg, mesh=mesh)

    def search(self, state: RetrieverState, query: Query, *, k: int
               ) -> Tuple[Tensor, Tensor]:
        """Online query (paper §III-E2 steps 2-5) -> (scores (B, k),
        doc_ids (B, k)). A state from ``shard`` is searched by every rank
        of its mesh, each over its own rows: the unsharded answer on every
        rank."""
        cfg, backend = self.cfg, self.backend
        with tracing.span("retrieval.search"):
            with tracing.span("retrieval.prune_query"):
                pruned = self._prune_query(query)
            n_cand = k if cfg.rerank == 0 else max(k, cfg.rerank)
            with tracing.span("retrieval.backend"):
                scores, ids = backend.search(state, pruned, k=n_cand,
                                             scan=cfg.scan)
            if cfg.rerank and not backend.exact_scores:
                with tracing.span("retrieval.rerank"):
                    return self._rerank(state, pruned, ids, k=k)
            return scores[:, :k], ids[:, :k]

    def degrade_rungs(self, state: RetrieverState, *, k: int) -> Tuple:
        """Overload degradation rungs for serving: empty for backends
        without a quality-for-latency ladder; the cascade returns its
        budget halvings ending at the Hamming-only floor (None)."""
        backend = self.backend
        if not hasattr(backend, "degrade_rungs"):
            return ()
        return backend.degrade_rungs(state, k=k)

    def search_degraded(self, state: RetrieverState, query: Query, *,
                        k: int, rung) -> Tuple[Tensor, Tensor]:
        """Degraded online query: the same query-side pruning, a cheaper
        funnel (``rung`` from ``degrade_rungs``), no quantized rerank."""
        scores, ids = self.backend.search_degraded(
            state, self._prune_query(query), k=k, rung=rung,
            scan=self.cfg.scan)
        return scores[:, :k], ids[:, :k]

    def _prune_query(self, query: Query) -> Query:
        """Query-side dynamic pruning (paper §III-C), when configured."""
        q_emb, q_mask = query.embeddings, query.mask
        if self.cfg.prune_side in ("query", "both"):
            pr = pruning.prune_topp(q_emb, query.salience, q_mask,
                                    p=self.cfg.p)
            q_emb, q_mask = pr.embeddings, pr.mask
        return Query(q_emb, q_mask, query.salience)

    def _rerank(self, state: RetrieverState, query: Query, ids: Tensor, *,
                k: int) -> Tuple[Tensor, Tensor]:
        mesh = state_mesh(state)
        if mesh is not None:
            return dist_core.sharded_rerank(
                state.rerank_codes, state.rerank_mask, state.codebook,
                query.embeddings, query.mask, ids, k=k, mesh=mesh,
                scan=self.cfg.scan)
        safe = torch.clamp(ids, min=0).to(torch.int64)
        return scan_mod.quantized_maxsim_topk(
            query.embeddings, query.mask,
            index_mod.take_rows(state.rerank_codes, safe),
            state.rerank_mask[safe], state.codebook, k=k, doc_ids=ids,
            valid=ids >= 0, scan=self.cfg.scan)

    # -- mutation (segmented LSM store) ----------------------------------------

    def add(self, state: RetrieverState, delta: Corpus, *,
            doc_ids=None) -> RetrieverState:
        """Append (or upsert) documents without rebuilding. The first
        mutation normalizes a monolithic build into segmented form (the
        same results either way). With explicit ``doc_ids``, ids already
        live are upserted: the prior occurrence is tombstoned and the
        newest segment wins.

        ``add``, ``delete`` and ``compact`` take a state from ``shard`` as
        well, called by every rank of its mesh alike, and return it placed
        on the same mesh: the new segment placed by the backend's specs,
        live bits flipped on the rank that holds them, the id map kept
        replicated. Only ``compact`` (and HNSW's ``add``, which regrows
        its one graph) takes existing segments whole."""
        return self.backend.add(state, delta, self.cfg, doc_ids=doc_ids)

    def delete(self, state: RetrieverState, doc_ids) -> RetrieverState:
        """Tombstone documents by global id: they vanish from search
        results (scores NEG_INF, ids -1) without touching the payload."""
        return self.backend.delete(state, doc_ids)

    def compact(self, state: RetrieverState) -> RetrieverState:
        """Fold all segments into one and drop tombstones: the same
        results over the live corpus, and storage and scan cost shrink to
        the live documents."""
        return self.backend.compact(state, self.cfg)

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        """Measured storage footprint of the built index (paper Table III)."""
        return self.backend.storage_bytes(state)

    def build_stats(self, state: RetrieverState) -> Dict[str, float]:
        """Structure-quality stats of a built index (backend-defined):
        ``ivf`` reports its bucket-overflow drop rate, ``hnsw`` its level-0
        degree and entry level."""
        return self.backend.build_stats(state)

    # -- persistence ------------------------------------------------------------

    def save(self, path: str, state: RetrieverState) -> str:
        """Write ``state`` as an index file of the reference's format v3
        (see ``retrieval/base.py``); returns the path written."""
        return self.backend.save(path, state)

    def load(self, path: str, *, device="cuda") -> RetrieverState:
        """Read an index file (v1-v3, written by either package) onto
        ``device``."""
        return self.backend.load(path, device=device)

    # -- distribution -----------------------------------------------------------

    def shard(self, state: RetrieverState, mesh,
              sharder: Optional[Sharder] = None) -> RetrieverState:
        """Place ``state`` (the same on every rank, on the mesh's device
        type) on ``mesh``: every tensor a DTensor, the corpus dimension
        sharded over the mesh.

        Backends declare logical-axis specs (``shard_specs``); the "corpus"
        axis resolves over ("pod", "data", "model") with the divisibility
        fallback (``dist.sharding``), so the same index shards on any mesh
        that divides its document count and replicates otherwise.
        """
        return place_state(self.backend.shard_specs(state), state, mesh,
                           sharder)


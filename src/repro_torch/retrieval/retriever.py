"""`Retriever`: the facade over config-selected index backends.

The counterpart of ``repro.retrieval.retriever``. It owns the stages that
do not depend on the backend — query-side pruning (paper §III-C),
candidate over-fetch, and the rerank over the unpruned quantized corpus
(§III-E2 step 5), which runs through the scan's per-query layout — and
delegates the primary structure to the backend named by ``cfg.backend``.

``shard`` places a state on a ``DeviceMesh`` (each tensor a DTensor, by
the backend's logical-axis specs), and ``search`` takes such a state: on
one rank every backend searches the local tensors; across ranks the flat
backend sweeps through ``core.distributed.sharded_search_fn`` and each
rank reranks the candidates whose rows it holds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import index as index_mod
from repro_torch.core import pruning
from repro_torch.core import scan as scan_mod
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import (Sharder, distribute, full_tensor,
                                       local, map_specs, shard_index,
                                       sharded_axes)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        RetrieverState, get_backend,
                                        state_map)
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
        doc_ids (B, k)). A state from ``shard`` is searched on its mesh:
        the same answer on every rank."""
        mesh = _state_mesh(state)
        if mesh is not None:
            if mesh.size() > 1:
                return self._search_sharded(state, query, k=k, mesh=mesh)
            state = state_map(local, state)
        cfg, backend = self.cfg, self.backend
        pruned = self._prune_query(query)
        n_cand = k if cfg.rerank == 0 else max(k, cfg.rerank)
        scores, ids = backend.search(state, pruned, k=n_cand, scan=cfg.scan)
        if cfg.rerank and not backend.exact_scores:
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
        safe = torch.clamp(ids, min=0).to(torch.int64)
        return scan_mod.quantized_maxsim_topk(
            query.embeddings, query.mask,
            index_mod.take_rows(state.rerank_codes, safe),
            state.rerank_mask[safe], state.codebook, k=k, doc_ids=ids,
            valid=ids >= 0, scan=self.cfg.scan)

    def _search_sharded(self, state: RetrieverState, query: Query, *,
                        k: int, mesh) -> Tuple[Tensor, Tensor]:
        """The flat backend over a state sharded across ranks: the sweep
        through ``sharded_search_fn``, then the rerank with each rank
        scoring the candidates whose rerank rows it holds (-inf for the
        rest), combined by an all-reduce MAX before the top k."""
        cfg, backend = self.cfg, self.backend
        if backend.name != "flat" or backend._segmented(state) is not None:
            raise NotImplementedError(
                f"searching a {backend.name!r} state sharded over "
                f"{mesh.size()} ranks (only the monolithic flat backend "
                "searches across ranks yet; ROADMAP.md §A item 3)")
        from repro_torch.core import distributed as dist_core
        pruned = self._prune_query(query)
        fs = state.backend_state
        n_cand = k if cfg.rerank == 0 else max(k, cfg.rerank)
        axes = sharded_axes(fs.codes) if isinstance(fs.codes, DTensor) else ()
        scores, ids = dist_core.sharded_search_fn(
            mesh, axes, k=n_cand, scan=cfg.scan)(
                pruned.embeddings, pruned.mask, fs.codes, fs.mask,
                fs.doc_ids, fs.codebook)
        if not cfg.rerank:
            return scores[:, :k], ids[:, :k]
        rc = state.rerank_codes
        axes = sharded_axes(rc) if isinstance(rc, DTensor) else ()
        codes, mask = local(rc), local(state.rerank_mask)
        index, _ = shard_index(mesh, axes)
        rel = ids.to(torch.int64) - index * codes.shape[0]
        own = (ids >= 0) & (rel >= 0) & (rel < codes.shape[0])
        safe = torch.where(own, rel, 0)
        s = kernel_ops.quantized_maxsim(
            pruned.embeddings, pruned.mask, index_mod.take_rows(codes, safe),
            mask[safe], full_tensor(state.codebook), impl=cfg.scan.impl)
        s = coll.all_reduce_axes(torch.where(own, s, float("-inf")), mesh,
                                 axes, op=dist.ReduceOp.MAX)
        valid = ids >= 0
        init = scan_mod._init_buffer(ids.shape[0], k, torch.float32,
                                     ids.device, None)
        return scan_mod._merge(*init, torch.where(valid, s, scan_mod.NEG_INF),
                               torch.where(valid, ids, -1), k)

    # -- mutation (segmented LSM store) ----------------------------------------

    def add(self, state: RetrieverState, delta: Corpus, *,
            doc_ids=None) -> RetrieverState:
        """Append (or upsert) documents without rebuilding. The first
        mutation normalizes a monolithic build into segmented form (the
        same results either way). With explicit ``doc_ids``, ids already
        live are upserted: the prior occurrence is tombstoned and the
        newest segment wins."""
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
        shd = sharder if sharder is not None else Sharder(mesh)

        def place(spec, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            return distribute(leaf, shd.named(tuple(spec), tuple(leaf.shape)))

        return map_specs(place, self.backend.shard_specs(state), state)


def _state_mesh(state):
    """The mesh of a state's first DTensor, or None for a local state."""
    found = []

    def probe(t):
        if not found and isinstance(t, DTensor):
            found.append(t.device_mesh)
        return t

    state_map(probe, state)
    return found[0] if found else None

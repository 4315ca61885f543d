"""`Retriever`: the facade over config-selected index backends.

The counterpart of ``repro.retrieval.retriever``. It owns the stages that
do not depend on the backend — query-side pruning (paper §III-C),
candidate over-fetch, and the rerank over the unpruned quantized corpus
(§III-E2 step 5), which runs through the scan's per-query layout — and
delegates the primary structure to the backend named by ``cfg.backend``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import pruning
from repro_torch.core import scan as scan_mod
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        RetrieverState, get_backend)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Retriever:
    """HPC-ColPali retrieval over a pluggable index backend."""

    cfg: HPCConfig

    @property
    def backend(self) -> IndexBackend:
        return get_backend(self.cfg.backend)

    def build(self, gen: torch.Generator, corpus: Corpus) -> RetrieverState:
        """Offline indexing (paper §III-E1); ``gen`` is a generator on the
        corpus' device."""
        return self.backend.build(gen, corpus, self.cfg)

    def search(self, state: RetrieverState, query: Query, *, k: int
               ) -> Tuple[Tensor, Tensor]:
        """Online query (paper §III-E2 steps 2-5) -> (scores (B, k),
        doc_ids (B, k))."""
        cfg, backend = self.cfg, self.backend
        q_emb, q_mask = query.embeddings, query.mask
        if cfg.prune_side in ("query", "both"):
            pr = pruning.prune_topp(q_emb, query.salience, q_mask, p=cfg.p)
            q_emb, q_mask = pr.embeddings, pr.mask
        pruned = Query(q_emb, q_mask, query.salience)
        n_cand = k if cfg.rerank == 0 else max(k, cfg.rerank)
        scores, ids = backend.search(state, pruned, k=n_cand, scan=cfg.scan)
        if cfg.rerank and not backend.exact_scores:
            return self._rerank(state, pruned, ids, k=k)
        return scores[:, :k], ids[:, :k]

    def _rerank(self, state: RetrieverState, query: Query, ids: Tensor, *,
                k: int) -> Tuple[Tensor, Tensor]:
        safe = torch.clamp(ids, min=0).to(torch.int64)
        return scan_mod.quantized_maxsim_topk(
            query.embeddings, query.mask, state.rerank_codes[safe],
            state.rerank_mask[safe], state.codebook, k=k, doc_ids=ids,
            valid=ids >= 0, scan=self.cfg.scan)

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        """Measured storage footprint of the built index (paper Table III)."""
        return self.backend.storage_bytes(state)

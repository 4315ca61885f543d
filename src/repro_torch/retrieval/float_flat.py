"""`float_flat` backend: uncompressed exhaustive MaxSim (ColPali-Full).

The counterpart of ``repro.retrieval.float_flat``: the paper's fp32
baseline, with no codebook and no rerank (its scores are already exact
late-interaction scores). The float scan runs through the ``maxsim``
kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import index as index_mod
from repro_torch.core import pruning
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        RetrieverState, register_backend)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


def pruned_embeddings(corpus: Corpus, cfg: HPCConfig) -> Tuple[Tensor, Tensor]:
    """The corpus' float embeddings and mask, doc-pruned when the config
    prunes the doc side."""
    emb, mask = corpus.embeddings, corpus.mask.to(torch.bool)
    if cfg.prune_side in ("doc", "both"):
        pr = pruning.prune_topp(emb, corpus.salience, mask, p=cfg.p)
        emb, mask = pr.embeddings, pr.mask
    return emb, mask


@register_backend("float_flat")
class FloatFlatBackend(IndexBackend):
    exact_scores = True

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig) -> RetrieverState:
        n, _, d = corpus.embeddings.shape
        dev = corpus.embeddings.device
        emb, mask = pruned_embeddings(corpus, cfg)
        return RetrieverState(
            codebook=torch.zeros((1, d), dtype=corpus.embeddings.dtype,
                                 device=dev),
            backend_state=index_mod.build_float_flat(emb, mask),
            rerank_codes=torch.zeros((n, 1), dtype=torch.uint8, device=dev),
            rerank_mask=torch.zeros((n, 1), dtype=torch.bool, device=dev))

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        return index_mod.search_float_flat(
            state.backend_state, query.embeddings, query.mask, k=k,
            scan=scan)

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        return index_mod.search_float_flat_candidates(
            state.backend_state, query.embeddings, query.mask,
            candidate_ids, k=k, scan=scan)

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        e = state.backend_state.embeddings
        return {"payload": e.numel() * e.element_size()}

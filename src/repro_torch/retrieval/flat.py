"""`flat` backend: exhaustive fused ADC MaxSim scan over quantized codes.

The paper's main configuration (quantized + flat), and the counterpart of
``repro.retrieval.flat``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import index as index_mod
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        RetrieverState, encode_corpus,
                                        register_backend)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@register_backend("flat")
class FlatBackend(IndexBackend):

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig) -> RetrieverState:
        _, codebook, codes_full, codes, mask = encode_corpus(gen, corpus, cfg)
        return RetrieverState(
            codebook=codebook,
            backend_state=index_mod.build_flat(codes, mask, codebook),
            rerank_codes=codes_full,
            rerank_mask=corpus.mask.to(torch.bool))

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        return index_mod.search_flat(state.backend_state, query.embeddings,
                                     query.mask, k=k, scan=scan)

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        return index_mod.search_flat_candidates(
            state.backend_state, query.embeddings, query.mask,
            candidate_ids, k=k, scan=scan)

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        codes = state.backend_state.codes
        cb = state.codebook
        return {"payload": codes.numel() * codes.element_size(),
                "codebook": cb.numel() * cb.element_size()}

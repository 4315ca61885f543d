"""`hamming` backend: binary codes + popcount MaxSim (paper §III-D).

The counterpart of ``repro.retrieval.hamming``. Queries are quantized to
centroid indices (through the ``kmeans_assign`` kernel on the card) with
the code dtype of a ``2**bits``-entry codebook, and scored against the
corpus' b-bit codes by the ``hamming_maxsim`` kernel. Scores are int32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import binary as binary_mod
from repro_torch.core import index as index_mod
from repro_torch.core import quantization as quant
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        RetrieverState, code_dtype,
                                        encode_corpus, register_backend)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class HammingState:
    """HammingIndex + the bit width."""

    index: index_mod.HammingIndex
    bits: int


@register_backend("hamming")
class HammingBackend(IndexBackend):

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig) -> RetrieverState:
        _, codebook, codes_full, codes, mask = encode_corpus(gen, corpus, cfg)
        ham = index_mod.build_hamming(codes, mask, cfg.bits)
        return RetrieverState(
            codebook=codebook,
            backend_state=HammingState(ham, cfg.bits),
            rerank_codes=codes_full,
            rerank_mask=corpus.mask.to(torch.bool))

    def _q_codes(self, state: RetrieverState, query: Query) -> Tensor:
        return quant.quantize(query.embeddings, state.codebook,
                              code_dtype=code_dtype(
                                  1 << state.backend_state.bits))

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        s = state.backend_state
        return index_mod.search_hamming(s.index, self._q_codes(state, query),
                                        query.mask, bits=s.bits, k=k,
                                        scan=scan)

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        s = state.backend_state
        return index_mod.search_hamming_candidates(
            s.index, self._q_codes(state, query), query.mask, candidate_ids,
            bits=s.bits, k=k, scan=scan)

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        s = state.backend_state
        cb = state.codebook
        return {"payload": binary_mod.packed_nbytes(s.index.codes.numel(),
                                                    s.bits),
                "codebook": cb.numel() * cb.element_size()}

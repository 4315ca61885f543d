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

from repro_torch import tracing
from repro_torch.core import binary as binary_mod
from repro_torch.core import distributed as dist_core
from repro_torch.core import index as index_mod
from repro_torch.core import quantization as quant
from repro_torch.dist.sharding import local
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        abstract_layout, abstract_tensor,
                                        code_dtype,
                                        RetrieverState, code_dtype,
                                        encode_corpus, register_backend,
                                        state_mesh)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class HammingState:
    """HammingIndex + the bit width (a knob: ``aux`` in an index file)."""

    index: index_mod.HammingIndex
    bits: int


@register_backend("hamming")
class HammingBackend(IndexBackend):

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig, mesh=None) -> RetrieverState:
        _, codebook, codes_full, codes, mask = encode_corpus(gen, corpus, cfg,
                                                             mesh=mesh)
        ham = index_mod.build_hamming(codes, mask, cfg.bits)
        return RetrieverState(
            codebook=codebook,
            backend_state=HammingState(ham, cfg.bits),
            rerank_codes=codes_full,
            rerank_mask=corpus.mask.to(torch.bool))

    def _q_codes(self, state: RetrieverState, query: Query) -> Tensor:
        with tracing.span("hamming.query_codes"):
            return quant.quantize(query.embeddings, local(state.codebook),
                                  code_dtype=code_dtype(
                                      1 << state.backend_state.bits))

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        s = state.backend_state
        q_codes = self._q_codes(state, query)
        seg = self._segmented(state)
        mesh = state_mesh(state)
        if mesh is not None:
            return dist_core.sharded_sweep(
                seg if seg is not None else s.index, q_codes, query.mask,
                kind="binary", k=k, mesh=mesh, bits=s.bits, scan=scan)
        if seg is not None:
            return index_mod.search_hamming_segmented(
                seg, q_codes, query.mask, bits=s.bits, k=k, scan=scan)
        return index_mod.search_hamming(s.index, q_codes, query.mask,
                                        bits=s.bits, k=k, scan=scan)

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        s = state.backend_state
        q_codes = self._q_codes(state, query)
        seg = self._segmented(state)
        mesh = state_mesh(state)
        if mesh is not None:
            return dist_core.sharded_candidates(
                seg if seg is not None else s.index, q_codes, query.mask,
                candidate_ids, kind="binary", k=k, mesh=mesh, bits=s.bits,
                scan=scan)
        if seg is not None:
            return index_mod.search_hamming_segmented_candidates(
                seg, q_codes, query.mask, candidate_ids, bits=s.bits, k=k,
                scan=scan)
        return index_mod.search_hamming_candidates(
            s.index, q_codes, query.mask, candidate_ids, bits=s.bits, k=k,
            scan=scan)

    # -- mutation hooks ------------------------------------------------------

    def _delta_segment(self, state, seg, enc, delta, cfg, doc_ids):
        _, codes, mask = enc
        return index_mod.make_hamming_segment(
            codes, mask, state.backend_state.bits, doc_ids)

    def _compact_payload(self, state, seg, cfg):
        (codes, mask), ids = index_mod.gather_live_rows(
            seg, ("codes", "mask"))
        return (index_mod.HammingIndex(codes, mask, ids,
                                       state.backend_state.bits), ids >= 0)

    def _seg_payload_bytes(self, payload, n_live: int) -> int:
        return binary_mod.packed_nbytes(n_live * payload.codes.shape[-1],
                                        int(payload.bits))

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        s = state.backend_state
        seg = self._segmented(state)
        if seg is not None:
            return self._segmented_storage(state, seg)
        cb = state.codebook
        return {"payload": binary_mod.packed_nbytes(s.index.codes.numel(),
                                                    s.bits),
                "codebook": cb.numel() * cb.element_size()}

    def _state_aux(self, state: RetrieverState):
        return state.backend_state.bits

    def abstract_state(self, *, n: int, md: int = 16, d: int = 16,
                       k: int = 256, device="meta", **knobs
                       ) -> RetrieverState:
        bits = knobs.get("bits", binary_mod.bits_for_k(k))
        cdt = code_dtype(k)

        def payload(cap):
            # the port stores Hamming codes as uint16 whatever the bits
            return index_mod.HammingIndex(
                abstract_tensor((cap, md), torch.uint16, device),
                abstract_tensor((cap, md), torch.bool, device),
                abstract_tensor((cap,), torch.int32, device), bits)

        bs, rows = abstract_layout(payload, n, knobs, lambda c: (c,), device)
        return RetrieverState(abstract_tensor((k, d), torch.float32, device),
                              HammingState(bs, bits),
                              abstract_tensor((rows, md), cdt, device),
                              abstract_tensor((rows, md), torch.bool, device))

    def state_template(self, aux, n_segments: int = 0) -> RetrieverState:
        # bits: a 0-d int32 leaf of HammingIndex in the reference, and
        # HammingState's knob (aux)
        return RetrieverState(None, HammingState(index_mod.segmented_template(
            index_mod.HammingIndex(None, None, None, 0), n_segments),
            int(aux)), None, None)

"""`flat` backend: exhaustive fused ADC MaxSim scan over quantized codes.

The paper's main configuration (quantized + flat), and the counterpart of
``repro.retrieval.flat``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import distributed as dist_core
from repro_torch.core import index as index_mod
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        abstract_layout, abstract_tensor,
                                        code_dtype,
                                        RetrieverState, encode_corpus,
                                        register_backend, state_mesh)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@register_backend("flat")
class FlatBackend(IndexBackend):

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig, mesh=None) -> RetrieverState:
        _, codebook, codes_full, codes, mask = encode_corpus(gen, corpus, cfg,
                                                             mesh=mesh)
        return RetrieverState(
            codebook=codebook,
            backend_state=index_mod.build_flat(codes, mask, codebook),
            rerank_codes=codes_full,
            rerank_mask=corpus.mask.to(torch.bool))

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        seg = self._segmented(state)
        mesh = state_mesh(state)
        if mesh is not None:
            return dist_core.sharded_sweep(
                seg if seg is not None else state.backend_state,
                query.embeddings, query.mask, kind="adc", k=k, mesh=mesh,
                scan=scan)
        if seg is not None:
            return index_mod.search_flat_segmented(
                seg, query.embeddings, query.mask, k=k, scan=scan)
        return index_mod.search_flat(state.backend_state, query.embeddings,
                                     query.mask, k=k, scan=scan)

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        seg = self._segmented(state)
        mesh = state_mesh(state)
        if mesh is not None:
            return dist_core.sharded_candidates(
                seg if seg is not None else state.backend_state,
                query.embeddings, query.mask, candidate_ids, kind="adc", k=k,
                mesh=mesh, scan=scan)
        if seg is not None:
            return index_mod.search_flat_segmented_candidates(
                seg, query.embeddings, query.mask, candidate_ids, k=k,
                scan=scan)
        return index_mod.search_flat_candidates(
            state.backend_state, query.embeddings, query.mask,
            candidate_ids, k=k, scan=scan)

    def shard_specs(self, state: RetrieverState):
        specs = super().shard_specs(state)
        # the FlatIndex carries its own codebook copy: replicate it
        seg = self._segmented(state)
        if seg is not None:
            bs = specs.backend_state
            return specs._replace(backend_state=dataclasses.replace(
                bs, segments=tuple(p._replace(codebook=(None, None))
                                   for p in bs.segments)))
        return specs._replace(
            backend_state=specs.backend_state._replace(codebook=(None, None)))

    # -- mutation hooks ------------------------------------------------------

    def _delta_segment(self, state, seg, enc, delta, cfg, doc_ids):
        _, codes, mask = enc
        return index_mod.make_flat_segment(codes, mask, state.codebook,
                                           doc_ids)

    def _compact_payload(self, state, seg, cfg):
        (codes, mask), ids = index_mod.gather_live_rows(
            seg, ("codes", "mask"))
        return index_mod.FlatIndex(codes, mask, state.codebook, ids), ids >= 0

    def _seg_payload_bytes(self, payload, n_live: int) -> int:
        codes = payload.codes
        return n_live * codes.shape[-1] * codes.element_size()

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        seg = self._segmented(state)
        if seg is not None:
            return self._segmented_storage(state, seg)
        codes = state.backend_state.codes
        cb = state.codebook
        return {"payload": codes.numel() * codes.element_size(),
                "codebook": cb.numel() * cb.element_size()}

    def abstract_state(self, *, n: int, md: int = 16, d: int = 16,
                       k: int = 256, device="meta", **knobs
                       ) -> RetrieverState:
        cdt = code_dtype(k)
        codebook = abstract_tensor((k, d), torch.float32, device)

        def payload(cap):
            return index_mod.FlatIndex(
                abstract_tensor((cap, md), cdt, device),
                abstract_tensor((cap, md), torch.bool, device), codebook,
                abstract_tensor((cap,), torch.int32, device))

        bs, rows = abstract_layout(payload, n, knobs, lambda c: (c,), device)
        return RetrieverState(codebook, bs,
                              abstract_tensor((rows, md), cdt, device),
                              abstract_tensor((rows, md), torch.bool, device))

    def state_template(self, aux, n_segments: int = 0) -> RetrieverState:
        return RetrieverState(None, index_mod.segmented_template(
            index_mod.FlatIndex(None, None, None, None), n_segments),
            None, None)

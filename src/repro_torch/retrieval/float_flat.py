"""`float_flat` backend: uncompressed exhaustive MaxSim (ColPali-Full).

The counterpart of ``repro.retrieval.float_flat``: the paper's fp32
baseline, with no codebook and no rerank (its scores are already exact
late-interaction scores). The float scan runs through the ``maxsim``
kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import distributed as dist_core
from repro_torch.core import index as index_mod
from repro_torch.core import pruning
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        abstract_layout, abstract_tensor,
                                        RetrieverState, register_backend,
                                        state_mesh)
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
              cfg: HPCConfig, mesh=None) -> RetrieverState:
        """No codebook to train: ``mesh`` is accepted and not used."""
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
        seg = self._segmented(state)
        mesh = state_mesh(state)
        if mesh is not None:
            return dist_core.sharded_sweep(
                seg if seg is not None else state.backend_state,
                query.embeddings, query.mask, kind="float", k=k, mesh=mesh,
                scan=scan)
        if seg is not None:
            return index_mod.search_float_flat_segmented(
                seg, query.embeddings, query.mask, k=k, scan=scan)
        return index_mod.search_float_flat(
            state.backend_state, query.embeddings, query.mask, k=k,
            scan=scan)

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
                query.embeddings, query.mask, candidate_ids, kind="float",
                k=k, mesh=mesh, scan=scan)
        if seg is not None:
            return index_mod.search_float_flat_segmented_candidates(
                seg, query.embeddings, query.mask, candidate_ids, k=k,
                scan=scan)
        return index_mod.search_float_flat_candidates(
            state.backend_state, query.embeddings, query.mask,
            candidate_ids, k=k, scan=scan)

    # -- mutation hooks ------------------------------------------------------

    def _encode_delta(self, state, delta, cfg):
        # no codebook: the payload is the (doc-pruned) float embeddings
        emb, mask = pruned_embeddings(delta, cfg)
        return emb, emb, mask

    def _delta_segment(self, state, seg, enc, delta, cfg, doc_ids):
        _, emb, mask = enc
        return index_mod.make_float_flat_segment(emb, mask, doc_ids)

    def _rerank_delta_rows(self, enc, delta):
        # exact scores: the facade never reranks; keep the placeholder rows
        # the build writes
        n = delta.embeddings.shape[0]
        dev = delta.embeddings.device
        return (torch.zeros((n, 1), dtype=torch.uint8, device=dev),
                torch.zeros((n, 1), dtype=torch.bool, device=dev))

    def _compact_payload(self, state, seg, cfg):
        (emb, mask), ids = index_mod.gather_live_rows(
            seg, ("embeddings", "mask"))
        return index_mod.FloatFlatIndex(emb, mask, ids), ids >= 0

    def _seg_payload_bytes(self, payload, n_live: int) -> int:
        e = payload.embeddings
        return n_live * e.shape[-2] * e.shape[-1] * e.element_size()

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        seg = self._segmented(state)
        if seg is not None:
            out = self._segmented_storage(state, seg)
            out.pop("codebook", None)    # the (1, d) placeholder
            return out
        e = state.backend_state.embeddings
        return {"payload": e.numel() * e.element_size()}

    def abstract_state(self, *, n: int, md: int = 16, d: int = 16,
                       k: int = 256, device="meta", **knobs
                       ) -> RetrieverState:
        def payload(cap):
            return index_mod.FloatFlatIndex(
                abstract_tensor((cap, md, d), torch.float32, device),
                abstract_tensor((cap, md), torch.bool, device),
                abstract_tensor((cap,), torch.int32, device))

        bs, rows = abstract_layout(payload, n, knobs, lambda c: (c,), device)
        return RetrieverState(abstract_tensor((1, d), torch.float32, device),
                              bs,
                              abstract_tensor((rows, 1), torch.uint8, device),
                              abstract_tensor((rows, 1), torch.bool, device))

    def state_template(self, aux, n_segments: int = 0) -> RetrieverState:
        return RetrieverState(None, index_mod.segmented_template(
            index_mod.FloatFlatIndex(None, None, None), n_segments),
            None, None)

"""`hnsw` backend: layered small-world graph routing (paper §IV).

The counterpart of ``repro.retrieval.hnsw``. The graph (core/graph.py)
walks the documents' mean decoded-patch vectors to ``ef_search``
candidates, which are scored through the same ``quantized_maxsim`` scan
as IVF's pools, so the two routers compare at equal scanned budgets
(``ef_search`` against ``n_probe * bucket_cap``). ``ef_search`` is a knob
of the state (``HNSWState``), carried as ``aux`` in an index file.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import distributed as dist_core
from repro_torch.core import graph as graph_mod
from repro_torch.core import index as index_mod
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        abstract_layout, abstract_tensor,
                                        code_dtype,
                                        RetrieverState, encode_corpus,
                                        register_backend, state_mesh)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class HNSWState:
    """HNSWIndex + the ef_search search knob."""

    index: graph_mod.HNSWIndex
    ef_search: int


def _mean_degree_l0(ix: graph_mod.HNSWIndex) -> float:
    """Mean level-0 out-degree over the filled rows (all rows of a
    monolithic build), in float32 as the reference computes it."""
    filled = ix.doc_ids >= 0
    degree = (ix.neighbors[0] >= 0).sum(dim=-1).to(torch.float32)
    n = torch.clamp(filled.sum().to(torch.float32), min=1.0)
    return float((degree * filled).sum() / n)


@register_backend("hnsw")
class HNSWBackend(IndexBackend):

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig, mesh=None) -> RetrieverState:
        """Encode, then insert every document into the graph on the host
        (sequential; the level draws come from ``gen``)."""
        _, codebook, codes_full, codes, mask = encode_corpus(gen, corpus, cfg,
                                                             mesh=mesh)
        hn = graph_mod.build_hnsw(gen, codes, mask, codebook, cfg.hnsw)
        return RetrieverState(
            codebook=codebook,
            backend_state=HNSWState(hn, cfg.hnsw.ef_search),
            rerank_codes=codes_full,
            rerank_mask=corpus.mask.to(torch.bool))

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        s = state.backend_state
        seg = self._segmented(state)
        mesh = state_mesh(state)
        if mesh is not None:
            index, live = ((seg.segments[0], seg.live[0]) if seg is not None
                           else (s.index, None))
            return dist_core.sharded_hnsw(
                index, live, query.embeddings, query.mask,
                ef_search=s.ef_search, k=k, mesh=mesh, scan=scan)
        if seg is not None:
            return graph_mod.search_hnsw_live(
                seg.segments[0], seg.live[0], query.embeddings, query.mask,
                ef_search=s.ef_search, k=k, scan=scan)
        return graph_mod.search_hnsw(s.index, query.embeddings, query.mask,
                                     ef_search=s.ef_search, k=k, scan=scan)

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        # the graph walk generates the candidates; it scores no pool it
        # is given
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        raise NotImplementedError(
            "backend 'hnsw' generates candidates via its graph walk and "
            "does not support candidate-restricted search; use "
            "flat/float_flat/hamming as cascade stages")

    # -- mutation hooks ------------------------------------------------------
    # one growable graph segment: appends insert into the graph rather than
    # stacking segments a walk could not cross

    def _append_segment(self, state: RetrieverState, seg, enc, delta,
                        cfg: HPCConfig, doc_ids: Tensor):
        _, codes, mask = enc
        ix, live = graph_mod.hnsw_insert(
            seg.segments[0], seg.live[0], codes, mask, doc_ids, cfg.hnsw)
        return index_mod.SegmentedState((ix,), (live,), seg.pos_of_id)

    def _compact_payload(self, state: RetrieverState, seg, cfg: HPCConfig):
        return graph_mod.hnsw_compact(seg.segments[0], seg.live[0],
                                      cfg.hnsw)

    def _seg_payload_bytes(self, payload, n_live: int) -> int:
        codes = payload.codes
        return n_live * codes.shape[-1] * codes.element_size()

    @staticmethod
    def _graph_bytes(ix: graph_mod.HNSWIndex) -> int:
        # capacity-resident: tombstones stay routable until compact
        return (ix.neighbors.numel() * ix.neighbors.element_size()
                + ix.doc_vecs.numel() * ix.doc_vecs.element_size())

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        seg = self._segmented(state)
        if seg is not None:
            out = self._segmented_storage(state, seg)
            out["graph"] = self._graph_bytes(seg.segments[0])
            return out
        ix = state.backend_state.index
        cb = state.codebook
        return {"payload": ix.codes.numel() * ix.codes.element_size(),
                "graph": self._graph_bytes(ix),
                "codebook": cb.numel() * cb.element_size()}

    def build_stats(self, state: RetrieverState) -> Dict[str, float]:
        seg = self._segmented(state)
        if seg is not None:
            out = self._segment_stats(seg)
            ix = seg.segments[0]
            out["mean_degree_l0"] = _mean_degree_l0(ix)
            out["levels"] = float(ix.neighbors.shape[0])
            out["entry_level"] = float(ix.node_level[ix.entry])
            return out
        ix = state.backend_state.index
        return {"mean_degree_l0": _mean_degree_l0(ix),
                "levels": int(ix.neighbors.shape[0]),
                "entry_level": int(ix.node_level[ix.entry])}

    def shard_specs(self, state: RetrieverState):
        # The walk needs the whole adjacency and routing vectors, so the
        # graph replicates; the scan payload (codes) and the rerank rows
        # shard over the corpus axis like every other backend.
        def graph_leaf_specs():
            return graph_mod.HNSWIndex(
                doc_vecs=(None, None),
                neighbors=(None, None, None),
                entry=(),
                node_level=(None,),
                codes=("corpus", None),
                mask=("corpus", None),
                doc_ids=("corpus",),
                codebook=(None, None))

        seg = self._segmented(state)
        if seg is not None:
            # live bits replicate: the walk reads them on every shard
            bs = index_mod.SegmentedState(
                tuple(graph_leaf_specs() for _ in seg.segments),
                tuple((None,) for _ in seg.live),
                (None,))
        else:
            bs = graph_leaf_specs()
        return RetrieverState(
            codebook=(None, None),
            backend_state=HNSWState(bs, state.backend_state.ef_search),
            rerank_codes=("corpus", None),
            rerank_mask=("corpus", None))

    # -- persistence ------------------------------------------------------

    def _state_aux(self, state: RetrieverState):
        return state.backend_state.ef_search

    def abstract_state(self, *, n: int, md: int = 16, d: int = 16,
                       k: int = 256, device="meta", **knobs
                       ) -> RetrieverState:
        cfg = graph_mod.HNSWConfig()
        levels = knobs.get("levels", cfg.levels)
        m = knobs.get("m", cfg.m)
        ef_search = knobs.get("ef_search", cfg.ef_search)
        cdt = code_dtype(k)
        codebook = abstract_tensor((k, d), torch.float32, device)

        def payload(cap):
            return graph_mod.HNSWIndex(
                abstract_tensor((cap, d), torch.float32, device),
                abstract_tensor((levels, cap, 2 * m), torch.int32, device),
                0, abstract_tensor((cap,), torch.int32, device),
                abstract_tensor((cap, md), cdt, device),
                abstract_tensor((cap, md), torch.bool, device),
                abstract_tensor((cap,), torch.int32, device), codebook)

        knobs = dict(knobs)
        if knobs.get("segments") is not None:
            # one growable graph segment: only segments[0] is used
            knobs["segments"] = tuple(knobs["segments"][:1])
        bs, rows = abstract_layout(payload, n, knobs, lambda c: (c,), device)
        return RetrieverState(codebook, HNSWState(bs, ef_search),
                              abstract_tensor((rows, md), cdt, device),
                              abstract_tensor((rows, md), torch.bool, device))

    def state_template(self, aux, n_segments: int = 0) -> RetrieverState:
        # entry: a 0-d int32 leaf in the reference, a Python int here
        graph = graph_mod.HNSWIndex(None, None, 0, None, None, None, None,
                                    None)
        return RetrieverState(None, HNSWState(index_mod.segmented_template(
            graph, n_segments), int(aux)), None, None)

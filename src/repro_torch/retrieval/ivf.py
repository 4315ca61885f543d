"""`ivf` backend: centroid routing over padded-dense buckets.

The counterpart of ``repro.retrieval.ivf``. Documents bucket by the routing
cluster of their mean decoded patch (the assignment runs the
``kmeans_assign`` kernel on the card); a query scores the routing
centroids with one matmul and scans only its ``n_probe`` nearest buckets,
as one per-query pool through the ``quantized_maxsim`` kernel. ``n_probe``
is a knob of the state (``IVFState``), so ``search(state, query, k=...)``
is self-contained; an index file carries it as ``aux``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Tuple

import torch

from repro_torch.core import distributed as dist_core
from repro_torch.core import index as index_mod
from repro_torch.dist.sharding import local
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        abstract_layout, abstract_tensor,
                                        code_dtype,
                                        RetrieverState, encode_corpus,
                                        register_backend, state_mesh)
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class IVFState:
    """IVFIndex + the n_probe search knob."""

    index: index_mod.IVFIndex
    n_probe: int


@register_backend("ivf")
class IVFBackend(IndexBackend):

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig, mesh=None) -> RetrieverState:
        """Encode, then bucket. Fails if bucket overflow dropped more than
        ``cfg.ivf.max_drop_rate`` of the documents (they would be absent
        from every search), and warns on any drop."""
        _, codebook, codes_full, codes, mask = encode_corpus(gen, corpus, cfg,
                                                             mesh=mesh)
        ivf = index_mod.build_ivf(gen, codes, mask, codebook, cfg.ivf)
        n_docs = corpus.embeddings.shape[0]
        drop = index_mod.ivf_drop_rate(ivf, n_docs)
        if drop > cfg.ivf.max_drop_rate:
            raise ValueError(
                f"IVF bucket overflow dropped {drop:.2%} of {n_docs} docs "
                f"(> max_drop_rate={cfg.ivf.max_drop_rate:.2%}); raise "
                "bucket_cap/n_list or rebalance the routing clustering")
        if drop > 0:
            warnings.warn(
                f"IVF bucket overflow dropped {drop:.2%} of {n_docs} docs "
                f"(within max_drop_rate={cfg.ivf.max_drop_rate:.2%})",
                stacklevel=2)
        return RetrieverState(
            codebook=codebook,
            backend_state=IVFState(ivf, cfg.ivf.n_probe),
            rerank_codes=codes_full,
            rerank_mask=corpus.mask.to(torch.bool))

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        s = state.backend_state
        seg = self._segmented(state)
        mesh = state_mesh(state)
        if mesh is not None:
            return dist_core.sharded_ivf(
                seg if seg is not None else s.index, query.embeddings,
                query.mask, n_probe=s.n_probe, k=k, mesh=mesh, scan=scan)
        if seg is not None:
            return index_mod.search_ivf_segmented(
                seg, query.embeddings, query.mask, n_probe=s.n_probe, k=k,
                scan=scan)
        return index_mod.search_ivf(s.index, query.embeddings, query.mask,
                                    n_probe=s.n_probe, k=k, scan=scan)

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        # the bucketed layout has no position -> doc addressing, and the
        # routing already narrows the candidates
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        raise NotImplementedError(
            "backend 'ivf' routes its own candidates (n_probe buckets) and "
            "does not support candidate-restricted search; use "
            "flat/float_flat/hamming as cascade stages")

    # -- mutation hooks ------------------------------------------------------

    def _delta_segment(self, state, seg, enc, delta, cfg, doc_ids):
        _, codes, mask = enc
        return index_mod.make_ivf_segment(
            codes, mask, local(state.codebook),
            local(seg.segments[0].routing_centroids), doc_ids)

    def _compact_payload(self, state, seg, cfg):
        # the live docs, bucket after bucket and segment after segment,
        # re-bucketed through the shared centroids (loads rebalance)
        (codes, mask), ids = index_mod.gather_live_rows(
            seg, ("bucket_codes", "bucket_mask"))
        n_live = int((ids >= 0).sum())
        return index_mod.make_ivf_segment(
            codes[:n_live], mask[:n_live], local(state.codebook),
            local(seg.segments[0].routing_centroids), ids[:n_live])

    def _seg_payload_bytes(self, payload, n_live: int) -> int:
        codes = payload.bucket_codes
        return n_live * codes.shape[-1] * codes.element_size()

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        seg = self._segmented(state)
        if seg is not None:
            return self._segmented_storage(state, seg)
        codes = state.backend_state.index.bucket_codes
        cb = state.codebook
        return {"payload": codes.numel() * codes.element_size(),
                "codebook": cb.numel() * cb.element_size()}

    def build_stats(self, state: RetrieverState) -> Dict[str, float]:
        seg = self._segmented(state)
        if seg is not None:
            # segments admit every doc (their cap is the realised largest
            # load), so the drop rate is a build-time number only
            out = self._segment_stats(seg)
            first = seg.segments[0]
            out["n_list"] = int(first.bucket_valid.shape[0])
            out["bucket_cap"] = int(first.bucket_valid.shape[1])
            return out
        ix = state.backend_state.index
        n_docs = state.rerank_codes.shape[0]
        return {"ivf_drop_rate": index_mod.ivf_drop_rate(ix, n_docs),
                "n_list": int(ix.bucket_valid.shape[0]),
                "bucket_cap": int(ix.bucket_valid.shape[1])}

    def shard_specs(self, state: RetrieverState):
        # buckets (dim 0 = n_list) spread over the corpus axes; routing
        # centroids and codebook replicated (every query scores them all)
        def ivf_leaf_specs():
            return index_mod.IVFIndex(
                routing_centroids=(None, None),
                bucket_codes=("corpus", None, None),
                bucket_mask=("corpus", None, None),
                bucket_valid=("corpus", None),
                bucket_doc_ids=("corpus", None),
                codebook=(None, None))

        seg = self._segmented(state)
        if seg is not None:
            bs = index_mod.SegmentedState(
                tuple(ivf_leaf_specs() for _ in seg.segments),
                tuple(("corpus", None) for _ in seg.live),
                (None,))
        else:
            bs = ivf_leaf_specs()
        return RetrieverState(
            codebook=(None, None),
            backend_state=IVFState(bs, state.backend_state.n_probe),
            rerank_codes=("corpus", None),
            rerank_mask=("corpus", None))

    # -- persistence ------------------------------------------------------

    def _state_aux(self, state: RetrieverState):
        return state.backend_state.n_probe

    def abstract_state(self, *, n: int, md: int = 16, d: int = 16,
                       k: int = 256, device="meta", **knobs
                       ) -> RetrieverState:
        n_list = knobs.get("n_list", index_mod.IVFConfig.n_list)
        n_probe = knobs.get("n_probe", index_mod.IVFConfig.n_probe)
        # the build's padded-dense capacity rule (2x the mean load)
        cap = knobs.get("bucket_cap", int(max(8, 2 * -(-n // n_list))))
        cdt = code_dtype(k)
        codebook = abstract_tensor((k, d), torch.float32, device)
        routing = abstract_tensor((n_list, d), torch.float32, device)

        def payload(bucket_cap):
            return index_mod.IVFIndex(
                routing,
                abstract_tensor((n_list, bucket_cap, md), cdt, device),
                abstract_tensor((n_list, bucket_cap, md), torch.bool, device),
                abstract_tensor((n_list, bucket_cap), torch.bool, device),
                abstract_tensor((n_list, bucket_cap), torch.int32, device),
                codebook)

        # segments: per-segment *bucket* capacities
        knobs = dict(knobs)
        if knobs.get("segments") is None:
            bs, rows = payload(cap), n
        else:
            bs, rows = abstract_layout(
                payload, n, knobs, lambda c: (n_list, c), device,
                id_cap_of=lambda s: index_mod.segment_capacity(n_list * s))
        return RetrieverState(codebook, IVFState(bs, n_probe),
                              abstract_tensor((rows, md), cdt, device),
                              abstract_tensor((rows, md), torch.bool, device))

    def state_template(self, aux, n_segments: int = 0) -> RetrieverState:
        return RetrieverState(None, IVFState(index_mod.segmented_template(
            index_mod.IVFIndex(*(None,) * 6), n_segments), int(aux)),
            None, None)

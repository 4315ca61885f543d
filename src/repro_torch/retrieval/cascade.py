"""`cascade` backend: the staged compression funnel.

The counterpart of ``repro.retrieval.cascade``. Three member backends
search one shared encode (codebook + quantized corpus, done once by
``encode_corpus``):

    stage 1  hamming     popcount prefilter over all N docs  -> top p1
    stage 2  flat (ADC)  quantized rescore of the p1 pool    -> top p2
    stage 3  float_flat  exact late-interaction rerank       -> top k

Stages 2-3 run through ``search_candidates``, the per-query (B, P) layout
of the streaming scan, so they cost O(B * p) rather than O(N). On the
card the stages run the ``hamming_maxsim``, ``quantized_maxsim`` and
``maxsim`` kernels, and stage 1's query codes the ``kmeans_assign``
kernel. The -1 sentinel contract holds at every boundary: a stage that
surfaces fewer than its budget of valid candidates hands -1 rows
downstream, where they are never scored and stay -1 in the output.

The budgets (p1, p2) come from ``HPCConfig.cascade`` at build time and
ride in the state; ``with_budgets`` derives a state with other budgets
over the same tensors (the serving degradation ladder's rungs).

Mutation composes member-wise: ``add``/``delete``/``compact`` run on every
member in lockstep (ids resolved once), so the members' segment lists,
live bits and ``pos_of_id`` agree, and stage outputs (global ids) resolve
to rows in the next stage through ``pos_of_id``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import binary as binary_mod
from repro_torch.core import index as index_mod
from repro_torch.retrieval.base import (Corpus, IndexBackend, Query,
                                        RetrieverState, abstract_tensor,
                                        code_dtype, encode_corpus,
                                        get_backend, register_backend)
from repro_torch.retrieval.config import HPCConfig
from repro_torch.retrieval.float_flat import pruned_embeddings
from repro_torch.retrieval.hamming import HammingState

Tensor = torch.Tensor

# member backends, coarse -> exact
STAGES = ("hamming", "flat", "float_flat")


@dataclasses.dataclass
class CascadeState:
    """Member states (HammingState, FlatIndex, FloatFlatIndex) + the
    (p1, p2) stage budgets."""

    members: Tuple
    p1: int
    p2: int


@register_backend("cascade")
class CascadeBackend(IndexBackend):
    # the final stage scores raw embeddings — exact late-interaction
    # scores, so the facade skips its quantized rerank (like float_flat)
    exact_scores = True

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig, mesh=None) -> RetrieverState:
        """One shared encode, three member structures over it: the Hamming
        and ADC stages index the same pruned codes, so the funnel adds only
        the float stage's embeddings to what `flat` alone would store."""
        _, codebook, codes_full, codes, mask = encode_corpus(gen, corpus, cfg,
                                                             mesh=mesh)
        ham = HammingState(index_mod.build_hamming(codes, mask, cfg.bits),
                           cfg.bits)
        flat = index_mod.build_flat(codes, mask, codebook)
        ff = index_mod.build_float_flat(*pruned_embeddings(corpus, cfg))
        return RetrieverState(
            codebook=codebook,
            backend_state=CascadeState((ham, flat, ff), cfg.cascade.p1,
                                       cfg.cascade.p2),
            rerank_codes=codes_full,
            rerank_mask=corpus.mask.to(torch.bool))

    # -- search -------------------------------------------------------------

    def _views(self, state: RetrieverState):
        """(backend, member-view RetrieverState) per stage: the outer state
        with ``backend_state`` swapped for one member."""
        return [(get_backend(name), state._replace(backend_state=member))
                for name, member in zip(STAGES, state.backend_state.members)]

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        """Run the funnel. Stage outputs are global doc ids: on a
        monolithic state the members are built over the same corpus
        (doc_ids = arange), so ids double as positions for the next stage;
        on a segmented one they resolve through ``pos_of_id``."""
        s = state.backend_state
        (ham_b, ham_v), (flat_b, flat_v), (ff_b, ff_v) = self._views(state)
        with tracing.span("cascade.stage1"):
            _, ids1 = ham_b.search(ham_v, query, k=s.p1, scan=scan)
        with tracing.span("cascade.stage2"):
            _, ids2 = flat_b.search_candidates(flat_v, query, ids1, k=s.p2,
                                               scan=scan)
        with tracing.span("cascade.stage3"):
            return ff_b.search_candidates(ff_v, query, ids2, k=k, scan=scan)

    # -- graceful degradation (serving overload ladder) ---------------------

    def with_budgets(self, state: RetrieverState, p1: int,
                     p2: int) -> RetrieverState:
        """The same member tensors under other (p1, p2) stage budgets."""
        s = state.backend_state
        return state._replace(
            backend_state=CascadeState(s.members, int(p1), int(p2)))

    def degrade_rungs(self, state: RetrieverState, *, k: int,
                      max_levels: int = 3) -> Tuple:
        """Budget rungs below the configured (p1, p2), coarsest last.

        Each rung halves both budgets (floored at p1 >= 2k, p2 >= k so a
        degraded response still ranks a full top-k); the final ``None``
        rung is the Hamming-only floor (``search_prefilter``).
        """
        s = state.backend_state
        rungs: list = []
        p1, p2 = int(s.p1), int(s.p2)
        while len(rungs) < max(0, max_levels - 1):
            nxt = (max(p1 // 2, 2 * k), max(p2 // 2, k))
            if nxt == (p1, p2):
                break
            p1, p2 = nxt
            rungs.append(nxt)
        rungs.append(None)
        return tuple(rungs)

    def search_prefilter(self, state: RetrieverState, query: Query, *,
                         k: int, scan=None) -> Tuple[Tensor, Tensor]:
        """Degradation floor: answer from stage 1 alone (float32 scores,
        so every rung returns the same dtypes)."""
        ham_b, ham_v = self._views(state)[0]
        scores, ids = ham_b.search(ham_v, query, k=k, scan=scan)
        return scores.to(torch.float32), ids

    def search_degraded(self, state: RetrieverState, query: Query, *,
                        k: int, rung, scan=None) -> Tuple[Tensor, Tensor]:
        """Serve one degradation rung: a (p1, p2) pair from
        ``degrade_rungs``, or None for the Hamming-only floor."""
        if rung is None:
            return self.search_prefilter(state, query, k=k, scan=scan)
        return self.search(self.with_budgets(state, *rung), query, k=k,
                           scan=scan)

    # -- mutation (member-wise composition) ---------------------------------

    def _segmented(self, state: RetrieverState):
        # the flat member's SegmentedState stands in for segment accounting
        # (the members mutate in lockstep, so their structure agrees)
        flat_member = state.backend_state.members[1]
        if isinstance(flat_member, index_mod.SegmentedState):
            return flat_member
        return None

    def _recompose(self, state: RetrieverState, member_states
                   ) -> RetrieverState:
        """The outer state from mutated member views. The rerank leaves
        come from the flat member (float_flat writes placeholder rows that
        must not replace the shared full-code rerank corpus)."""
        s = state.backend_state
        donor = member_states[1]
        return state._replace(
            backend_state=CascadeState(
                tuple(ms.backend_state for ms in member_states), s.p1, s.p2),
            rerank_codes=donor.rerank_codes,
            rerank_mask=donor.rerank_mask)

    def to_segmented(self, state: RetrieverState, *,
                     id_cap=None) -> RetrieverState:
        if self._segmented(state) is not None:
            return state
        if id_cap is None:
            id_cap = index_mod.segment_capacity(index_mod.max_doc_id(
                (state.backend_state.members[1],)) + 1)
        return self._recompose(state, [
            backend.to_segmented(view, id_cap=id_cap)
            for backend, view in self._views(state)])

    def add(self, state: RetrieverState, delta: Corpus, cfg: HPCConfig, *,
            doc_ids=None) -> RetrieverState:
        n_new = int(delta.embeddings.shape[0])
        if n_new == 0:
            return state
        state = self.to_segmented(state)
        if doc_ids is None:
            # resolve fresh ids once so every member assigns identically
            max_id = self._segmented(state).max_doc_id()
            doc_ids = np.arange(max_id + 1, max_id + 1 + n_new,
                                dtype=np.int64)
        return self._recompose(state, [
            backend.add(view, delta, cfg, doc_ids=doc_ids)
            for backend, view in self._views(state)])

    def delete(self, state: RetrieverState, doc_ids) -> RetrieverState:
        state = self.to_segmented(state)
        return self._recompose(state, [
            backend.delete(view, doc_ids)
            for backend, view in self._views(state)])

    def compact(self, state: RetrieverState,
                cfg: HPCConfig) -> RetrieverState:
        state = self.to_segmented(state)
        return self._recompose(state, [
            backend.compact(view, cfg)
            for backend, view in self._views(state)])

    # -- accounting ---------------------------------------------------------

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        """Per-stage payloads (stage_* keys) + their sum as `payload`."""
        out: Dict[str, int] = {}
        total = 0
        for name, (backend, view) in zip(STAGES, self._views(state)):
            b = backend.storage_bytes(view)
            out[f"stage_{name}"] = b["payload"]
            total += b["payload"]
            if "codebook" in b:          # shared across stages: count once
                out.setdefault("codebook", b["codebook"])
        out["payload"] = total
        return out

    def shard_specs(self, state: RetrieverState):
        """Compose the members' spec trees (each member backend's own
        policy)."""
        s = state.backend_state
        member_specs = tuple(
            backend.shard_specs(view).backend_state
            for backend, view in self._views(state))
        return RetrieverState(
            codebook=(None, None),
            backend_state=CascadeState(member_specs, s.p1, s.p2),
            rerank_codes=("corpus", None),
            rerank_mask=("corpus", None))

    # -- persistence ------------------------------------------------------

    def abstract_state(self, *, n: int, md: int = 16, d: int = 16,
                       k: int = 256, device="meta", **knobs
                       ) -> RetrieverState:
        """The members' abstract states composed (shape-only)."""
        bits = knobs.get("bits", binary_mod.bits_for_k(k))
        p1, p2 = knobs.get("p1", 1024), knobs.get("p2", 64)
        segments = knobs.get("segments")
        extra = {}
        rows = n
        if segments is not None:
            rows = knobs.get("id_cap",
                             index_mod.segment_capacity(sum(segments)))
            extra = {"segments": segments, "id_cap": rows}
        members = tuple(
            get_backend(name).abstract_state(
                n=n, md=md, d=d, k=k, device=device,
                **({"bits": bits} if name == "hamming" else {}),
                **extra).backend_state
            for name in STAGES)
        cdt = code_dtype(k)
        return RetrieverState(abstract_tensor((k, d), torch.float32, device),
                              CascadeState(members, p1, p2),
                              abstract_tensor((rows, md), cdt, device),
                              abstract_tensor((rows, md), torch.bool, device))

    def _state_aux(self, state: RetrieverState):
        s = state.backend_state
        return (s.p1, s.p2, s.members[0].bits)

    def state_template(self, aux, n_segments: int = 0) -> RetrieverState:
        p1, p2, bits = aux
        member_aux = {"hamming": bits, "flat": None, "float_flat": None}
        members = tuple(
            get_backend(name).state_template(
                member_aux[name], n_segments=n_segments).backend_state
            for name in STAGES)
        return RetrieverState(None, CascadeState(members, p1, p2), None,
                              None)

    def build_stats(self, state: RetrieverState) -> Dict[str, float]:
        s = state.backend_state
        stats = {"p1": float(s.p1), "p2": float(s.p2)}
        seg = self._segmented(state)
        if seg is not None:
            stats.update(self._segment_stats(seg))
        for name, (backend, view) in zip(STAGES, self._views(state)):
            for key, val in backend.build_stats(view).items():
                stats[f"{name}_{key}"] = val
        return stats

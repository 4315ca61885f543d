"""The `IndexBackend` contract, its registry and the shared build stages.

The counterpart of ``repro.retrieval.base``. A backend owns one primary
search structure behind

    build(generator, corpus, cfg)          -> RetrieverState
    search(state, query, *, k, scan)       -> (scores (B, k), doc_ids (B, k))
    search_candidates(state, query, ids, *, k, scan)
    add(state, delta, cfg, *, doc_ids) / delete(state, ids) / compact(...)
    storage_bytes(state)                   -> {"payload": ..., ...}
    save(path, state) / load(path, *, device) -> RetrieverState

Codebook training and corpus quantization are shared here
(``fit_codebook``, ``encode_corpus``, and ``encode_delta`` for appended
documents). Random draws come from a ``torch.Generator`` on the corpus'
device. The mutation API keeps the segmented LSM store
(``core.index.SegmentedState``).

An index file is the reference's format, version 3: one ``.npz`` of
``leaf_NNNN`` arrays in the order ``jax.tree_util`` flattens the
reference's state (``convert.state_leaves``), beside ``backend``,
``format_version``, ``segments`` (a segmented state's segment count),
``aux`` (the backend's scalar knobs) and ``checksums`` (a crc32 per leaf).
Files of either package load in the other, and versions 1-3 are read.
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import index as index_mod
from repro_torch.core import pruning
from repro_torch.core import quantization as quant
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor

# On-disk npz manifest version (IndexBackend.save/load), the reference's:
#   1 — monolithic states, no version key (still loads)
#   2 — adds `format_version` + the `segments` count of segmented states
#   3 — crash-safe writes (tmp file + fsync + atomic rename) and a per-leaf
#       crc32 `checksums` array, verified on load (v1/v2 files carry none)
FORMAT_VERSION = 3

# seconds and bytes of the last save or load in this process: "seconds",
# "crc32_seconds" (the checksums' share of them) and "bytes" (the file)
last_io: Dict[str, float] = {}


def leaf_crc32(arr) -> int:
    """crc32 of an array's raw bytes (shape/dtype ride in the npz header)."""
    return zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF


def fsync_dir(dirname: str) -> None:
    """fsync a directory so a just-renamed file survives power loss.
    Best-effort: some filesystems refuse an fsync of a directory; the
    rename itself is still atomic there."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def code_dtype(k: int) -> torch.dtype:
    """Dtype of centroid-index codes for a K-entry codebook: uint8 for
    K <= 256, else uint16 (stored as such; widened to int32 before any
    arithmetic, since torch has few uint16 ops)."""
    return torch.uint8 if k <= 256 else torch.uint16


class Corpus(NamedTuple):
    """Doc-side inputs: (N, Md, D) embeddings, (N, Md) mask/salience."""
    embeddings: Tensor
    mask: Tensor
    salience: Tensor


class Query(NamedTuple):
    """Query-side inputs: (B, Mq, D) embeddings, (B, Mq) mask/salience."""
    embeddings: Tensor
    mask: Tensor
    salience: Tensor


class RetrieverState(NamedTuple):
    """Built index state: the backend structure plus the unpruned codes
    and mask the facade's rerank reads (indexed by global doc id)."""

    codebook: Tensor
    backend_state: Any
    rerank_codes: Tensor
    rerank_mask: Tensor


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, "IndexBackend"] = {}


def register_backend(name: str):
    """Class decorator: ``@register_backend("flat")`` installs a singleton."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def _ensure_builtin_backends() -> None:
    """Install the built-in backends (idempotent, import-cycle safe)."""
    from repro_torch.retrieval import (cascade, flat, float_flat,  # noqa: F401
                                       hamming, hnsw, ivf)


def get_backend(name: str) -> "IndexBackend":
    if name not in _REGISTRY:
        _ensure_builtin_backends()
    if name not in _REGISTRY:
        raise KeyError(f"unknown index backend {name!r}; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends() -> Tuple[str, ...]:
    _ensure_builtin_backends()
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Shared build stages
# ---------------------------------------------------------------------------

def kmeans_config(cfg: HPCConfig) -> quant.KMeansConfig:
    """The codebook-training config implied by an HPCConfig."""
    return quant.KMeansConfig(
        k=cfg.k, iters=cfg.kmeans_iters, seed_batch=cfg.kmeans_seed_batch,
        n_restarts=cfg.kmeans_restarts, minibatch=cfg.kmeans_minibatch)


def fit_codebook(gen: torch.Generator, corpus: Corpus,
                 cfg: HPCConfig, mesh=None) -> Tensor:
    """Train the K-Means codebook on valid patches only: invalid rows are
    replaced by resampled valid rows, so Lloyd sees real data. With a
    ``mesh``, training runs through the sharded k-means
    (``core.distributed``): points sharded over the corpus axes,
    per-cluster sums all-reduced, the seeds and algorithm of the
    single-host path."""
    d = corpus.embeddings.shape[-1]
    flat = corpus.embeddings.reshape(-1, d)
    flat_mask = corpus.mask.reshape(-1).to(torch.bool)
    valid_idx = torch.argsort((~flat_mask).to(torch.uint8), stable=True)
    n_valid = flat_mask.sum()
    pos = torch.arange(flat.shape[0], device=flat.device)
    gather_idx = torch.where(
        pos < n_valid, valid_idx,
        valid_idx[torch.remainder(pos, torch.clamp(n_valid, min=1))])
    train_x = flat[gather_idx]
    del gather_idx, valid_idx, pos
    if mesh is not None:
        from repro_torch.core import distributed as dist_core
        codebook, _ = dist_core.sharded_kmeans_fit(mesh, gen, train_x,
                                                   kmeans_config(cfg))
    else:
        codebook, _ = quant.kmeans_fit(gen, train_x, kmeans_config(cfg))
    return codebook


def encode_corpus(gen: torch.Generator, corpus: Corpus, cfg: HPCConfig,
                  mesh=None
                  ) -> Tuple[torch.Generator, Tensor, Tensor, Tensor, Tensor]:
    """Shared offline stages of the code-based backends: train the
    codebook, quantize the full corpus (the rerank rows) and prune the doc
    patches for the primary structure. With a ``mesh``, codebook training
    and corpus quantization run sharded over the mesh's corpus axes (the
    assignment through the ``kmeans_assign`` kernel on a card); the codes
    come back whole on every rank.

    Returns (generator, codebook, codes_full, codes, mask); the generator,
    advanced past the codebook's draws, is free for the backend's own
    structure.
    """
    codebook = fit_codebook(gen, corpus, cfg, mesh=mesh)
    if mesh is None:
        codes_full = quant.quantize(corpus.embeddings, codebook,
                                    code_dtype=code_dtype(cfg.k))  # (N, Md)
    else:
        from repro_torch.core import distributed as dist_core
        codes_full = dist_core.sharded_quantize(
            mesh, corpus.embeddings, codebook, code_dtype(cfg.k))  # (N, Md)
    if cfg.prune_side in ("doc", "both"):
        codes, _, mask, _ = pruning.prune_topp_codes(
            codes_full, corpus.salience, corpus.mask, p=cfg.p)
    else:
        codes, mask = codes_full, corpus.mask.to(torch.bool)
    return gen, codebook, codes_full, codes, mask


def encode_delta(codebook: Tensor, delta: Corpus, cfg: HPCConfig
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Encode a corpus delta against an EXISTING codebook (no refit).

    The online counterpart of ``encode_corpus``: quantizes the delta's
    patches with the codebook the index was built with (the
    ``kmeans_assign`` kernel on the card) and applies the same doc-side
    pruning, so an appended segment is scored on exactly the
    representation a build would give those docs. Returns (codes_full,
    codes, mask): the full codes feed the rerank rows, the pruned
    codes/mask the primary structure.
    """
    codes_full = quant.quantize(delta.embeddings, codebook,
                                code_dtype=code_dtype(codebook.shape[0]))
    if cfg.prune_side in ("doc", "both"):
        codes, _, mask, _ = pruning.prune_topp_codes(
            codes_full, delta.salience, delta.mask, p=cfg.p)
    else:
        codes, mask = codes_full, delta.mask.to(torch.bool)
    return codes_full, codes, mask


def state_map(fn: Callable, state: Any) -> Any:
    """``state`` (tensors inside named tuples, dataclasses and tuples, at
    any depth) with every tensor ``t`` replaced by ``fn(t)``; DTensors
    count as tensors."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, tuple):
        moved = [state_map(fn, x) for x in state]
        return type(state)(*moved) if hasattr(state, "_fields") else \
            tuple(moved)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: state_map(fn, getattr(state, f.name))
            for f in dataclasses.fields(state)})
    return state


def state_mesh(state: "RetrieverState"):
    """The mesh of a state that ``Retriever.shard`` placed (every tensor a
    DTensor), or None for a local state."""
    cb = state.codebook
    return cb.device_mesh if isinstance(cb, DTensor) else None


def abstract_tensor(shape, dtype: torch.dtype, device="meta") -> Tensor:
    """A tensor without data: meta, or fake under a ``FakeTensorMode``."""
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def abstract_layout(payload: Callable[[int], Any], n: int, knobs: dict,
                    live_shape: Callable[[int], tuple], device,
                    id_cap_of: Optional[Callable[[int], int]] = None):
    """A backend's abstract structure: ``payload(n)`` monolithic, or, with
    ``knobs["segments"]`` (capacities), a SegmentedState of
    ``payload(cap)`` per segment with bool live bits of ``live_shape(cap)``
    and an (id_cap,) int32 ``pos_of_id``. Returns (structure, rows of the
    rerank corpus: n, or id_cap when segmented)."""
    segments = knobs.get("segments")
    if segments is None:
        return payload(n), n
    id_cap = knobs.get("id_cap")
    if id_cap is None:
        id_cap = (id_cap_of or index_mod.segment_capacity)(sum(segments))
    seg = index_mod.SegmentedState(
        tuple(payload(c) for c in segments),
        tuple(abstract_tensor(live_shape(c), torch.bool, device)
              for c in segments),
        abstract_tensor((id_cap,), torch.int32, device))
    return seg, id_cap


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def walk_state(node, leaf: Callable, int_leaf: Callable):
    """Rebuild ``node`` with each tensor slot (a tensor or None) mapped by
    ``leaf`` and each named-tuple int by ``int_leaf``, in the reference's
    flatten order; dataclass ints (knobs) are kept."""
    if node is None or isinstance(node, torch.Tensor):
        return leaf(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(int_leaf(v) if _is_int(v)
                            else walk_state(v, leaf, int_leaf) for v in node))
    if isinstance(node, tuple):
        return tuple(walk_state(v, leaf, int_leaf) for v in node)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: walk_state(getattr(node, f.name), leaf, int_leaf)
            for f in dataclasses.fields(node)
            if not _is_int(getattr(node, f.name))})
    raise TypeError(f"not a state node: {type(node).__name__}")


def _host_ids(doc_ids) -> np.ndarray:
    """Doc ids from a tensor, an array or a sequence, as host int64."""
    if isinstance(doc_ids, torch.Tensor):
        doc_ids = doc_ids.cpu().numpy()
    return np.asarray(doc_ids, np.int64).reshape(-1)


# ---------------------------------------------------------------------------
# Backend base class
# ---------------------------------------------------------------------------

class IndexBackend:
    """Contract every index backend implements (see module docstring)."""

    name: str = "?"
    # True -> scores are exact late-interaction scores over raw embeddings;
    # the facade then skips the quantized rerank stage.
    exact_scores: bool = False

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig, mesh=None) -> RetrieverState:
        """Offline indexing; with a ``mesh`` the shared encode stages run
        sharded (``encode_corpus``)."""
        raise NotImplementedError

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        """Candidate search -> (scores (B, k), doc_ids (B, k)).

        Sentinel contract: with fewer than k valid documents (k > N) the
        tail rows carry doc id -1 and scores at or below NEG_INF;
        consumers ignore ``id < 0`` rows.
        """
        raise NotImplementedError

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        """Score only a (B, P) per-query pool of corpus positions (-1 =
        empty slot) -> (B, k) top-k under the same sentinel contract.
        ``candidate_ids=None`` is the whole corpus, i.e. ``search``."""
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        raise NotImplementedError(
            f"backend {self.name!r} does not support candidate-restricted "
            "search")

    # -- mutation (segmented LSM store) ---------------------------------------
    #
    # A built state starts monolithic; the first `add`/`delete` normalizes it
    # into a `SegmentedState` whose segment 0 wraps the existing structure
    # zero-copy. `add` appends one immutable pow2-capacity segment encoded
    # with the EXISTING codebook; `delete` flips live bits (tombstones are
    # honored by every search path through the valid-mask contract);
    # `compact` gathers the live docs back into a single segment. Rerank
    # rows are indexed by GLOBAL doc id throughout, so the facade's rerank
    # never changes. No mutation writes into a tensor of the state it was
    # given: a search still running on the old state is unaffected.

    def _segmented(self, state: RetrieverState
                   ) -> Optional[index_mod.SegmentedState]:
        """The state's SegmentedState, or None while still monolithic."""
        s = state.backend_state
        if isinstance(s, index_mod.SegmentedState):
            return s
        if self._is_wrapper(s) and isinstance(s.index,
                                              index_mod.SegmentedState):
            return s.index
        return None

    @staticmethod
    def _is_wrapper(s) -> bool:
        """A wrapper state with an ``index`` field (HammingState, IVFState,
        HNSWState)? Named tuple payloads have an ``index`` method, so
        require a dataclass."""
        return (dataclasses.is_dataclass(s)
                and not isinstance(s, index_mod.SegmentedState)
                and any(f.name == "index" for f in dataclasses.fields(s)))

    def _set_segmented(self, state: RetrieverState,
                       seg: index_mod.SegmentedState) -> RetrieverState:
        s = state.backend_state
        if self._is_wrapper(s):
            return state._replace(
                backend_state=dataclasses.replace(s, index=seg))
        return state._replace(backend_state=seg)

    def _wrap_segment(self, state: RetrieverState) -> Tuple[Any, Tensor]:
        """(payload, live) wrapping the monolithic structure zero-copy."""
        s = state.backend_state
        payload = s.index if self._is_wrapper(s) else s
        return payload, index_mod.seg_doc_ids(payload) >= 0

    def _grow_rerank(self, state: RetrieverState, id_cap: int
                     ) -> RetrieverState:
        if state.rerank_codes.shape[0] >= id_cap:
            return state
        return state._replace(
            rerank_codes=index_mod.pad_dim0(state.rerank_codes, id_cap, 0),
            rerank_mask=index_mod.pad_dim0(state.rerank_mask, id_cap, False))

    def to_segmented(self, state: RetrieverState, *,
                     id_cap: Optional[int] = None) -> RetrieverState:
        """Normalize a monolithic state into single-segment form (no-op if
        already segmented). Search results are identical either way:
        segment 0 IS the original structure."""
        if self._segmented(state) is not None:
            return state
        payload, live = self._wrap_segment(state)
        if id_cap is None:
            ids = index_mod.seg_doc_ids(payload)
            top = int(ids.max()) if ids.numel() else -1
            id_cap = index_mod.segment_capacity(top + 1)
        seg = index_mod.SegmentedState(
            (payload,), (live,),
            index_mod.rebuild_pos_of_id((payload,), (live,), id_cap))
        return self._grow_rerank(self._set_segmented(state, seg), id_cap)

    # per-backend append hooks ---------------------------------------------

    def _encode_delta(self, state: RetrieverState, delta: Corpus,
                      cfg: HPCConfig) -> Tuple[Tensor, Tensor, Tensor]:
        """(full_repr, payload_repr, payload_mask) for a delta."""
        return encode_delta(state.codebook, delta, cfg)

    def _delta_segment(self, state: RetrieverState,
                       seg: index_mod.SegmentedState, enc, delta: Corpus,
                       cfg: HPCConfig, doc_ids: Tensor) -> Tuple[Any, Tensor]:
        """(payload, live) for an append segment — backend-specific."""
        raise NotImplementedError(
            f"backend {self.name!r} does not support add()")

    def _append_segment(self, state: RetrieverState,
                        seg: index_mod.SegmentedState, enc, delta: Corpus,
                        cfg: HPCConfig, doc_ids: Tensor
                        ) -> index_mod.SegmentedState:
        """Default: one more immutable segment. ``hnsw`` overrides it to
        grow its one graph segment in place (incremental insert)."""
        payload, live = self._delta_segment(state, seg, enc, delta, cfg,
                                            doc_ids)
        return index_mod.SegmentedState(
            seg.segments + (payload,), seg.live + (live,), seg.pos_of_id)

    def _rerank_delta_rows(self, enc, delta: Corpus) -> Tuple[Tensor, Tensor]:
        """Rows written into the id-indexed rerank corpus for a delta."""
        return enc[0], delta.mask

    # public mutation API ---------------------------------------------------

    def add(self, state: RetrieverState, delta: Corpus, cfg: HPCConfig, *,
            doc_ids=None) -> RetrieverState:
        """Append (or upsert) documents without rebuilding. Returns the new
        state; ``state`` is unchanged (segments are immutable).

        doc_ids None assigns fresh ids past the largest ever used.
        Explicit ids may reuse existing ones: a live prior occurrence is
        tombstoned (upsert — the newest segment wins), a dead one stays
        dead. Duplicate ids within one delta are rejected. The delta must
        have the patch count (Md) and embedding dim of the build's corpus.
        """
        n_new = int(delta.embeddings.shape[0])
        if n_new == 0:
            return state
        state = self.to_segmented(state)
        seg = self._segmented(state)

        # resolve ids on the host
        max_assigned = seg.max_doc_id()
        if doc_ids is None:
            ids_np = np.arange(max_assigned + 1, max_assigned + 1 + n_new,
                               dtype=np.int64)
        else:
            ids_np = _host_ids(doc_ids)
            if ids_np.shape[0] != n_new:
                raise ValueError(
                    f"doc_ids has {ids_np.shape[0]} entries for a "
                    f"{n_new}-doc delta")
            if (ids_np < 0).any():
                raise ValueError("doc_ids must be non-negative")
            if np.unique(ids_np).size != n_new:
                raise ValueError(
                    "duplicate doc_ids within one add() delta; split the "
                    "delta so each id appears once (newest-wins upserts "
                    "need a segment boundary between occurrences)")
        dev = seg.pos_of_id.device
        ids_t = torch.from_numpy(ids_np).to(device=dev, dtype=torch.int32)

        # prior live occurrences of reused ids -> flattened positions now
        # (positions of existing rows are stable under append)
        pos_np = seg.pos_of_id.cpu().numpy()
        in_cap = ids_np < pos_np.shape[0]
        old_pos = np.where(in_cap, pos_np[np.minimum(
            ids_np, pos_np.shape[0] - 1)], -1)
        kill_pos = old_pos[old_pos >= 0]

        enc = self._encode_delta(state, delta, cfg)
        grown = self._append_segment(state, seg, enc, delta, cfg, ids_t)
        segments, lives = grown.segments, list(grown.live)
        if kill_pos.size:  # upsert: tombstone the prior occurrence
            off = 0
            for i, p in enumerate(segments):
                size = int(index_mod.seg_doc_ids(p).numel())
                sel = kill_pos[(kill_pos >= off) & (kill_pos < off + size)]
                if sel.size:
                    lv = lives[i].reshape(-1).clone()
                    lv[torch.from_numpy(sel - off).to(dev)] = False
                    lives[i] = lv.reshape(lives[i].shape)
                off += size

        id_cap = index_mod.segment_capacity(
            max(pos_np.shape[0], int(ids_np.max()) + 1))
        seg2 = index_mod.SegmentedState(
            segments, tuple(lives),
            index_mod.rebuild_pos_of_id(segments, tuple(lives), id_cap))
        state = self._grow_rerank(self._set_segmented(state, seg2), id_cap)
        rc_rows, rm_rows = self._rerank_delta_rows(enc, delta)
        idx = (ids_t.to(torch.int64),)
        rc = state.rerank_codes
        return state._replace(
            rerank_codes=index_mod.indexable(rc).index_put(
                idx, index_mod.indexable(rc_rows.to(rc.dtype))).view(
                    rc.dtype),
            rerank_mask=state.rerank_mask.index_put(
                idx, rm_rows.to(state.rerank_mask.dtype)))

    def delete(self, state: RetrieverState, doc_ids) -> RetrieverState:
        """Tombstone documents by global id: O(total slots) work, no
        change to the stored payload; searches mask the docs out through
        the valid-mask contract (scores NEG_INF, ids -1). Unknown or
        already-dead ids are a no-op."""
        state = self.to_segmented(state)
        seg = self._segmented(state)
        kill = np.unique(_host_ids(doc_ids))
        kill = torch.from_numpy(kill[kill >= 0]).to(seg.pos_of_id.device)
        new_live, changed = [], False
        for payload, lv in zip(seg.segments, seg.live):
            hit = torch.isin(index_mod.seg_doc_ids(payload), kill) & lv
            if bool(hit.any()):
                changed = True
                new_live.append(lv & ~hit)
            else:
                new_live.append(lv)
        if not changed:
            return state
        seg2 = index_mod.SegmentedState(
            seg.segments, tuple(new_live),
            index_mod.rebuild_pos_of_id(seg.segments, tuple(new_live),
                                        seg.pos_of_id.shape[0]))
        return self._set_segmented(state, seg2)

    def _compact_payload(self, state: RetrieverState,
                         seg: index_mod.SegmentedState, cfg: HPCConfig
                         ) -> Tuple[Any, Tensor]:
        """(payload, live) holding exactly the live docs — per backend."""
        raise NotImplementedError(
            f"backend {self.name!r} does not support compact()")

    def compact(self, state: RetrieverState, cfg: HPCConfig
                ) -> RetrieverState:
        """Physically drop tombstones: gather the live docs into a single
        fresh segment, in slot order. Doc ids and the id-indexed rerank
        rows are kept, so search results over the live corpus are
        unchanged."""
        state = self.to_segmented(state)
        seg = self._segmented(state)
        payload, live = self._compact_payload(state, seg, cfg)
        seg2 = index_mod.SegmentedState(
            (payload,), (live,),
            index_mod.rebuild_pos_of_id((payload,), (live,),
                                        seg.pos_of_id.shape[0]))
        return self._set_segmented(state, seg2)

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        """Measured storage of the built index (paper Table III)."""
        raise NotImplementedError

    # -- segmented accounting helpers -----------------------------------------

    def _seg_payload_bytes(self, payload, n_live: int) -> int:
        """Payload bytes attributable to ``n_live`` live docs of a
        segment."""
        raise NotImplementedError

    def _segmented_storage(self, state: RetrieverState,
                           seg: index_mod.SegmentedState) -> Dict[str, int]:
        """Live-docs-only payload accounting + a per-segment breakdown:
        tombstoned docs stop counting when they are deleted (their bytes
        are freed at compact)."""
        out: Dict[str, int] = {}
        total = 0
        for i, (payload, lv) in enumerate(zip(seg.segments, seg.live)):
            ids = index_mod.seg_doc_ids(payload).reshape(-1)
            n_live = int((lv.reshape(-1) & (ids >= 0)).sum())
            b = self._seg_payload_bytes(payload, n_live)
            out[f"segment_{i}_payload"] = b
            total += b
        out["payload"] = total
        cb = state.codebook
        out["codebook"] = cb.numel() * cb.element_size()
        return out

    def _segment_stats(self, seg: index_mod.SegmentedState
                       ) -> Dict[str, float]:
        live, tomb = seg.counts()
        return {"segments": float(seg.n_segments),
                "live_docs": float(live),
                "tombstoned_docs": float(tomb),
                "tombstone_frac": tomb / max(live + tomb, 1)}

    def build_stats(self, state: RetrieverState) -> Dict[str, float]:
        """Structure-quality stats of a built index: {} for a monolithic
        state (the exhaustive scans have nothing to report), the segment
        lifecycle counters (segments / live_docs / tombstoned_docs /
        tombstone_frac) for a segmented one."""
        seg = self._segmented(state)
        return self._segment_stats(seg) if seg is not None else {}

    # -- static analysis ------------------------------------------------------

    def abstract_state(self, *, n: int, md: int = 16, d: int = 16,
                       k: int = 256, device="meta", **knobs
                       ) -> RetrieverState:
        """Shape-only ``RetrieverState`` at corpus size ``n``: no data.

        The static-analysis registration hook (``repro_torch.analysis.
        manifests``), the counterpart of the reference's: every leaf has
        the reference's shape with the port's storage dtype (uint8 codes,
        uint16 for K > 256 and for Hamming codes, bool masks), as meta
        tensors on ``device="meta"``, or as FakeTensors when called under
        an active ``FakeTensorMode`` with the fake tensors' device.
        ``knobs`` carries the backend's structure (ivf: n_list/n_probe/
        bucket_cap, hnsw: levels/m/ef_search, hamming: bits, cascade:
        p1/p2; every backend: ``segments``, a tuple of segment capacities,
        and ``id_cap``) so the traced program matches a real build.
        """
        raise NotImplementedError(
            f"backend {self.name!r} must define abstract_state to register "
            "with the budget analyzer (repro_torch.analysis.manifests)")

    # -- sharding -------------------------------------------------------------

    def shard_specs(self, state: RetrieverState):
        """Logical-axis spec tree matching ``state`` (the same structure,
        a spec tuple where a tensor sits).

        Default: dim 0 of every backend-state tensor over the "corpus"
        logical axis (documents or buckets over the mesh), the codebook
        replicated, the rerank rows over "corpus" too. Backends with
        other leading dims override this. A segmented state shards each
        segment's dim 0 on its own; the id->position map replicates, so
        every shard resolves global ids locally.
        """
        def leaf_spec(leaf):
            nd = leaf.dim()
            return ("corpus",) + (None,) * (nd - 1) if nd else ()

        backend_specs = walk_state(state.backend_state, leaf_spec,
                                   lambda _: ())
        if self._segmented(state) is not None:
            def fix(sp):
                return dataclasses.replace(sp, pos_of_id=(None,))
            backend_specs = (
                dataclasses.replace(backend_specs, index=fix(
                    backend_specs.index))
                if self._is_wrapper(backend_specs) else fix(backend_specs))
        return RetrieverState(
            codebook=(None, None),
            backend_state=backend_specs,
            rerank_codes=("corpus", None),
            rerank_mask=("corpus", None))

    # -- persistence ----------------------------------------------------------
    #
    # The treedef is never stored: it is rebuilt from `state_template`, so
    # loading a file deserializes arrays only (no pickle, no code).

    def _state_aux(self, state: RetrieverState):
        """The scalar knobs the backend state carries (None if none)."""
        return None

    def state_template(self, aux, n_segments: int = 0) -> RetrieverState:
        """A skeleton of this backend's state for ``convert``'s leaf
        walk: ``None`` where a tensor leaf goes, ``0`` where a named-tuple
        field holds a Python int that the reference keeps as a 0-d int32
        leaf (``HammingIndex.bits``, ``HNSWIndex.entry``), and the knobs
        (``aux``) in the wrapper dataclasses. ``n_segments`` 0 is the
        monolithic layout, > 0 a SegmentedState of that many segments."""
        raise NotImplementedError(
            f"backend {self.name!r} must define state_template for "
            "persistence")

    def _n_segments(self, state: RetrieverState) -> int:
        seg = self._segmented(state)
        return seg.n_segments if seg is not None else 0

    def save(self, path: str, state: RetrieverState) -> str:
        """Write ``state`` to ``path`` (``.npz`` appended if missing) in
        format v3: to ``path + ".tmp"``, fsynced, renamed over ``path``,
        then the directory fsynced, so a crash leaves the previous complete
        file or a stray ``.tmp``, never a torn index. Returns the path."""
        from repro_torch import convert
        t0 = time.perf_counter()
        aux = self._state_aux(state)
        n_seg = self._n_segments(state)
        leaves = convert.state_leaves(state)
        want = convert.n_leaves(self.state_template(aux, n_seg))
        if len(leaves) != want:
            raise ValueError(
                f"backend {self.name!r}: the state has {len(leaves)} leaves, "
                f"its template {want}")
        payload = {f"leaf_{i:04d}": leaf for i, leaf in enumerate(leaves)}
        payload["backend"] = np.array(self.name)
        payload["format_version"] = np.asarray(FORMAT_VERSION, np.int64)
        if n_seg:
            payload["segments"] = np.asarray(n_seg, np.int64)
        if aux is not None:
            payload["aux"] = np.asarray(aux, np.int64)
        t1 = time.perf_counter()
        payload["checksums"] = np.asarray(
            [leaf_crc32(leaf) for leaf in leaves], np.uint32)
        crc_s = time.perf_counter() - t1
        if not path.endswith(".npz"):
            path = path + ".npz"
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(os.path.dirname(path))
        last_io.update(seconds=time.perf_counter() - t0, crc32_seconds=crc_s,
                       bytes=os.path.getsize(path))
        return path

    def load(self, path: str, *, device="cuda") -> RetrieverState:
        """Read an index file of format v1-v3 written by either package
        onto ``device``. Rejects a file without ``backend``, another
        backend's file and a future version; every leaf's crc32 is checked
        before any tensor is made, and a mismatch names the array."""
        from repro_torch import convert
        from repro_torch.device import resolve_device
        dev = resolve_device(device)
        t0 = time.perf_counter()
        if not path.endswith(".npz"):
            path = path + ".npz"
        crc_s = 0.0
        with np.load(path, allow_pickle=False) as z:
            if "backend" not in z.files:
                raise ValueError(
                    f"{path!r} is not a retriever index file (no 'backend' "
                    "key); it may predate the v1 retriever format — rebuild "
                    "the index with this version")
            saved = str(z["backend"])
            if saved != self.name:
                raise ValueError(
                    f"index was saved by backend {saved!r}, not {self.name!r}")
            version = (int(z["format_version"])
                       if "format_version" in z.files else 1)
            if version > FORMAT_VERSION:
                raise ValueError(
                    f"index file {path!r} has format version {version}; "
                    f"this build reads versions <= {FORMAT_VERSION} — "
                    "upgrade to load it, or re-save with this version")
            n_seg = int(z["segments"]) if "segments" in z.files else 0
            if "aux" in z.files:
                a = z["aux"]
                aux = int(a) if a.ndim == 0 else tuple(int(x) for x in a)
            else:
                aux = None
            names = sorted(n for n in z.files if n.startswith("leaf_"))
            host_leaves = [z[n] for n in names]
            if "checksums" in z.files:
                crcs = np.asarray(z["checksums"], np.uint32)
                if crcs.size != len(names):
                    raise ValueError(
                        f"index file {path!r} carries {crcs.size} checksums "
                        f"for {len(names)} arrays — truncated manifest")
                t1 = time.perf_counter()
                for name, arr, want in zip(names, host_leaves, crcs):
                    got = leaf_crc32(arr)
                    if got != int(want):
                        raise ValueError(
                            f"index file {path!r}: checksum mismatch on "
                            f"array {name!r} (crc32 {got:#010x} != stored "
                            f"{int(want):#010x}) — the file is corrupt; "
                            "restore from a previous complete save")
                crc_s = time.perf_counter() - t1
        template = self.state_template(aux, n_seg)
        if convert.n_leaves(template) != len(host_leaves):
            raise ValueError(
                f"index file has {len(host_leaves)} arrays, backend "
                f"{self.name!r} expects {convert.n_leaves(template)}")
        state = convert.state_from_leaves(template, host_leaves, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        last_io.update(seconds=time.perf_counter() - t0, crc32_seconds=crc_s,
                       bytes=os.path.getsize(path))
        return state

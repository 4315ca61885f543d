"""Exhaustive indexes over a patch corpus, in PyTorch.

The counterpart of the flat, float-flat and Hamming parts of
``repro.core.index``, monolithic and segmented. Each is an exhaustive scan
streamed through core/scan.py, plus a candidate search that scores a
(B, P) pool of documents through the scan's per-query layout:

  * FlatIndex      — fused ADC scan over the (pruned) quantized codes;
  * FloatFlatIndex — float MaxSim over raw embeddings (ColPali-Full);
  * HammingIndex   — popcount MaxSim over b-bit codes;
  * IVFIndex       — centroid routing: documents bucket by the routing
                     cluster of their mean decoded patch; a query scores the
                     n_list centroids and scans only its n_probe nearest
                     buckets, padded-dense, through the per-query layout.

The second half of the module is the segmented LSM store
(``SegmentedState``): live add/delete/compact without a rebuild.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import quantization as quant
from repro_torch.core import scan as scan_mod
from repro_torch.kernels import ops as kernel_ops

Tensor = torch.Tensor

# documents decoded at once by doc_mean_vectors: bounds the (chunk, Md, D)
# float32 decode (16384 x 615 x 128 would be 5.2 GB in one piece)
MEAN_CHUNK_DOCS = 1024


# ---------------------------------------------------------------------------
# Routing vectors (shared by IVF and HNSW)
# ---------------------------------------------------------------------------

def mean_pool(emb: Tensor, mask: Tensor) -> Tensor:
    """Masked mean over the patch axis: (..., M, D), (..., M) -> (..., D)."""
    m = mask[..., None].to(emb.dtype)
    return (emb * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)


def doc_mean_vectors(codes: Tensor, mask: Tensor, codebook: Tensor) -> Tensor:
    """Document routing vectors: the mean of each document's decoded
    patches, (N, Md) codes -> (N, D) float32. Decoded ``MEAN_CHUNK_DOCS``
    documents at a time; each document's mean is the same whatever the
    chunk."""
    out = torch.empty((codes.shape[0], codebook.shape[-1]),
                      dtype=codebook.dtype, device=codebook.device)
    for lo in range(0, codes.shape[0], MEAN_CHUNK_DOCS):
        hi = lo + MEAN_CHUNK_DOCS
        out[lo:hi] = mean_pool(quant.decode(codes[lo:hi], codebook),
                               mask[lo:hi])
    return out


def indexable(t: Tensor) -> Tensor:
    """``t``, or for uint16 its int16 view (the same bytes): CUDA's
    gather, scatter and select kernels have no uint16 instance."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def take_rows(t: Tensor, idx) -> Tensor:
    """``t[idx]`` for any dtype, uint16 included."""
    return indexable(t)[idx].view(t.dtype)


def route_assign(doc_vec: Tensor, centroids: Tensor) -> Tensor:
    """Each routing vector's nearest centroid (N,) int64, through the
    ``kmeans_assign`` kernel on the card (its ``||c||^2 - 2 x.c`` form:
    the same centroid as the reference's full distance outside near-ties,
    as for the corpus codes)."""
    return kernel_ops.kmeans_assign(doc_vec, centroids).to(torch.int64)


class FlatIndex(NamedTuple):
    codes: Tensor       # (N, Md) uint8/uint16 centroid indices
    mask: Tensor        # (N, Md) bool
    codebook: Tensor    # (K, D) float32
    doc_ids: Tensor     # (N,) int32 global ids


def build_flat(codes: Tensor, mask: Tensor, codebook: Tensor,
               doc_ids: Optional[Tensor] = None) -> FlatIndex:
    if doc_ids is None:
        doc_ids = torch.arange(codes.shape[0], dtype=torch.int32,
                               device=codes.device)
    return FlatIndex(codes, mask, codebook, doc_ids)


def search_flat(index: FlatIndex, q: Tensor, q_mask: Tensor, *, k: int,
                scan: Optional[scan_mod.ScanConfig] = None
                ) -> Tuple[Tensor, Tensor]:
    """Exhaustive ADC MaxSim scan -> (scores (B, k), doc_ids (B, k)); rows
    beyond N (k > N) carry id -1 and the -inf sentinel."""
    return scan_mod.quantized_maxsim_topk(
        q, q_mask, index.codes, index.mask, index.codebook, k=k,
        doc_ids=index.doc_ids, scan=scan)


def _clamp_positions(candidate_ids: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """(valid (B, P), positions clamped to [0, n - 1] (B, P) int64): -1
    marks an empty slot; a position >= n reads doc n - 1, as the
    reference's clamped gather does."""
    valid = candidate_ids >= 0
    return valid, torch.clamp(candidate_ids, 0, n - 1).to(torch.int64)


def _gather_candidates(candidate_ids: Tensor, doc_ids: Tensor,
                       *leaves: Tensor) -> Tuple[Tensor, Tensor, Tuple[Tensor, ...]]:
    """Gather per-query candidate rows (B, P) of corpus *positions* (-1 =
    empty slot) -> (global ids (B, P), valid (B, P), leaves (B, P, ...))."""
    valid, safe = _clamp_positions(candidate_ids, doc_ids.shape[0])
    ids = torch.where(valid, doc_ids[safe], -1).to(torch.int32)
    return ids, valid, tuple(take_rows(leaf, safe) for leaf in leaves)


def search_flat_candidates(index: FlatIndex, q: Tensor, q_mask: Tensor,
                           candidate_ids: Tensor, *, k: int,
                           scan: Optional[scan_mod.ScanConfig] = None
                           ) -> Tuple[Tensor, Tensor]:
    """ADC MaxSim over a (B, P) candidate pool, through the scan's
    per-query layout; -1 slots and k > P rows carry the sentinel."""
    ids, valid, (codes, mask) = _gather_candidates(
        candidate_ids, index.doc_ids, index.codes, index.mask)
    return scan_mod.quantized_maxsim_topk(
        q, q_mask, codes, mask, index.codebook, k=k,
        doc_ids=ids, valid=valid, scan=scan)


class FloatFlatIndex(NamedTuple):
    """Uncompressed baseline (ColPali-Full)."""
    embeddings: Tensor  # (N, Md, D) float32
    mask: Tensor        # (N, Md) bool
    doc_ids: Tensor     # (N,) int32


def build_float_flat(embeddings: Tensor, mask: Tensor,
                     doc_ids: Optional[Tensor] = None) -> FloatFlatIndex:
    if doc_ids is None:
        doc_ids = torch.arange(embeddings.shape[0], dtype=torch.int32,
                               device=embeddings.device)
    return FloatFlatIndex(embeddings, mask, doc_ids)


def search_float_flat(index: FloatFlatIndex, q: Tensor, q_mask: Tensor, *,
                      k: int, scan: Optional[scan_mod.ScanConfig] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Exhaustive float MaxSim scan, streamed (see search_flat)."""
    return scan_mod.maxsim_topk(q, q_mask, index.embeddings, index.mask,
                                k=k, doc_ids=index.doc_ids, scan=scan)


def search_float_flat_candidates(index: FloatFlatIndex, q: Tensor,
                                 q_mask: Tensor, candidate_ids: Tensor, *,
                                 k: int,
                                 scan: Optional[scan_mod.ScanConfig] = None
                                 ) -> Tuple[Tensor, Tensor]:
    """Float MaxSim over a (B, P) candidate pool: the cascade's rerank.
    The positions go to the scan as ``rows``, so the kernel reads each
    candidate's embeddings through its id and the pool's (B, P, Md, D)
    embeddings are never copied; only the ids are mapped here. The rows
    are the clamped positions (-1 where the slot is empty), so no row
    past the corpus reaches the kernel."""
    valid, safe = _clamp_positions(candidate_ids, index.doc_ids.shape[0])
    ids = torch.where(valid, index.doc_ids[safe], -1).to(torch.int32)
    rows = torch.where(valid, safe, -1).to(torch.int32)
    return scan_mod.maxsim_topk(q, q_mask, index.embeddings, index.mask, k=k,
                                doc_ids=ids, valid=valid, scan=scan,
                                rows=rows)


# ---------------------------------------------------------------------------
# IVF index: centroid routing over padded-dense buckets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IVFConfig:
    n_list: int = 64       # routing clusters
    n_probe: int = 8       # clusters scanned per query
    bucket_cap: int = 0    # max docs per bucket (0 = 2x the mean load)
    iters: int = 15        # routing k-means iterations
    restarts: int = 2      # routing k-means restarts
    max_drop_rate: float = 0.01  # the build fails above this overflow
                                 # drop fraction (IVFBackend.build checks)


class IVFIndex(NamedTuple):
    routing_centroids: Tensor  # (n_list, D) float32
    bucket_codes: Tensor       # (n_list, cap, Md) uint8/uint16
    bucket_mask: Tensor        # (n_list, cap, Md) bool, patch validity
    bucket_valid: Tensor       # (n_list, cap) bool, slot occupied
    bucket_doc_ids: Tensor     # (n_list, cap) int32
    codebook: Tensor           # (K, D)


def build_ivf(gen: torch.Generator, codes: Tensor, mask: Tensor,
              codebook: Tensor, config: IVFConfig,
              doc_ids: Optional[Tensor] = None) -> IVFIndex:
    """Bucket documents by the routing cluster of their mean decoded
    patch. The routing centroids are a k-means fit of those vectors (draws
    from ``gen``); the assignment runs the ``kmeans_assign`` kernel on the
    card. Buckets are padded-dense (n_list, cap, ...), cap defaulting to
    twice the mean load; documents past a bucket's cap are dropped and
    counted by ``ivf_drop_rate`` (``IVFBackend.build`` enforces
    ``config.max_drop_rate``)."""
    n = codes.shape[0]
    if doc_ids is None:
        doc_ids = torch.arange(n, dtype=torch.int32, device=codes.device)
    doc_vec = doc_mean_vectors(codes, mask, codebook)
    cents, _ = quant.kmeans_fit(gen, doc_vec, quant.KMeansConfig(
        k=config.n_list, iters=config.iters, n_restarts=config.restarts))
    assign_ = route_assign(doc_vec, cents)
    cap = config.bucket_cap
    if cap == 0:
        cap = int(max(8, 2 * -(-n // config.n_list)))
    return IVFIndex(cents, *_bucket_scatter(codes, mask, doc_ids, assign_,
                                            config.n_list, cap), codebook)


def _bucket_scatter(codes: Tensor, mask: Tensor, doc_ids: Tensor,
                    assign_: Tensor, n_list: int, cap: int
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Scatter documents into padded (n_list, cap, ...) buckets, in
    document order within a bucket (a stable sort by cluster). A document
    ranked at or past ``cap`` in its bucket is dropped: its writes go to a
    spare row past the buckets, which is cut off, so it never overwrites
    a document kept there."""
    n, md = codes.shape
    dev = codes.device
    order = torch.argsort(assign_, stable=True)
    sorted_cluster = assign_[order]
    counts = torch.bincount(assign_, minlength=n_list)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sorted_cluster]
    slot = torch.where(rank < cap, sorted_cluster * cap + rank,
                       n_list * cap)                 # the spare row
    rows = n_list * cap + 1
    b_codes = torch.zeros((rows, md), dtype=codes.dtype, device=dev)
    b_mask = torch.zeros((rows, md), dtype=torch.bool, device=dev)
    b_valid = torch.zeros((rows,), dtype=torch.bool, device=dev)
    b_ids = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    indexable(b_codes)[slot] = indexable(take_rows(codes, order))
    b_mask[slot] = mask[order].to(torch.bool)
    b_valid[slot] = True
    b_ids[slot] = doc_ids[order].to(torch.int32)
    keep = n_list * cap
    return (b_codes[:keep].reshape(n_list, cap, md),
            b_mask[:keep].reshape(n_list, cap, md),
            b_valid[:keep].reshape(n_list, cap),
            b_ids[:keep].reshape(n_list, cap))


def ivf_drop_rate(index: IVFIndex, n_docs: int) -> float:
    """Fraction of docs dropped by bucket overflow (should be ~0)."""
    stored = int(index.bucket_valid.sum())
    return 1.0 - stored / max(n_docs, 1)


def _probe(centroids: Tensor, q: Tensor, q_mask: Tensor,
           n_probe: int) -> Tensor:
    """The n_probe buckets nearest each query's mean patch (B, n_probe),
    by negative squared L2 (``2 q.c - ||c||^2``, the metric the build
    bucketed by), ties to the lower bucket as ``lax.top_k`` ranks them.
    ``n_probe`` is clamped to n_list."""
    q_vec = mean_pool(q.to(centroids.dtype), q_mask)
    route = (2.0 * (q_vec @ centroids.t())
             - (centroids ** 2).sum(dim=-1)[None, :])
    n_probe = min(int(n_probe), centroids.shape[0])
    order = torch.sort(route, dim=1, descending=True, stable=True)[1]
    return order[:, :n_probe]


def _probed_pool(payload: IVFIndex, valid: Tensor, probe: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The probed buckets' (codes, mask, valid, ids) as one per-query
    pool (B, n_probe * cap, ...)."""
    b = probe.shape[0]
    cap, md = payload.bucket_codes.shape[1:]
    p = probe.shape[1] * cap
    return (take_rows(payload.bucket_codes, probe).reshape(b, p, md),
            payload.bucket_mask[probe].reshape(b, p, md),
            valid[probe].reshape(b, p),
            payload.bucket_doc_ids[probe].reshape(b, p))


def search_ivf(index: IVFIndex, q: Tensor, q_mask: Tensor, *, n_probe: int,
               k: int, scan: Optional[scan_mod.ScanConfig] = None
               ) -> Tuple[Tensor, Tensor]:
    """Route to n_probe buckets and score their pool through the scan's
    per-query layout (one ``quantized_maxsim`` launch on the card) ->
    (scores (B, k), doc_ids (B, k)). With fewer than k valid documents in
    the probed buckets, the tail rows carry id -1 and the sentinel."""
    probe = _probe(index.routing_centroids, q, q_mask, n_probe)
    codes, mask, valid, ids = _probed_pool(index, index.bucket_valid, probe)
    return scan_mod.quantized_maxsim_topk(
        q, q_mask, codes, mask, index.codebook, k=k, doc_ids=ids,
        valid=valid, scan=scan)


class HammingIndex(NamedTuple):
    codes: Tensor     # (N, Md) uint16 b-bit codes
    mask: Tensor      # (N, Md) bool
    doc_ids: Tensor   # (N,) int32
    bits: int         # b = ceil(log2 K)


def build_hamming(codes: Tensor, mask: Tensor, bits: int,
                  doc_ids: Optional[Tensor] = None) -> HammingIndex:
    if doc_ids is None:
        doc_ids = torch.arange(codes.shape[0], dtype=torch.int32,
                               device=codes.device)
    return HammingIndex(codes.to(torch.uint16), mask, doc_ids, int(bits))


def search_hamming(index: HammingIndex, q_codes: Tensor, q_mask: Tensor, *,
                   bits: int, k: int,
                   scan: Optional[scan_mod.ScanConfig] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Popcount MaxSim scan, streamed (see search_flat); int32 scores."""
    return scan_mod.hamming_maxsim_topk(
        q_codes, q_mask, index.codes, index.mask, bits=bits, k=k,
        doc_ids=index.doc_ids, scan=scan)


def search_hamming_candidates(index: HammingIndex, q_codes: Tensor,
                              q_mask: Tensor, candidate_ids: Tensor, *,
                              bits: int, k: int,
                              scan: Optional[scan_mod.ScanConfig] = None
                              ) -> Tuple[Tensor, Tensor]:
    """Popcount MaxSim over a (B, P) candidate pool (per-query layout)."""
    ids, valid, (codes, mask) = _gather_candidates(
        candidate_ids, index.doc_ids, index.codes, index.mask)
    return scan_mod.hamming_maxsim_topk(
        q_codes, q_mask, codes, mask, bits=bits, k=k, doc_ids=ids,
        valid=valid, scan=scan)




# ---------------------------------------------------------------------------
# Segmented LSM corpus store (live add/delete/update)
# ---------------------------------------------------------------------------
#
# A mutable index is an ordered list of immutable *segments* plus live bits.
# Segment 0 is the original build (wrapped as-is, zero copy); every `add`
# appends one pow2-capacity-padded segment built with the EXISTING codebook
# (no refit); `delete` flips live bits (a tombstoned doc scores exactly
# NEG_INF, or the int32 minimum for Hamming, with id -1, through the scan's
# valid-mask contract); `compact` gathers the live docs into one fresh
# segment. A full search sweeps the segment list threading the scan's
# (B, k) merge buffer across segments (`carry=`), which ranks the carried
# (earlier) documents ahead of equal scores, so it equals one sweep over the
# concatenated corpus. No search function here syncs with the device.

SEG_MIN_CAP = 8  # smallest append-segment capacity (pow2 shape bucketing)


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def segment_capacity(n: int) -> int:
    """Capacity bucket for an n-doc segment: next pow2, floor SEG_MIN_CAP.

    Pow2 bucketing bounds the set of distinct segment shapes at O(log N)
    across any mutation history (serving/live.py records it)."""
    return max(SEG_MIN_CAP, next_pow2(int(n)))


@dataclasses.dataclass
class SegmentedState:
    """Ordered immutable segments + per-slot live bits + id->position map.

    segments: tuple of per-backend payloads (FlatIndex / FloatFlatIndex /
        HammingIndex), each carrying its own doc_ids; padding slots hold
        doc_id -1.
    live: one bool tensor per segment, shaped like its doc-id tensor.
        False = padding or tombstoned; a slot with doc_id >= 0 and live
        False is a tombstone.
    pos_of_id: (id_cap,) int32 — the flattened slot position (row-major
        across the segment list) of each doc id's unique live occurrence,
        -1 if the id is dead or unassigned. Every id has at most one live
        slot (an upsert tombstones the older occurrence), which is how the
        candidate stages (cascade) resolve global ids to rows.
    """

    segments: Tuple[Any, ...]
    live: Tuple[Tensor, ...]
    pos_of_id: Tensor

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    def max_doc_id(self) -> int:
        """The largest doc id any slot ever held, -1 if none — syncs."""
        return max((int(seg_doc_ids(p).max()) for p in self.segments
                    if seg_doc_ids(p).numel()), default=-1)

    def counts(self) -> Tuple[int, int]:
        """(live_docs, tombstoned_docs) — syncs with the device."""
        live = tomb = 0
        for payload, lv in zip(self.segments, self.live):
            filled = seg_doc_ids(payload).reshape(-1) >= 0
            lvf = lv.reshape(-1)
            live += int((filled & lvf).sum())
            tomb += int((filled & ~lvf).sum())
        return live, tomb


def segmented_template(payload, n_segments: int):
    """``payload`` (a state skeleton, see ``IndexBackend.state_template``)
    as is when ``n_segments`` is 0, else a SegmentedState skeleton of
    ``n_segments`` such payloads."""
    if not n_segments:
        return payload
    return SegmentedState((payload,) * n_segments, (None,) * n_segments,
                          None)


def seg_doc_ids(payload) -> Tensor:
    """The doc-id tensor of one segment payload ((n_list, cap) for IVF)."""
    if isinstance(payload, IVFIndex):
        return payload.bucket_doc_ids
    return payload.doc_ids


def rebuild_pos_of_id(segments: Tuple, live: Tuple, id_cap: int) -> Tensor:
    """Recompute the id->flattened-position map from the segment list, on
    the segments' device (a mutation: it syncs). Correct because each id
    has at most one live slot."""
    dev = seg_doc_ids(segments[0]).device if segments else None
    pos = torch.full((int(id_cap),), -1, dtype=torch.int32, device=dev)
    off = 0
    for payload, lv in zip(segments, live):
        ids = seg_doc_ids(payload).reshape(-1).to(torch.int64)
        occ = torch.nonzero(lv.reshape(-1) & (ids >= 0)).squeeze(1)
        pos[ids[occ]] = (off + occ).to(torch.int32)
        off += ids.numel()
    return pos


# -- segment construction ---------------------------------------------------

def pad_dim0(arr: Tensor, cap: int, fill=0) -> Tensor:
    """Pad dim 0 to ``cap`` rows with ``fill`` (no-op when already there)."""
    n = arr.shape[0]
    if n == cap:
        return arr
    pad = torch.full((cap - n,) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=0)


def _live_prefix(n: int, cap: int, device) -> Tensor:
    return torch.arange(cap, device=device) < n


def make_flat_segment(codes: Tensor, mask: Tensor, codebook: Tensor,
                      doc_ids: Tensor, cap: Optional[int] = None
                      ) -> Tuple[FlatIndex, Tensor]:
    """(FlatIndex, live) for an n-doc append, padded to a pow2 capacity."""
    n = codes.shape[0]
    cap = segment_capacity(n) if cap is None else cap
    ix = FlatIndex(pad_dim0(codes, cap), pad_dim0(mask, cap, False),
                   codebook, pad_dim0(doc_ids.to(torch.int32), cap, -1))
    return ix, _live_prefix(n, cap, codes.device)


def make_float_flat_segment(embeddings: Tensor, mask: Tensor,
                            doc_ids: Tensor, cap: Optional[int] = None
                            ) -> Tuple[FloatFlatIndex, Tensor]:
    n = embeddings.shape[0]
    cap = segment_capacity(n) if cap is None else cap
    ix = FloatFlatIndex(pad_dim0(embeddings, cap),
                        pad_dim0(mask, cap, False),
                        pad_dim0(doc_ids.to(torch.int32), cap, -1))
    return ix, _live_prefix(n, cap, embeddings.device)


def make_hamming_segment(codes: Tensor, mask: Tensor, bits: int,
                         doc_ids: Tensor, cap: Optional[int] = None
                         ) -> Tuple[HammingIndex, Tensor]:
    n = codes.shape[0]
    cap = segment_capacity(n) if cap is None else cap
    ix = HammingIndex(pad_dim0(codes.to(torch.uint16), cap),
                      pad_dim0(mask, cap, False),
                      pad_dim0(doc_ids.to(torch.int32), cap, -1), int(bits))
    return ix, _live_prefix(n, cap, codes.device)


def make_ivf_segment(codes: Tensor, mask: Tensor, codebook: Tensor,
                     centroids: Tensor, doc_ids: Tensor,
                     cap: Optional[int] = None) -> Tuple[IVFIndex, Tensor]:
    """Bucket an append delta through EXISTING routing centroids (no
    re-clustering), so one routing decision covers every segment. The
    bucket cap defaults to the pow2 bucket of the realised largest load
    (read on the host), so an append never drops a document."""
    doc_vec = doc_mean_vectors(codes, mask, codebook)
    assign_ = route_assign(doc_vec, centroids)
    n_list = centroids.shape[0]
    if cap is None:
        counts = torch.bincount(assign_, minlength=n_list)
        cap = segment_capacity(int(counts.max()) if counts.numel() else 1)
    bc, bm, bv, bi = _bucket_scatter(codes, mask, doc_ids.to(torch.int32),
                                     assign_, n_list, int(cap))
    return IVFIndex(centroids, bc, bm, bv, bi, codebook), bv


# -- segmented search (full sweep: merge buffer carried across segments) ----

def _empty_topk(b: int, k: int, score_dtype: torch.dtype, device
                ) -> Tuple[Tensor, Tensor]:
    return (torch.full((b, k), scan_mod.score_sentinel(score_dtype),
                       dtype=score_dtype, device=device),
            torch.full((b, k), -1, dtype=torch.int32, device=device))


def search_flat_segmented(seg: SegmentedState, q: Tensor, q_mask: Tensor, *,
                          k: int, scan: Optional[scan_mod.ScanConfig] = None
                          ) -> Tuple[Tensor, Tensor]:
    """ADC MaxSim over a segment list: one sweep per segment, one carried
    (B, k) merge buffer. Tombstoned and padding slots (live False) score
    exactly NEG_INF with id -1, so deletes need no change to the codes."""
    carry = None
    for payload, live in zip(seg.segments, seg.live):
        carry = scan_mod.quantized_maxsim_topk(
            q, q_mask, payload.codes, payload.mask, payload.codebook, k=k,
            doc_ids=payload.doc_ids, valid=live, scan=scan, carry=carry)
    return carry if carry is not None else _empty_topk(
        q.shape[0], k, torch.float32, q.device)


def search_float_flat_segmented(seg: SegmentedState, q: Tensor,
                                q_mask: Tensor, *, k: int,
                                scan: Optional[scan_mod.ScanConfig] = None
                                ) -> Tuple[Tensor, Tensor]:
    carry = None
    for payload, live in zip(seg.segments, seg.live):
        carry = scan_mod.maxsim_topk(
            q, q_mask, payload.embeddings, payload.mask, k=k,
            doc_ids=payload.doc_ids, valid=live, scan=scan, carry=carry)
    return carry if carry is not None else _empty_topk(
        q.shape[0], k, torch.float32, q.device)


def search_hamming_segmented(seg: SegmentedState, q_codes: Tensor,
                             q_mask: Tensor, *, bits: int, k: int,
                             scan: Optional[scan_mod.ScanConfig] = None
                             ) -> Tuple[Tensor, Tensor]:
    carry = None
    for payload, live in zip(seg.segments, seg.live):
        carry = scan_mod.hamming_maxsim_topk(
            q_codes, q_mask, payload.codes, payload.mask, bits=bits, k=k,
            doc_ids=payload.doc_ids, valid=live, scan=scan, carry=carry)
    return carry if carry is not None else _empty_topk(
        q_codes.shape[0], k, torch.int32, q_codes.device)


def search_ivf_segmented(seg: SegmentedState, q: Tensor, q_mask: Tensor, *,
                         n_probe: int, k: int,
                         scan: Optional[scan_mod.ScanConfig] = None
                         ) -> Tuple[Tensor, Tensor]:
    """Route once over the shared centroids (every segment buckets
    through segment 0's), then score each segment's probed pool with one
    carried merge buffer: one ``quantized_maxsim`` launch per segment."""
    probe = _probe(seg.segments[0].routing_centroids, q, q_mask, n_probe)
    carry = None
    for payload, live in zip(seg.segments, seg.live):
        codes, mask, valid, ids = _probed_pool(payload, live, probe)
        carry = scan_mod.quantized_maxsim_topk(
            q, q_mask, codes, mask, payload.codebook, k=k, doc_ids=ids,
            valid=valid, scan=scan, carry=carry)
    return carry if carry is not None else _empty_topk(
        q.shape[0], k, torch.float32, q.device)


# -- segmented candidate stages (the cascade's stage boundaries) ------------

def _resolve_segmented(seg: SegmentedState, candidate_ids: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """(B, P) global doc ids -> (ids, valid, flattened positions) through
    ``pos_of_id``: dead or unknown ids resolve to position -1, id -1, and
    are never scored."""
    id_cap = seg.pos_of_id.shape[0]
    in_range = (candidate_ids >= 0) & (candidate_ids < id_cap)
    safe = torch.clamp(candidate_ids, 0, id_cap - 1).to(torch.int64)
    pos = torch.where(in_range, seg.pos_of_id[safe], -1)
    valid = pos >= 0
    ids = torch.where(valid, candidate_ids, -1).to(torch.int32)
    return ids, valid, pos.to(torch.int32)


def _gather_segmented(seg: SegmentedState, pos: Tensor,
                      leaf_names: Tuple[str, ...]) -> Tuple[Tensor, ...]:
    """Gather the (B, P) positions' rows of each named leaf across the
    segment list: one clamped gather + select per segment, O(B * P * row)
    each, never O(N). Positions -1 read zeros."""
    outs = None
    offset = 0
    for payload in seg.segments:
        size = int(seg_doc_ids(payload).numel())
        local = pos.to(torch.int64) - offset
        in_seg = (local >= 0) & (local < size)
        idx = torch.clamp(local, 0, size - 1)
        gathered = []
        for i, nm in enumerate(leaf_names):
            leaf = getattr(payload, nm)
            g = indexable(leaf)[idx]                          # (B, P, ...)
            sel = in_seg.reshape(in_seg.shape + (1,) * (g.dim() - 2))
            prev = (indexable(outs[i]) if outs is not None
                    else torch.zeros_like(g))
            gathered.append(torch.where(sel, g, prev).view(leaf.dtype))
        outs = gathered
        offset += size
    return tuple(outs)


def search_flat_segmented_candidates(
        seg: SegmentedState, q: Tensor, q_mask: Tensor, candidate_ids: Tensor,
        *, k: int, scan: Optional[scan_mod.ScanConfig] = None
        ) -> Tuple[Tensor, Tensor]:
    """ADC MaxSim over a (B, P) global-id pool resolved through
    ``pos_of_id`` (the pool's codes are gathered: B x P x Md bytes)."""
    ids, valid, pos = _resolve_segmented(seg, candidate_ids)
    codes, mask = _gather_segmented(seg, pos, ("codes", "mask"))
    return scan_mod.quantized_maxsim_topk(
        q, q_mask, codes, mask, seg.segments[0].codebook, k=k,
        doc_ids=ids, valid=valid, scan=scan)


def search_float_flat_segmented_candidates(
        seg: SegmentedState, q: Tensor, q_mask: Tensor, candidate_ids: Tensor,
        *, k: int, scan: Optional[scan_mod.ScanConfig] = None
        ) -> Tuple[Tensor, Tensor]:
    """Float MaxSim over a (B, P) global-id pool: the cascade's stage 3 on
    a segmented state. The ids resolve to flattened positions, which go to
    the scan as ``rows`` with the segments' tensors as one corpus: the
    kernel finds each position's segment in a small table and reads the
    embeddings in place, so no pool is gathered."""
    ids, valid, pos = _resolve_segmented(seg, candidate_ids)
    docs = tuple(p.embeddings for p in seg.segments)
    masks = tuple(p.mask for p in seg.segments)
    return scan_mod.maxsim_topk(q, q_mask, docs, masks, k=k, doc_ids=ids,
                                valid=valid, scan=scan, rows=pos)


def search_hamming_segmented_candidates(
        seg: SegmentedState, q_codes: Tensor, q_mask: Tensor,
        candidate_ids: Tensor, *, bits: int, k: int,
        scan: Optional[scan_mod.ScanConfig] = None) -> Tuple[Tensor, Tensor]:
    ids, valid, pos = _resolve_segmented(seg, candidate_ids)
    codes, mask = _gather_segmented(seg, pos, ("codes", "mask"))
    return scan_mod.hamming_maxsim_topk(
        q_codes, q_mask, codes, mask, bits=bits, k=k, doc_ids=ids,
        valid=valid, scan=scan)


def search_hamming_floor(index_or_seg, q_codes: Tensor, q_mask: Tensor, *,
                         bits: int, k: int,
                         scan: Optional[scan_mod.ScanConfig] = None
                         ) -> Tuple[Tensor, Tensor]:
    """Degraded-serving floor: the Hamming scan alone over a HammingIndex
    or a SegmentedState of Hamming segments, with its int32 scores cast to
    float32 so every rung of the degradation ladder returns the same
    dtypes."""
    if isinstance(index_or_seg, SegmentedState):
        scores, ids = search_hamming_segmented(
            index_or_seg, q_codes, q_mask, bits=bits, k=k, scan=scan)
    else:
        scores, ids = search_hamming(index_or_seg, q_codes, q_mask,
                                     bits=bits, k=k, scan=scan)
    return scores.to(torch.float32), ids


def gather_live_rows(seg: SegmentedState, leaf_names: Tuple[str, ...]
                     ) -> Tuple[Tuple[Tensor, ...], Tensor]:
    """Every live doc's rows in flattened slot order, on the segments'
    device: the compaction primitive. Returns (leaves..., doc_ids) with
    the live docs in the row-major order of the segment list, so doc order
    and tie order survive compaction; padding and tombstones are dropped.
    The outputs come padded to ``segment_capacity(live docs)`` rows
    (zeros, doc id -1), ready to be one segment: each is allocated once
    and filled in place, so the compacted copy is the only one made (5 GB
    for the cascade's float member at ColPali width). A layout with 2-D
    slots (IVF's (n_list, cap) buckets) is read as (n_list * cap) rows,
    bucket after bucket."""
    keeps = []
    for payload, lv in zip(seg.segments, seg.live):
        ids = seg_doc_ids(payload).reshape(-1)
        keeps.append(torch.nonzero(lv.reshape(-1) & (ids >= 0)).squeeze(1))
    n_live = sum(int(k.numel()) for k in keeps)
    rows = segment_capacity(n_live)
    first = seg.segments[0]
    slot_dims = seg_doc_ids(first).dim()
    leaves = []
    for nm in leaf_names:
        ref = getattr(first, nm)
        out = torch.empty((rows,) + tuple(ref.shape[slot_dims:]),
                          dtype=ref.dtype, device=ref.device)
        out[n_live:] = 0
        leaves.append(out)
    ids_out = torch.full((rows,), -1, dtype=torch.int32,
                         device=seg_doc_ids(first).device)
    off = 0
    for payload, keep in zip(seg.segments, keeps):
        n = int(keep.numel())
        for out, nm in zip(leaves, leaf_names):
            leaf = getattr(payload, nm)
            leaf = leaf.reshape((-1,) + tuple(leaf.shape[slot_dims:]))
            torch.index_select(leaf, 0, keep, out=out[off:off + n])
        torch.index_select(seg_doc_ids(payload).reshape(-1).to(torch.int32),
                           0, keep, out=ids_out[off:off + n])
        off += n
    return tuple(leaves), ids_out

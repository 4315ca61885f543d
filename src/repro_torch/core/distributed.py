"""Mesh-sharded retrieval: the paper's system at corpus scale.

The counterpart of ``repro.core.distributed``, on ``torch.distributed``:
one rank per device, a ``DeviceMesh`` over them (``launch.mesh``).

The quantized corpus (codes + masks + ids) is sharded over mesh axes (each
rank owns N/n_shards documents); queries are replicated. Each rank scans
its shard with the streaming ADC scan (``core.scan.quantized_maxsim_topk``:
the CUDA ``quantized_maxsim`` kernel for CUDA tensors), keeps its top k,
and the global answer is the top k of the all-gathered (score, id) pairs:
k x 8 bytes a query and rank against the multi-GB scan.

Also the sharded K-means v2 trainer: points sharded over ranks, codebook
replicated, per-cluster sums all-reduced, empty-cluster repair from the
global farthest points (each rank's farthest all-gathered, then the top
k of those), best-iterate tracking and best-of-restarts — the algorithm
of the single-host ``quantization.kmeans_fit`` with its seeds (k-means++
through ``seed_centroids`` from the same generator), so on one rank the
two agree within float rounding. ``sharded_quantize`` assigns each rank's
rows through ``quantization.quantize`` (the CUDA ``kmeans_assign`` kernel
for CUDA tensors). ``Retriever.build(..., mesh=...)`` builds through both.

And the per-rank search programs every backend runs over a state that
``Retriever.shard`` placed (the last section): a sweep's top-k lists
all-gathered and merged in shard order, or a candidate pool scored where
its rows live and all-reduced by MAX; every rank ends with the unsharded
answer.

Sharded inputs are DTensors (their local shards are used) or tensors that
every rank holds whole (each rank takes its own rows, in the row-major
shard order of ``dist.sharding.shard_index``). A tensor on another device
type than the mesh's raises.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import graph as graph_mod
from repro_torch.core import index as index_mod
from repro_torch.core import quantization as quant
from repro_torch.core import scan as scan_mod
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import (NamedSharding, Sharder, check_device,
                                       full_tensor, local, shard_index,
                                       sharded_axes)
from repro_torch.kernels import ops as kernel_ops

Tensor = torch.Tensor


def corpus_data_axes(mesh, n: int) -> Tuple[str, ...]:
    """Mesh axes an N-point dimension shards over on this mesh.

    Resolved through the Sharder's "corpus" rule (``DEFAULT_RULES``; the
    rule ``Retriever.shard`` uses, so build-time and search-time sharding
    agree): missing axes are skipped and axes drop from the right until n
    divides the shard product. () when nothing divides (the caller falls
    back to the single-host path).
    """
    entry = Sharder(mesh).resolve(("corpus",), (n,))[0]
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_rows(t, mesh, axes: Tuple[str, ...]) -> Tensor:
    """This rank's rows of ``t`` sharded over ``axes``: a DTensor's local
    shard, or the rank's slice of a tensor every rank holds whole."""
    if isinstance(t, DTensor):
        return t.to_local()
    index, count = shard_index(mesh, axes)
    if t.shape[0] % count:
        raise ValueError(f"{t.shape[0]} rows do not split over {count} "
                         f"shards of axes {axes}")
    n_local = t.shape[0] // count
    return t.narrow(0, index * n_local, n_local)


def _codes_and_mask(codes: Tensor, mask: Tensor, k: int
                    ) -> Tuple[Tensor, Tensor]:
    """The reference's int32 codes and float masks as the kernel reads
    them (uint8/uint16 codes, bool masks); the port's pass as they are."""
    if codes.dtype not in (torch.uint8, torch.uint16):
        codes = codes.to(torch.uint8 if k <= 256 else torch.uint16)
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return codes, mask


def sharded_search_fn(mesh, corpus_axes: Tuple[str, ...], *, k: int,
                      scan: Optional[scan_mod.ScanConfig] = None):
    """Build the corpus-sharded ADC search.

    Returns a function
      (q (B, Mq, D), q_mask (B, Mq),
       codes (N, Md), mask (N, Md), doc_ids (N,), codebook (K, D))
      -> (scores (B, k), ids (B, k)), the same on every rank,
    with codes/mask/doc_ids sharded over ``corpus_axes`` on dim 0 and the
    rest replicated. Codes may be uint8/uint16 (or the reference's int32),
    masks bool/uint8 (or float, nonzero = valid). Each rank keeps the top
    k of its shard, ordered by score then position; the gathered lists
    are merged in shard order, so ties go to the lowest position, as one
    global top-k would. Fewer than k documents: the tail carries id -1
    and -inf.
    """
    def search(q, q_mask, codes, mask, doc_ids, codebook):
        q, q_mask, codebook = (full_tensor(t) for t in (q, q_mask, codebook))
        codes = local_rows(codes, mesh, corpus_axes)
        mask = local_rows(mask, mesh, corpus_axes)
        doc_ids = local_rows(doc_ids, mesh, corpus_axes)
        check_device(mesh, q, q_mask, codes, mask, doc_ids, codebook)
        codes, mask = _codes_and_mask(codes, mask, codebook.shape[0])
        top_s, top_i = scan_mod.quantized_maxsim_topk(
            q, q_mask, codes, mask, codebook, k=k,
            doc_ids=doc_ids.to(torch.int32), scan=scan)
        return _gather_merge(top_s, top_i, mesh, corpus_axes, k)

    return search


def _gather_merge(s: Tensor, ids: Tensor, mesh, axes: Tuple[str, ...],
                  k: int, carry: Optional[Tuple[Tensor, Tensor]] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Shape (a)'s collective: every rank's (B, k) list over ``axes``,
    all-gathered in shard order and merged into ``carry`` (sentinels
    when None). The lists are ordered by score then position and go into
    the stable merge in shard order, so ties resolve to the lowest
    position, as one sweep over the whole corpus would. One shard and no
    carry: the list is the answer."""
    s = coll.all_gather_axes(s, mesh, axes, dim=1)
    ids = coll.all_gather_axes(ids, mesh, axes, dim=1)
    if carry is None:
        if s.shape[1] == k:
            return s, ids
        carry = scan_mod._init_buffer(s.shape[0], k, s.dtype, s.device, None)
    return scan_mod._merge(*carry, *scan_mod._head(s, ids, k), k)


def _farthest(min_d2: Tensor, kk: int) -> Tensor:
    """Positions of the ``kk`` largest distances, largest first and equal
    ones by position: the head of a stable descending sort, found through
    a top-k threshold so only the candidates are sorted."""
    if kk >= min_d2.shape[0]:
        return torch.sort(min_d2, descending=True, stable=True).indices
    thr = torch.topk(min_d2, kk).values[-1]  # noqa: TORCH04 (kk < len)
    cand = torch.nonzero(min_d2 >= thr)[:, 0]
    order = torch.sort(min_d2[cand], descending=True, stable=True).indices
    return cand[order[:kk]]


def sharded_kmeans_refine_fn(mesh, data_axes: Tuple[str, ...], *, k: int,
                             iters: int, n_total: int,
                             block_rows: int = 65536):
    """Distributed Lloyd v2: x sharded over ``data_axes``, codebook
    replicated.

    Each step: the assignment (``pairwise_sq_dists`` + argmin, in
    ``block_rows`` row blocks, so a rank's transient is (block_rows, K),
    never (N_local, K)) -> local segment sums -> all-reduce over the data
    axes -> the replicated centroid update -> empty-cluster repair (every
    rank's k farthest points all-gathered and their top k taken, so dead
    centroids re-seed on the *global* farthest points, the rule of
    ``quantization._repair_dead_centroids``). Tracks the lowest-inertia
    iterate as ``quantization.kmeans_refine`` does. Row blocking changes
    no row's argmin or min.

    Returns f(x, centroids0) -> (best_centroids, inertias (iters,),
    best_inertia), the same on every rank.
    """
    def e_step(x: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
        n = x.shape[0]
        codes = torch.empty((n,), dtype=torch.int64, device=x.device)
        min_d2 = torch.empty((n,), dtype=x.dtype, device=x.device)
        for start in range(0, n, block_rows):
            t = min(block_rows, n - start)
            d2 = quant.pairwise_sq_dists(x.narrow(0, start, t), c)
            cb = torch.argmin(d2, dim=-1)
            codes[start:start + t] = cb
            min_d2[start:start + t] = d2.gather(1, cb[:, None])[:, 0]
        return codes, min_d2

    def total_inertia(min_d2: Tensor) -> Tensor:
        return coll.all_reduce_axes(min_d2.sum(), mesh, data_axes) / n_total

    def repair(x, centroids, cnts, min_d2):
        dead = cnts <= 0
        if not bool(dead.any()):     # the same on every rank: cnts reduced
            return centroids
        far = _farthest(min_d2, min(k, x.shape[0]))
        far_d = coll.all_gather_axes(min_d2[far], mesh, data_axes)
        far_x = coll.all_gather_axes(x[far], mesh, data_axes)
        cand = far_x[_farthest(far_d, min(k, far_d.shape[0]))]
        rank = torch.clamp(torch.cumsum(dead.to(torch.int64), 0) - 1, 0,
                           cand.shape[0] - 1)
        return torch.where(dead[:, None], cand[rank], centroids)

    def fit(x, centroids0: Tensor):
        x = local_rows(x, mesh, data_axes)
        check_device(mesh, x, centroids0)
        c = centroids0
        best_c = centroids0
        best_i = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
        inertias = []
        for _ in range(iters):
            codes, min_d2 = e_step(x, c)
            sums, cnts = quant._cluster_sums(x, codes, k)
            # one all-reduce a step: sums, counts and the inertia's sum
            packed = coll.all_reduce_axes(torch.cat(
                [sums.reshape(-1), cnts, min_d2.sum()[None]]), mesh,
                data_axes)
            sums = packed[:sums.numel()].reshape(sums.shape)
            cnts = packed[sums.numel():sums.numel() + k]
            inertia = packed[-1] / n_total
            new_c = torch.where(cnts[:, None] > 0,
                                sums / torch.clamp(cnts[:, None], min=1.0), c)
            new_c = repair(x, new_c, cnts, min_d2)
            better = inertia < best_i
            best_c = torch.where(better, c, best_c)
            best_i = torch.where(better, inertia, best_i)
            inertias.append(inertia)
            c = new_c
        _, min_d2 = e_step(x, c)
        last_i = total_inertia(min_d2)
        better = last_i < best_i
        best_c = torch.where(better, c, best_c)
        best_i = torch.where(better, last_i, best_i)
        stacked = (torch.stack(inertias) if inertias
                   else torch.zeros((0,), dtype=x.dtype, device=x.device))
        return best_c, stacked, best_i

    return fit


def sharded_kmeans_fit(mesh, gen: torch.Generator, x: Tensor,
                       config: quant.KMeansConfig,
                       data_axes: Optional[Tuple[str, ...]] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Mesh-sharded ``quantization.kmeans_fit``: the same seeds, the same
    algorithm.

    x (N, D) is whole on every rank. Per restart: k-means++ seeds on a
    ``seed_batch`` subsample from ``gen`` (the draws the single-host fit
    makes), sent from the first rank of the data axes so every rank
    starts alike, then the sharded Lloyd v2 over x's rows; the restart
    with the lowest final inertia wins. Falls back to the single-host fit,
    with a warning, when no corpus axis of the mesh divides N.

    Mini-batch Lloyd is single-host only: here ``config.minibatch`` bounds
    the E-step's transient to (minibatch, K) row blocks instead (full-batch
    statistics, the same result as unblocked).

    Returns (centroids (K, D), per-iteration inertia (iters,)).
    """
    x = x.to(config.dtype)
    n = x.shape[0]
    if data_axes is None:
        data_axes = corpus_data_axes(mesh, n)
    if not data_axes:
        warnings.warn(
            f"sharded_kmeans_fit: no 'corpus'-rule mesh axis divides N={n} "
            f"on mesh {dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))}; "
            "falling back to the single-host fit (full single-device "
            "memory)", stacklevel=2)
        return quant.kmeans_fit(gen, x, config)
    check_device(mesh, x)
    refine = sharded_kmeans_refine_fn(
        mesh, data_axes, k=config.k, iters=config.iters, n_total=n,
        block_rows=config.minibatch if config.minibatch > 0 else 65536)
    best = None
    for _ in range(max(1, config.n_restarts)):
        c0 = coll.broadcast_axes(quant.seed_centroids(gen, x, config), mesh,
                                 data_axes)
        c, hist, inertia = refine(x, c0)
        if best is None or float(inertia) < best[0]:
            best = (float(inertia), c, hist)
    return best[1], best[2]


def sharded_quantize(mesh, x: Tensor, codebook: Tensor, code_dtype,
                     data_axes: Optional[Tuple[str, ...]] = None) -> Tensor:
    """Quantize (N, ..., D) across the mesh: each rank assigns its rows
    through ``quantization.quantize`` (the CUDA ``kmeans_assign`` kernel
    for CUDA tensors), and the codes (N, ...) are all-gathered, whole on
    every rank. Falls back to single-host quantization when no corpus axis
    divides N."""
    n = x.shape[0]
    if data_axes is None:
        data_axes = corpus_data_axes(mesh, n)
    if not data_axes:
        warnings.warn(
            f"sharded_quantize: no corpus mesh axis divides N={n}; falling "
            "back to single-host quantization", stacklevel=2)
        return quant.quantize(x, codebook, code_dtype=code_dtype)
    check_device(mesh, x, codebook)
    codes = quant.quantize(local_rows(x, mesh, data_axes), codebook,
                           code_dtype=code_dtype, impl="auto")
    return coll.all_gather_axes(codes, mesh, data_axes, dim=0)


def corpus_shardings(mesh, corpus_axes: Tuple[str, ...]
                     ) -> Dict[str, NamedSharding]:
    """NamedShardings for (codes, mask, doc_ids, codebook, queries...)."""
    names = tuple(mesh.mesh_dim_names)
    c = NamedSharding(mesh, tuple(Shard(0) if a in corpus_axes
                                  else Replicate() for a in names))
    r = NamedSharding(mesh, (Replicate(),) * len(names))
    return dict(codes=c, mask=c, doc_ids=c, codebook=r, replicated=r)


# ---------------------------------------------------------------------------
# Per-rank search programs over a state that ``Retriever.shard`` placed
# ---------------------------------------------------------------------------
#
# Every rank runs the same program on its own rows and ends with the answer
# of the unsharded search: the same ids in the same order, ties included.
# Two collective shapes cover every stage:
#
#   (a) a full sweep over corpus-sharded rows (flat, hamming, float_flat,
#       cascade stage 1): each rank sweeps its rows through the scan and
#       keeps its top k, then one all-gather and one merge in shard order
#       (``_gather_merge``), segment after segment into a carried buffer;
#   (b) a (B, P) pool of candidates (the facade rerank, cascade stages 2
#       and 3, the IVF pool, the HNSW survivors): each rank scores the
#       slots whose rows it holds with the full-score kernel and writes the
#       sentinel into the others, at the same slot positions, then one
#       all-reduce MAX and the merge the local path makes (``_pool_topk``).
#
# A leaf that the divisibility fallback replicated has no sharded axes: it
# is searched once on every rank and crosses no collective.

class _Part(NamedTuple):
    """One payload (a monolithic structure or a segment) on this rank."""
    payload: Any                # this rank's leaves
    live: Optional[Tensor]      # this rank's live bits (None: all live)
    size: int                   # global rows of dim 0 (IVF: buckets)
    axes: Tuple[str, ...]       # mesh axes dim 0 is sharded over
    start: int                  # this rank's first global row
    n_local: int


def _part(payload, live, mesh, lead=None) -> _Part:
    """``payload`` (DTensor leaves) as a ``_Part``; ``lead`` is the leaf
    whose dim 0 defines the rows (its doc ids by default)."""
    lead = index_mod.seg_doc_ids(payload) if lead is None else lead
    axes = sharded_axes(lead) if isinstance(lead, DTensor) else ()
    index, count = shard_index(mesh, axes)
    n_local = lead.shape[0] // count
    here = None if payload is None else type(payload)(
        *(local(x) for x in payload))
    return _Part(here, None if live is None else local(live),
                 int(lead.shape[0]),
                 axes, index * n_local, n_local)


def _parts(index_or_seg, mesh) -> Tuple[_Part, ...]:
    """The payloads of a monolithic structure or a SegmentedState."""
    if isinstance(index_or_seg, index_mod.SegmentedState):
        return tuple(_part(p, lv, mesh) for p, lv in
                     zip(index_or_seg.segments, index_or_seg.live))
    return (_part(index_or_seg, None, mesh),)


def _pool_axes(mesh, parts) -> Tuple[str, ...]:
    """The mesh axes any part is sharded over, in mesh order: a pool's
    all-reduce spans them (ranks that hold equal rows reduce equal
    values)."""
    used = {a for p in parts for a in p.axes}
    return tuple(a for a in mesh.mesh_dim_names if a in used)


def _owned(parts, pos: Tensor) -> Tensor:
    """Global positions (B, P), flattened across the parts as the local
    path flattens its segments (-1 = empty slot), -> this rank's
    flattened positions into its own rows, -1 where it holds none."""
    pos = pos.to(torch.int64)
    out = torch.full_like(pos, -1)
    g = l = 0
    for p in parts:
        rel = pos - (g + p.start)
        mine = (pos >= 0) & (rel >= 0) & (rel < p.n_local)
        out = torch.where(mine, rel + l, out)
        g += p.size
        l += p.n_local
    return out


def _pool_topk(s: Tensor, ids: Tensor, own: Tensor, mesh,
               axes: Tuple[str, ...], k: int) -> Tuple[Tensor, Tensor]:
    """Shape (b)'s collective and merge: the slots this rank does not own
    take the sentinel (-inf; the int32 minimum for Hamming scores) and id
    -1, one all-reduce MAX of scores and ids together, then the local
    path's merge, invalid slots (id -1) scoring NEG_INF (Hamming: the
    int32 minimum). The pool keeps its order, so ties keep the local
    order."""
    if s.dtype.is_floating_point:     # float32 scores and ids are exact
        fill, wide = float("-inf"), torch.float64
        invalid = scan_mod.NEG_INF
    else:
        fill = invalid = torch.iinfo(s.dtype).min
        wide = s.dtype
    packed = torch.stack([torch.where(own, s, fill).to(wide),
                          torch.where(own, ids, -1).to(wide)])
    coll.all_reduce_axes(packed, mesh, axes, op=torch.distributed.ReduceOp.MAX)
    s, ids = packed[0].to(s.dtype), packed[1].to(torch.int32)
    valid = ids >= 0
    init = scan_mod._init_buffer(s.shape[0], k, s.dtype, s.device, None)
    return scan_mod._merge(*init, torch.where(valid, s, invalid),
                           torch.where(valid, ids, -1), k)


def _impl(scan) -> str:
    return (scan if scan is not None else scan_mod.DEFAULT).impl


def _score_rows(kind: str, parts, pos: Tensor, q: Tensor, q_mask: Tensor, *,
                bits: int = 0, scan=None) -> Tuple[Tensor, Tensor]:
    """This rank's scores (B, P) of the rows at its flattened positions
    ``pos`` (-1: not held here) through the full-score kernel of ``kind``
    ("adc", "binary" or "float"), and their doc ids."""
    seg = index_mod.SegmentedState(tuple(p.payload for p in parts),
                                   tuple(p.live for p in parts), None)
    impl = _impl(scan)
    if kind == "float":               # the rows layout: read in place
        ids, = index_mod._gather_segmented(seg, pos, ("doc_ids",))
        return kernel_ops.maxsim(
            q, q_mask, tuple(p.payload.embeddings for p in parts),
            tuple(p.payload.mask for p in parts), rows=pos.to(torch.int32),
            impl=impl), ids
    codes, mask, ids = index_mod._gather_segmented(
        seg, pos, ("codes", "mask", "doc_ids"))
    if kind == "binary":
        return kernel_ops.hamming_maxsim(q, q_mask, codes, mask, bits=bits,
                                         impl=impl), ids
    return kernel_ops.quantized_maxsim(q, q_mask, codes, mask,
                                       parts[0].payload.codebook,
                                       impl=impl), ids


def sharded_sweep(index_or_seg, q: Tensor, q_mask: Tensor, *, kind: str,
                  k: int, mesh, bits: int = 0, scan=None
                  ) -> Tuple[Tensor, Tensor]:
    """Shape (a): the exhaustive search of a placed FlatIndex ("adc"),
    HammingIndex ("binary"; ``q`` the query codes) or FloatFlatIndex
    ("float"), monolithic or a SegmentedState of them -> (scores (B, k),
    ids (B, k)), the unsharded search's on every rank. Each rank sweeps
    its rows of each segment through the scan (the segment's kernel at
    the local shapes) and keeps its top k; the lists are all-gathered
    over the segment's axes and merged into the carried buffer, segment
    after segment: one all-gather and merge per segment, since the ranks'
    rows interleave across segments. Hamming scores are int32, with the
    int32 minimum in an empty slot."""
    check_device(mesh, q)

    def topk(p: _Part):
        pl = p.payload
        if kind == "adc":
            return scan_mod.quantized_maxsim_topk(
                q, q_mask, pl.codes, pl.mask, pl.codebook, k=k,
                doc_ids=pl.doc_ids, valid=p.live, scan=scan)
        if kind == "binary":
            return scan_mod.hamming_maxsim_topk(
                q, q_mask, pl.codes, pl.mask, bits=bits, k=k,
                doc_ids=pl.doc_ids, valid=p.live, scan=scan)
        return scan_mod.maxsim_topk(q, q_mask, pl.embeddings, pl.mask, k=k,
                                    doc_ids=pl.doc_ids, valid=p.live,
                                    scan=scan)

    carry = None
    for p in _parts(index_or_seg, mesh):
        carry = _gather_merge(*topk(p), mesh, p.axes, k, carry)
    return carry


def sharded_candidates(index_or_seg, q: Tensor, q_mask: Tensor,
                       candidate_ids: Tensor, *, kind: str, k: int, mesh,
                       bits: int = 0, scan=None) -> Tuple[Tensor, Tensor]:
    """Shape (b): a (B, P) candidate pool scored against a placed
    structure (the kinds of ``sharded_sweep``), the unsharded
    ``search_*_candidates``' answer on every rank. On a monolithic
    structure the candidates are positions (clamped into the corpus as
    the local path clamps them); on a SegmentedState global ids, resolved
    through the replicated ``pos_of_id``."""
    check_device(mesh, q)
    if isinstance(index_or_seg, index_mod.SegmentedState):
        seg = dataclasses.replace(index_or_seg,
                                  pos_of_id=local(index_or_seg.pos_of_id))
        _, _, pos = index_mod._resolve_segmented(seg, candidate_ids)
    else:
        n = index_mod.seg_doc_ids(index_or_seg).shape[0]
        valid, safe = index_mod._clamp_positions(candidate_ids, n)
        pos = torch.where(valid, safe, -1)
    parts = _parts(index_or_seg, mesh)
    mine = _owned(parts, pos)
    s, ids = _score_rows(kind, parts, mine, q, q_mask, bits=bits, scan=scan)
    return _pool_topk(s, ids, mine >= 0, mesh, _pool_axes(mesh, parts), k)


def sharded_ivf(index_or_seg, q: Tensor, q_mask: Tensor, *, n_probe: int,
                k: int, mesh, scan=None) -> Tuple[Tensor, Tensor]:
    """Shape (b) for a placed IVFIndex, monolithic or segmented: every
    rank routes alike over the replicated centroids; a rank owns a probed
    bucket when the bucket falls in its block of n_list, builds the
    (B, n_probe x cap) pool at its own buckets (the other buckets' slots
    invalid) and scores it; the pools of every segment go through one
    all-reduce and one merge (the local path's carried merges give the
    same top k)."""
    check_device(mesh, q)
    parts = _parts(index_or_seg, mesh)
    probe = index_mod._probe(parts[0].payload.routing_centroids, q, q_mask,
                             n_probe)
    scores, ids, owns = [], [], []
    for p in parts:
        pl = p.payload
        rel = probe - p.start
        mine = (rel >= 0) & (rel < p.n_local)
        live = p.live if p.live is not None else pl.bucket_valid
        codes, mask, valid, pids = index_mod._probed_pool(
            pl, live, torch.where(mine, rel, 0))
        own = mine.repeat_interleave(pl.bucket_codes.shape[1], dim=1)
        scores.append(kernel_ops.quantized_maxsim(
            q, q_mask, codes, mask, pl.codebook, impl=_impl(scan)))
        ids.append(torch.where(valid, pids, -1))
        owns.append(own)
    return _pool_topk(torch.cat(scores, 1), torch.cat(ids, 1),
                      torch.cat(owns, 1), mesh, _pool_axes(mesh, parts), k)


def sharded_hnsw(index, live: Optional[Tensor], q: Tensor, q_mask: Tensor,
                 *, ef_search: int, k: int, mesh, scan=None
                 ) -> Tuple[Tensor, Tensor]:
    """Shape (b) for a placed HNSWIndex (``live``: the replicated live
    bits of a segmented state, or None): the graph is replicated, so every
    rank walks it alike (the walk syncs on its own data and calls no
    collective); the survivors are scored by the ranks that hold their
    codes."""
    check_device(mesh, q)
    part = _part(index, None, mesh)
    g = part.payload
    q_vec = index_mod.mean_pool(q.to(g.doc_vecs.dtype), q_mask)
    _, cand = graph_mod.hnsw_candidates(g, q_vec, ef_search=ef_search)
    valid = cand >= 0
    if live is not None:
        valid = valid & local(live)[torch.clamp(cand, min=0).to(torch.int64)]
    mine = _owned((part,), torch.where(valid, cand, -1))
    s, ids = _score_rows("adc", (part,), mine, q, q_mask, scan=scan)
    return _pool_topk(s, ids, mine >= 0, mesh, part.axes, k)


def sharded_rerank(rerank_codes, rerank_mask, codebook, q: Tensor,
                   q_mask: Tensor, ids: Tensor, *, k: int, mesh, scan=None
                   ) -> Tuple[Tensor, Tensor]:
    """Shape (b) for the facade's rerank: the (B, P) candidates' unpruned
    codes are rows of the placed rerank corpus (indexed by global id);
    each rank scores the ids whose rows it holds."""
    check_device(mesh, q)
    part = _part(None, None, mesh, lead=rerank_codes)
    rows = torch.arange(part.start, part.start + part.n_local,
                        dtype=torch.int32, device=q.device)
    part = part._replace(payload=index_mod.FlatIndex(
        local(rerank_codes), local(rerank_mask), local(codebook), rows))
    mine = _owned((part,), torch.where(ids >= 0, ids, -1))
    s, got = _score_rows("adc", (part,), mine, q, q_mask, scan=scan)
    return _pool_topk(s, got, mine >= 0, mesh, part.axes, k)

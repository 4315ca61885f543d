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

Sharded inputs are DTensors (their local shards are used) or tensors that
every rank holds whole (each rank takes its own rows, in the row-major
shard order of ``dist.sharding.shard_index``). A tensor on another device
type than the mesh's raises.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import quantization as quant
from repro_torch.core import scan as scan_mod
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import (NamedSharding, Sharder, check_device,
                                       full_tensor, shard_index)

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
        all_s = coll.all_gather_axes(top_s, mesh, corpus_axes, dim=1)
        all_i = coll.all_gather_axes(top_i, mesh, corpus_axes, dim=1)
        if all_s.shape[1] == k:        # one shard: its list is the answer
            return all_s, all_i
        init = scan_mod._init_buffer(q.shape[0], k, torch.float32,
                                     all_s.device, None)
        return scan_mod._merge(*init, all_s, all_i, k)

    return search


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

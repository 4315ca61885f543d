"""Layered small-world graph (HNSW) over document routing vectors, in
PyTorch.

The counterpart of ``repro.core.graph``. The graph lives over each
document's mean decoded patch (``index.doc_mean_vectors``, the vectors IVF
buckets by), as a padded fixed-degree adjacency ``(levels, N, 2m)`` of
int32 neighbor ids (-1 = empty slot, rows left-packed).

  * Construction inserts the documents one at a time (Malkov & Yashunin,
    Alg. 1, with the Alg. 4 diverse-neighbor heuristic). It is sequential
    by nature and runs in numpy on the host: the functions ``_sq_dists``
    to ``_insert_np`` are the reference's, copied. Given the same level
    draws and vectors it gives the reference's graph; the draws come from
    a ``torch.Generator`` (torch cannot replay ``jax.random``).
  * Search runs on the tensors' device, batched over queries: a greedy
    descent through the upper levels, then a best-first beam of a fixed
    ``ef`` steps over level 0 with a (B, N) visited bitmask. The descent
    stops when no query moves any more; on the card each step's test is
    a host sync (``SYNCS`` counts them). The beam has no syncs.
  * The beam's survivors are scored through the scan's per-query layout
    (one ``quantized_maxsim`` launch on the card), as IVF's pools are.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import scan as scan_mod
from repro_torch.core.index import (doc_mean_vectors, mean_pool,
                                    segment_capacity, take_rows)

Tensor = torch.Tensor

# host syncs made by the greedy descent (one per step on a CUDA tensor)
SYNCS = 0


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    m: int = 8                 # max out-degree on levels >= 1 (level 0: 2m)
    ef_construction: int = 48  # beam width while inserting
    ef_search: int = 64        # query beam width = scanned-candidate budget
    levels: int = 4            # static number of graph levels


class HNSWIndex(NamedTuple):
    doc_vecs: Tensor    # (N, D) float32 mean decoded-patch vectors
    neighbors: Tensor   # (levels, N, 2m) int32 adjacency, -1 padded
    entry: int          # entry node (a node of the highest level)
    node_level: Tensor  # (N,) int32, the top level of each node
    codes: Tensor       # (N, Md) uint8/uint16 quantized patches
    mask: Tensor        # (N, Md) bool
    doc_ids: Tensor     # (N,) int32 global ids
    codebook: Tensor    # (K, D)


# ---------------------------------------------------------------------------
# Build (host-side numpy: insertion is sequential by nature)
# ---------------------------------------------------------------------------

def _sq_dists(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    diff = x - q
    return np.einsum("...d,...d->...", diff, diff)


def _greedy_np(x: np.ndarray, nbrs: np.ndarray, cur: int, q: np.ndarray
               ) -> int:
    """Greedy descent on one level: move to the best neighbor until stuck."""
    d = float(_sq_dists(x[cur], q))
    while True:
        nb = nbrs[cur]
        nb = nb[nb >= 0]
        if nb.size == 0:
            return cur
        nd = _sq_dists(x[nb], q)
        j = int(np.argmin(nd))
        if nd[j] >= d:
            return cur
        cur, d = int(nb[j]), float(nd[j])


def _search_layer_np(x: np.ndarray, nbrs: np.ndarray, entry: int,
                     q: np.ndarray, ef: int) -> list:
    """Best-first search on one level -> up to ef ids, nearest first."""
    d0 = float(_sq_dists(x[entry], q))
    visited = {entry}
    cand = [(d0, entry)]                 # min-heap of frontier
    result = [(-d0, entry)]              # max-heap of the ef best so far
    while cand:
        d, c = heapq.heappop(cand)
        if d > -result[0][0] and len(result) >= ef:
            break
        nb = nbrs[c]
        nb = [int(v) for v in nb[nb >= 0] if int(v) not in visited]
        if not nb:
            continue
        visited.update(nb)
        nd = _sq_dists(x[np.asarray(nb)], q)
        for dn, v in zip(nd, nb):
            dn = float(dn)
            if len(result) < ef or dn < -result[0][0]:
                heapq.heappush(cand, (dn, v))
                heapq.heappush(result, (-dn, v))
                if len(result) > ef:
                    heapq.heappop(result)
    return [v for _, v in sorted((-dd, v) for dd, v in result)]


def _select_diverse(x: np.ndarray, q: np.ndarray, cand: list, cap: int
                    ) -> list:
    """Heuristic neighbor selection (Malkov & Yashunin, Alg. 4): keep a
    candidate (nearest first) only if it is closer to q than to every kept
    neighbor, then backfill the skipped nearest ones up to ``cap``."""
    if not cand:
        return []
    d_q = _sq_dists(x[np.asarray(cand)], q)                   # (len(cand),)
    sel: list = []
    skipped: list = []
    for c, dc in zip(cand, d_q):
        if len(sel) == cap:
            break
        if not sel or np.all(_sq_dists(x[np.asarray(sel)], x[c]) >= dc):
            sel.append(int(c))
        else:
            skipped.append(int(c))
    sel.extend(skipped[:cap - len(sel)])
    return sel


def _connect(nbrs: np.ndarray, x: np.ndarray, i: int, found: list, cap: int
             ) -> None:
    """Set i's neighbor row and the pruned bidirectional back-links (rows
    left-packed; ``cap`` is 2m on level 0, m above)."""
    sel = _select_diverse(x, x[i], found, cap)
    nbrs[i, :len(sel)] = sel
    for j in sel:
        row = nbrs[j]
        filled = np.flatnonzero(row >= 0)
        if filled.size < cap:
            row[filled.size] = i
        else:
            cand = np.append(row[filled], i)
            d = _sq_dists(x[cand], x[j])
            order = [int(c) for c in cand[np.argsort(d, kind="stable")]]
            keep = _select_diverse(x, x[j], order, cap)
            row[:len(keep)] = keep
            row[len(keep):] = -1


def _insert_np(x: np.ndarray, nbrs: np.ndarray, lvl: np.ndarray,
               entry: int, top: int, order, ef_construction: int, m: int
               ) -> Tuple[int, int]:
    """Insert nodes ``order`` into the adjacency in place (Malkov Alg. 1):
    the sequential insert of the bulk build, of an append and of a
    compaction. entry < 0 means the graph is empty. Returns the possibly
    updated (entry, top)."""
    width = 2 * m
    for i in order:
        i = int(i)
        li_ = int(lvl[i])
        if entry < 0:
            entry, top = i, li_
            continue
        cur = entry
        for lev in range(top, li_, -1):
            cur = _greedy_np(x, nbrs[lev], cur, x[i])
        for lev in range(min(li_, top), -1, -1):
            found = _search_layer_np(x, nbrs[lev], cur, x[i],
                                     ef_construction)
            _connect(nbrs[lev], x, i, found, width if lev == 0 else m)
            cur = found[0]
        if li_ > top:
            entry, top = i, li_
    return entry, top


def draw_levels(gen: torch.Generator, n: int, config: HNSWConfig
                ) -> np.ndarray:
    """Exponentially decaying level draws (u uniform in [1e-12, 1),
    level = floor(-ln u / ln m)), capped at the static level count."""
    u = torch.rand((n,), generator=gen, device=gen.device,
                   dtype=torch.float64).cpu().numpy()
    u = np.maximum(u, 1e-12)
    ml = 1.0 / math.log(max(config.m, 2))
    return np.minimum((-np.log(u) * ml).astype(np.int64), config.levels - 1)


def _to_device(x: np.ndarray, nbrs: np.ndarray, lvl: np.ndarray, device
               ) -> Tuple[Tensor, Tensor, Tensor]:
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(nbrs.astype(np.int32)).to(device),
            torch.from_numpy(lvl.astype(np.int32)).to(device))


def build_hnsw(gen: torch.Generator, codes: Tensor, mask: Tensor,
               codebook: Tensor, config: HNSWConfig,
               doc_ids: Optional[Tensor] = None,
               levels: Optional[np.ndarray] = None) -> HNSWIndex:
    """Insert the documents one at a time, in document order, into the
    layered graph. The level draws come from ``gen``, or are given as
    ``levels``; the construction is a pure function of the draws and the
    vectors. The graph comes back on the corpus' device."""
    n = codes.shape[0]
    dev = codes.device
    if doc_ids is None:
        doc_ids = torch.arange(n, dtype=torch.int32, device=dev)
    doc_vecs = doc_mean_vectors(codes, mask, codebook).to(torch.float32)
    x = doc_vecs.cpu().numpy()
    lvl = (draw_levels(gen, n, config) if levels is None
           else np.asarray(levels, np.int64))
    nbrs = np.full((config.levels, n, 2 * config.m), -1, np.int64)
    entry, _ = _insert_np(x, nbrs, lvl, -1, -1, range(n),
                          config.ef_construction, config.m)
    _, neighbors, node_level = _to_device(x, nbrs, lvl, dev)
    return HNSWIndex(doc_vecs, neighbors, int(entry), node_level, codes,
                     mask.to(torch.bool), doc_ids.to(torch.int32), codebook)


# ---------------------------------------------------------------------------
# Search, batched over queries
# ---------------------------------------------------------------------------

def _dists(doc_vecs: Tensor, ids: Tensor, q_vec: Tensor) -> Tensor:
    """Squared L2 from each query (B, D) to its rows ``ids`` (B, W)."""
    return ((doc_vecs[ids] - q_vec[:, None, :]) ** 2).sum(dim=-1)


def _greedy_level(doc_vecs: Tensor, nbrs: Tensor, q_vec: Tensor,
                  cur: Tensor, d_cur: Tensor) -> Tuple[Tensor, Tensor]:
    """Greedy descent on one level for every query: each step moves a
    query to its best neighbor while that strictly improves its distance.
    A query that stopped computes the same step again and stays, so the
    loop runs until no query moves; the test is one host sync."""
    global SYNCS
    while True:
        nb = nbrs[cur]                                        # (B, W)
        nb_s = torch.clamp(nb, min=0).to(torch.int64)
        nd = torch.where(nb >= 0, _dists(doc_vecs, nb_s, q_vec),
                         torch.inf)
        j = torch.argmin(nd, dim=1, keepdim=True)
        best = nd.gather(1, j)[:, 0]
        better = best < d_cur
        cur = torch.where(better, nb_s.gather(1, j)[:, 0], cur)
        d_cur = torch.where(better, best, d_cur)
        SYNCS += 1
        if not bool(better.any()):
            return cur, d_cur


def _beam_level0(doc_vecs: Tensor, nbrs0: Tensor, q_vec: Tensor,
                 entry: Tensor, d_entry: Tensor, ef: int
                 ) -> Tuple[Tensor, Tensor]:
    """Bounded best-first beam on the base layer: ``ef`` expansion steps
    over a (B, ef) frontier, the visited set a (B, N) bitmask. Returns
    (dists (B, ef), ids (B, ef)) nearest first, ids -1 where fewer than
    ef nodes were reachable.

    Ranking is a stable ascending sort of the distances, the order of the
    reference's ``lax.top_k(-d, ef)``. The visited update follows the
    reference's scatter too: there a row's empty slots (-1) write node 0's
    old bit last, so node 0 is marked visited only by a full row."""
    b = q_vec.shape[0]
    n = doc_vecs.shape[0]
    dev = q_vec.device
    rows = torch.arange(b, device=dev)
    ids = torch.full((b, ef), -1, dtype=torch.int64, device=dev)
    ids[:, 0] = entry
    ds = torch.full((b, ef), torch.inf, dtype=torch.float32, device=dev)
    ds[:, 0] = d_entry
    exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
    visited.scatter_(1, entry.to(torch.int64)[:, None], True)
    for _ in range(ef):
        open_d = torch.where(exp | (ids < 0), torch.inf, ds)
        best = torch.argmin(open_d, dim=1)
        has_open = torch.isfinite(open_d[rows, best])
        exp[rows, best] |= has_open
        node = torch.where(has_open, ids[rows, best], 0)
        nb = nbrs0[node]                                      # (B, W)
        nb_s = torch.clamp(nb, min=0).to(torch.int64)
        fresh = (nb >= 0) & has_open[:, None] & ~visited.gather(1, nb_s)
        nd = torch.where(fresh, _dists(doc_vecs, nb_s, q_vec), torch.inf)
        old0 = visited[:, 0].clone()
        visited.scatter_(1, nb_s, visited.gather(1, nb_s) | fresh)
        visited[:, 0] = torch.where((nb < 0).any(dim=1), old0,
                                    visited[:, 0])
        all_ids = torch.cat([ids, torch.where(fresh, nb_s, -1)], dim=1)
        all_ds = torch.cat([ds, nd], dim=1)
        all_exp = torch.cat([exp, torch.zeros_like(fresh)], dim=1)
        order = torch.sort(all_ds, dim=1, stable=True)[1][:, :ef]
        ids = all_ids.gather(1, order)
        ds = all_ds.gather(1, order)
        exp = all_exp.gather(1, order)
    return ds, ids.to(torch.int32)


def hnsw_candidates(index: HNSWIndex, q_vec: Tensor, *, ef_search: int
                    ) -> Tuple[Tensor, Tensor]:
    """Graph routing for query vectors (B, D) -> (dists, ids) (B, ef)."""
    b = q_vec.shape[0]
    cur = torch.full((b,), int(index.entry), dtype=torch.int64,
                     device=q_vec.device)
    d = _dists(index.doc_vecs, cur[:, None], q_vec)[:, 0]
    for lev in range(index.neighbors.shape[0] - 1, 0, -1):
        cur, d = _greedy_level(index.doc_vecs, index.neighbors[lev], q_vec,
                               cur, d)
    return _beam_level0(index.doc_vecs, index.neighbors[0], q_vec, cur, d,
                        ef_search)


def _score_candidates(index: HNSWIndex, q: Tensor, q_mask: Tensor,
                      cand: Tensor, valid: Tensor, k: int, scan
                      ) -> Tuple[Tensor, Tensor]:
    """The beam's survivors (B, ef) through the scan's per-query layout."""
    safe = torch.clamp(cand, min=0).to(torch.int64)
    codes = take_rows(index.codes, safe)                      # (B, ef, Md)
    mask = index.mask[safe] & valid[..., None]
    ids = torch.where(valid, index.doc_ids[safe], -1)
    return scan_mod.quantized_maxsim_topk(
        q, q_mask, codes, mask, index.codebook, k=k, doc_ids=ids,
        valid=valid, scan=scan)


def search_hnsw(index: HNSWIndex, q: Tensor, q_mask: Tensor, *,
                ef_search: int, k: int, scan=None) -> Tuple[Tensor, Tensor]:
    """Graph-route to ef_search candidates, score them, top-k -> (scores
    (B, k), doc_ids (B, k)). Rows beyond the reachable candidates (k >
    ef_search, or a small corpus) carry id -1 and the sentinel."""
    q_vec = mean_pool(q.to(index.doc_vecs.dtype), q_mask)
    _, cand = hnsw_candidates(index, q_vec, ef_search=ef_search)
    return _score_candidates(index, q, q_mask, cand, cand >= 0, k, scan)


# ---------------------------------------------------------------------------
# Incremental mutation (the one growable graph segment)
# ---------------------------------------------------------------------------
#
# HNSW keeps ONE capacity-padded segment: appends insert into the existing
# adjacency (the same host routine as the build), growing the tensors to
# the next pow2 capacity only when full. Tombstoned nodes stay in the graph
# as routable waypoints and are filtered at scoring time through the live
# mask (`search_hnsw_live`); `hnsw_compact` drops them by re-inserting the
# live nodes, with their stored level draws, into a fresh graph.

_INSERT_KEY = 0x5eed  # the level-draw stream of appends


def insert_generator(filled: int) -> torch.Generator:
    """The host generator of an append's level draws: a function of the
    graph's fill count alone, so one mutation history gives one graph."""
    return torch.Generator().manual_seed((_INSERT_KEY << 32) + int(filled))


def _grow_dim0(t: Tensor, cap: int, fill) -> Tensor:
    n = t.shape[0]
    if n == cap:
        return t.clone()
    pad = torch.full((cap - n,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad], dim=0)


def hnsw_insert(index: HNSWIndex, live: Tensor, codes: Tensor, mask: Tensor,
                doc_ids: Tensor, config: HNSWConfig,
                levels: Optional[np.ndarray] = None
                ) -> Tuple[HNSWIndex, Tensor]:
    """Append documents to an existing graph (no rebuild) on the host,
    as the build does. Their levels come from ``insert_generator`` of the
    fill count unless given. The tensors grow to the next pow2 capacity
    only when the padding is used up; padding rows have no in-edges, so
    the beam never reaches them. Returns the new (index, live): new rows
    live, old live bits kept. ``index`` is not modified."""
    n_new = int(codes.shape[0])
    dev = index.codes.device
    ids_np = index.doc_ids.cpu().numpy()
    filled = int((ids_np >= 0).sum())
    cap_now = int(ids_np.shape[0])
    cap = max(cap_now, segment_capacity(filled + n_new))
    if levels is None:
        levels = draw_levels(insert_generator(filled), n_new, config)
    new_vecs = doc_mean_vectors(codes, mask, index.codebook)

    x = np.zeros((cap, index.doc_vecs.shape[1]), np.float32)
    x[:cap_now] = index.doc_vecs.cpu().numpy()
    x[filled:filled + n_new] = new_vecs.to(torch.float32).cpu().numpy()
    nbrs = np.full((config.levels, cap, 2 * config.m), -1, np.int64)
    nbrs[:, :cap_now] = index.neighbors.cpu().numpy()
    lvl = np.full((cap,), -1, np.int64)
    lvl[:cap_now] = index.node_level.cpu().numpy()
    lvl[filled:filled + n_new] = levels
    entry = int(index.entry) if filled > 0 else -1
    top = int(lvl[entry]) if filled > 0 else -1
    entry, _ = _insert_np(x, nbrs, lvl, entry, top,
                          range(filled, filled + n_new),
                          config.ef_construction, config.m)

    doc_vecs, neighbors, node_level = _to_device(x, nbrs, lvl, dev)
    new = slice(filled, filled + n_new)
    out_codes = _grow_dim0(index.codes, cap, 0)
    out_codes[new] = codes.to(out_codes.dtype)
    out_mask = _grow_dim0(index.mask, cap, False)
    out_mask[new] = mask.to(torch.bool)
    out_ids = _grow_dim0(index.doc_ids, cap, -1)
    out_ids[new] = doc_ids.to(torch.int32)
    live_out = _grow_dim0(live.to(torch.bool), cap, False)
    live_out[new] = True
    return HNSWIndex(doc_vecs, neighbors, int(entry), node_level, out_codes,
                     out_mask, out_ids, index.codebook), live_out


def hnsw_compact(index: HNSWIndex, live: Tensor, config: HNSWConfig
                 ) -> Tuple[HNSWIndex, Tensor]:
    """Drop tombstones: re-insert the live nodes, with their stored level
    draws and in their order, into a fresh graph of pow2 capacity."""
    dev = index.codes.device
    keep_t = torch.nonzero(live.to(torch.bool).reshape(-1)
                           & (index.doc_ids >= 0)).squeeze(1)
    keep = keep_t.cpu().numpy()
    n_live = int(keep.size)
    cap = segment_capacity(n_live)
    x = np.zeros((cap, index.doc_vecs.shape[1]), np.float32)
    x[:n_live] = index.doc_vecs.cpu().numpy()[keep]
    lvl = np.full((cap,), -1, np.int64)
    lvl[:n_live] = index.node_level.cpu().numpy()[keep]
    nbrs = np.full((config.levels, cap, 2 * config.m), -1, np.int64)
    entry, _ = _insert_np(x, nbrs, lvl, -1, -1, range(n_live),
                          config.ef_construction, config.m)
    doc_vecs, neighbors, node_level = _to_device(x, nbrs, lvl, dev)
    out = HNSWIndex(doc_vecs, neighbors, max(int(entry), 0), node_level,
                    _grow_dim0(take_rows(index.codes, keep_t), cap, 0),
                    _grow_dim0(index.mask[keep_t], cap, False),
                    _grow_dim0(index.doc_ids[keep_t], cap, -1),
                    index.codebook)
    return out, torch.arange(cap, device=dev) < n_live


def search_hnsw_live(index: HNSWIndex, live: Tensor, q: Tensor,
                     q_mask: Tensor, *, ef_search: int, k: int, scan=None
                     ) -> Tuple[Tensor, Tensor]:
    """``search_hnsw`` with a tombstone mask: dead nodes still route the
    beam but are never scored (NEG_INF, id -1)."""
    q_vec = mean_pool(q.to(index.doc_vecs.dtype), q_mask)
    _, cand = hnsw_candidates(index, q_vec, ef_search=ef_search)
    safe = torch.clamp(cand, min=0).to(torch.int64)
    valid = (cand >= 0) & live[safe]
    return _score_candidates(index, q, q_mask, cand, valid, k, scan)

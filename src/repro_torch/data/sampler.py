"""GNN neighbour sampler (GraphSAGE-style fanout sampling, host-side numpy).

The reference's ``repro.data.sampler``, copied: given the same
``np.random.Generator`` it returns the reference's arrays exactly. It
stays on the host, as the reference keeps it; a batch reaches the card
through the prefetch pipeline.

Required by the pna `minibatch_lg` cell (Reddit-scale graph, batch_nodes=1024,
fanout 15-10): builds a CSR adjacency once, then per batch samples a 2-hop
subgraph with *static* output shapes (padded) so the train step's
shapes never change. Runs on the host thread of the data pipeline; numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (E,)
    feats: np.ndarray       # (N, d)
    labels: np.ndarray      # (N,)

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def build_csr(n_nodes: int, edge_index: np.ndarray, feats: np.ndarray,
              labels: np.ndarray) -> CSRGraph:
    src, dst = edge_index
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(src_s, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr, dst_s.astype(np.int32), feats, labels)


def sample_subgraph(rng: np.random.Generator, g: CSRGraph, seeds: np.ndarray,
                    fanouts: Tuple[int, ...]) -> Dict[str, np.ndarray]:
    """Fanout-sample a subgraph rooted at `seeds`.

    Returns statically-shaped arrays:
      feats      (n_max, d)    — local node features (padded w/ zeros)
      edge_index (2, e_max)    — local ids; padding edges point to node 0
                                 with src == dst == n_valid-slot (masked by
                                 label -1 so they only add zero messages)
      labels     (n_max,)      — -1 for non-seed / padding nodes
    with n_max = sum over hops of prod(fanouts[:h]) * len(seeds) and
    e_max = the matching edge budget. Deduplication keeps the first
    occurrence (standard GraphSAGE behaviour).
    """
    layer_nodes = [seeds.astype(np.int64)]
    edges_src, edges_dst = [], []
    frontier = seeds.astype(np.int64)
    for f in fanouts:
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        # sample f neighbours with replacement (degree 0 -> self loop)
        offs = (rng.random((frontier.shape[0], f))
                * np.maximum(deg, 1)[:, None]).astype(np.int64)
        nbrs = g.indices[np.minimum(g.indptr[frontier][:, None] + offs,
                                    len(g.indices) - 1)]
        nbrs = np.where(deg[:, None] > 0, nbrs, frontier[:, None])
        edges_src.append(nbrs.ravel())                    # neighbour -> node
        edges_dst.append(np.repeat(frontier, f))
        frontier = nbrs.ravel()
        layer_nodes.append(frontier)

    all_nodes = np.concatenate(layer_nodes)
    uniq, local = np.unique(all_nodes, return_inverse=True)
    # map global -> local
    lookup = {int(n): i for i, n in enumerate(uniq)}
    src = np.concatenate(edges_src)
    dst = np.concatenate(edges_dst)
    src_l = np.fromiter((lookup[int(x)] for x in src), np.int32, len(src))
    dst_l = np.fromiter((lookup[int(x)] for x in dst), np.int32, len(dst))

    # static budgets
    n_max = sum(len(x) for x in layer_nodes)
    e_max = len(src)
    feats = np.zeros((n_max, g.feats.shape[1]), g.feats.dtype)
    feats[:len(uniq)] = g.feats[uniq]
    labels = np.full((n_max,), -1, np.int32)
    seed_local = np.fromiter((lookup[int(s)] for s in seeds), np.int32,
                             len(seeds))
    labels[seed_local] = g.labels[seeds]
    edge_index = np.stack([src_l, dst_l]).astype(np.int32)
    return {"feats": feats, "edge_index": edge_index, "labels": labels}

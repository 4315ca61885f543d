"""Config schema: architectures x input-shape cells.

The reference's ``repro.configs.base``, copied (it imports no JAX).

Every assigned architecture provides an ArchSpec with its exact public
config, a reduced smoke config (same family, small dims) for CPU tests,
and its assigned shape cells. launch/cells.py turns (ArchSpec, ShapeCell)
into a concrete (step_fn, input ShapeDtypeStructs, shardings) triple for
the dry-run, and the smoke tests run the same step functions on the smoke
config with tiny concrete batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                    # train | prefill | decode | serve | candidates
    dims: Dict[str, int]         # seq_len / global_batch / n_nodes / ...
    skip: Optional[str] = None   # reason if this cell is skipped (DESIGN §6)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | colpali | gnn | recsys
    config: Any                  # full production config
    smoke_config: Any            # reduced config (CPU tests)
    shapes: Tuple[ShapeCell, ...]
    source: str = ""             # [citation; verification tier]
    notes: str = ""


# Shared LM shape cells (assignment block). long_500k is overridden
# per-arch: only sub-quadratic archs run it.
def lm_shapes(long_skip: Optional[str]) -> Tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_4k", "train",
                  {"seq_len": 4096, "global_batch": 256}),
        ShapeCell("prefill_32k", "prefill",
                  {"seq_len": 32768, "global_batch": 32}),
        ShapeCell("decode_32k", "decode",
                  {"seq_len": 32768, "global_batch": 128}),
        ShapeCell("long_500k", "decode",
                  {"seq_len": 524288, "global_batch": 1}, skip=long_skip),
    )


GNN_SHAPES = (
    # edge counts padded to a multiple of 4096 with phantom-node edges and
    # node counts padded to a multiple of 512 so both dims shard on every
    # mesh (docs/design.md §6); padding nodes are isolated and labelled -1.
    ShapeCell("full_graph_sm", "train",
              {"n_nodes": 3072, "n_edges": 12288, "d_feat": 1433,
               "n_classes": 7, "real_edges": 10556}),
    ShapeCell("minibatch_lg", "train",
              {"n_nodes": 170496, "n_edges": 172032, "d_feat": 602,
               "n_classes": 41, "real_edges": 168960,
               "graph_nodes": 232965, "graph_edges": 114615892,
               "batch_nodes": 1024, "fanout": (15, 10)}),
    ShapeCell("ogb_products", "train",
              {"n_nodes": 2449408, "n_edges": 61865984, "d_feat": 100,
               "n_classes": 47, "real_edges": 61859140}),
    ShapeCell("molecule", "train",
              {"n_graphs": 128, "nodes_per": 30, "edges_per": 64,
               "n_nodes": 3840, "n_edges": 8192, "d_feat": 28,
               "n_classes": 2}),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "candidates",
              {"batch": 1, "n_candidates": 1_000_000}),
)

"""PNA — Principal Neighbourhood Aggregation GNN (arXiv:2004.05718).

The counterpart of ``repro.models.gnn``. A PNA layer:

    m_e   = MLP_pre([h_src, h_dst])                  per edge
    agg_a = segment_{mean,max,min,std}(m_e -> dst)   4 aggregators
    scaled= agg_a * {1, log(d+1)/delta, delta/log(d+1)}   3 scalers
    h'    = h + relu(MLP_post([h, concat_{a,s} scaled]))  residual update

for node classification (full graph or a sampled subgraph) and batched
small-graph property prediction (mean readout per graph id).
``PNAConfig`` is the reference's, copied. ``PNAModel`` holds the weights
named as the reference's tree (``encoder.0.w``, ``layers.<i>.pre.0.w``,
``layers.<i>.post.0.b``, ``head.0.w``); the functions take them as a dict
of named tensors.

The segment reductions are ``layers.segment_reduce``: ``index_add`` for
the sums and ``scatter_reduce`` for max and min. An empty segment (an
isolated node) aggregates to 0, as the reference's ``where(isfinite)``
makes it. On the card the sums are float atomics, so their order, and the
last bits of the aggregates, change from run to run: the port matches the
reference within a tolerance, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import NULL, local_partial
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import segment_reduce, take_rows
from repro_torch.optim import optimizer as opt

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_feat: int = 1433
    n_classes: int = 7
    delta: float = 2.5              # avg log-degree normaliser (PNA eq. 5)
    task: str = "node"              # "node" | "graph"
    param_dtype: str = "float32"

    @property
    def pdtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)

    def param_count(self) -> int:
        d = self.d_hidden
        per_layer = (2 * d) * d + (d + 12 * d) * d + d * d
        return self.d_feat * d + self.n_layers * per_layer + d * self.n_classes


class PNALayer(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.pre = L.mlp((2 * d, d), dtype, device)
        self.post = L.mlp((13 * d, d), dtype, device)   # h + 12 aggregates


class PNAModel(nn.Module):
    """PNA's weights, named as the reference's tree."""

    def __init__(self, cfg: PNAConfig, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, dt = cfg.d_hidden, cfg.pdtype
        self.encoder = L.mlp((cfg.d_feat, d), dt, dev)
        self.layers = nn.ModuleList(PNALayer(d, dt, dev)
                                    for _ in range(cfg.n_layers))
        self.head = L.mlp((d, cfg.n_classes), dt, dev)


def init(cfg: PNAConfig, *, generator: torch.Generator, device="cuda"
         ) -> PNAModel:
    """A model with weights drawn from ``generator`` (on ``device``):
    normal / sqrt(in), biases zero."""
    return L.draw_dense(PNAModel(cfg, device=device), generator)


def _pna_aggregate(msgs: Tensor, dst: Tensor, n_nodes: int, deg: Tensor,
                   delta: float) -> Tensor:
    """msgs (E, d), dst (E,) -> (N, 12*d) [4 aggregators x 3 scalers]."""
    ones = (torch.ones_like(dst, dtype=msgs.dtype)
            if isinstance(dst, DTensor) else
            torch.ones((msgs.shape[0],), dtype=msgs.dtype,
                       device=msgs.device))
    cnt = torch.clamp(segment_reduce(ones, dst, n_nodes), min=1.0)[:, None]
    mean = segment_reduce(msgs, dst, n_nodes) / cnt
    sq = segment_reduce(msgs * msgs, dst, n_nodes)
    std = torch.sqrt(torch.clamp(sq / cnt - mean * mean, min=0.0) + 1e-5)
    mx = segment_reduce(msgs, dst, n_nodes, "amax")
    mn = segment_reduce(msgs, dst, n_nodes, "amin")
    agg = torch.cat([mean, mx, mn, std], dim=-1)          # (N, 4d)

    logd = torch.log(deg + 1.0)[:, None]
    amp = logd / delta
    att = delta / torch.clamp(logd, min=1e-5)
    return torch.cat([agg, agg * amp, agg * att], dim=-1)  # (N, 12d)


def param_specs(cfg: PNAConfig) -> Dict[str, tuple]:
    """Logical specs of every parameter, keyed as ``params_of``: every
    weight replicated, as the reference's."""
    s = {}
    for name in (["encoder", "head"]
                 + [f"layers.{i}.{m}" for i in range(cfg.n_layers)
                    for m in ("pre", "post")]):
        s.update({f"{name}.0.w": (None, None), f"{name}.0.b": (None,)})
    return s


def batch_specs(batch: Dict[str, Tensor]) -> Dict[str, tuple]:
    """Logical specs of a PNA batch: node rows on "nodes", the edge list's
    edges on "edge"; a graph batch's graph labels replicated."""
    specs = {"feats": ("nodes", None), "edge_index": (None, "edge"),
             "labels": ("nodes",), "graph_ids": ("nodes",),
             "graph_labels": (None,)}
    return {k: specs[k] for k in batch}


def _node_rows(h: Tensor, idx: Tensor) -> Tensor:
    """``take_rows(h, idx)``; with node-sharded h and edge-sharded idx the
    per-rank program: h gathered whole (its gradient summed back to each
    node's rank), each rank reading the rows of its own edges."""
    if not isinstance(h, DTensor):
        return take_rows(h, idx)
    mesh = h.device_mesh
    whole = h.redistribute(mesh, [Replicate()] * mesh.ndim)
    spread = [i for i, p in enumerate(idx.placements)
              if isinstance(p, Shard)]
    rows = take_rows(local_partial(whole, spread), idx.to_local())
    return L.from_local_rows(rows, mesh, idx.placements, idx.shape[0])


@L.float32_accumulation()
def forward(params: Dict[str, Tensor], feats: Tensor, edge_index: Tensor,
            cfg: PNAConfig, graph_ids: Optional[Tensor] = None,
            n_graphs: int = 0, shd=NULL) -> Tensor:
    """feats (N, d_feat), edge_index (2, E) -> float32 logits: (N,
    n_classes) for the node task, (n_graphs, n_classes) for the graph
    task (mean readout over ``graph_ids``). ``shd`` puts node tensors on
    "nodes" and gathered edge tensors on "edge", as the reference does;
    on a mesh each aggregation is partial on every rank and all-reduced
    (``layers.segment_reduce``)."""
    with shd.scope():
        return _forward(params, feats, edge_index, cfg, graph_ids, n_graphs,
                        shd)


def _forward(params, feats, edge_index, cfg, graph_ids, n_graphs, shd):
    """``forward``'s body, inside the sharder's scope."""
    n = feats.shape[0]
    src, dst = edge_index[0], edge_index[1]
    h = L.mlp_apply(params, "encoder", feats.to(cfg.pdtype))
    h = shd.constraint(h, "nodes", None)
    ones = (torch.ones_like(dst, dtype=h.dtype)
            if isinstance(dst, DTensor) else
            torch.ones(src.shape, dtype=h.dtype, device=h.device))
    deg = segment_reduce(ones, dst, n)
    for i in range(cfg.n_layers):
        h_src = shd.constraint(_node_rows(h, src), "edge", None)
        h_dst = shd.constraint(_node_rows(h, dst), "edge", None)
        pair = torch.cat([h_src, h_dst], dim=-1)
        msgs = shd.constraint(L.mlp_apply(params, f"layers.{i}.pre", pair),
                              "edge", None)
        agg = shd.constraint(_pna_aggregate(msgs, dst, n, deg, cfg.delta),
                             "nodes", None)
        upd = L.mlp_apply(params, f"layers.{i}.post",
                          torch.cat([h, agg], dim=-1))
        h = shd.constraint(h + torch.relu(upd), "nodes", None)

    if cfg.task == "graph":
        if graph_ids is None or n_graphs <= 0:
            raise ValueError("the graph task needs graph_ids and n_graphs")
        pooled = segment_reduce(h, graph_ids, n_graphs)
        ones = (torch.ones_like(graph_ids, dtype=h.dtype)
                if isinstance(graph_ids, DTensor) else
                torch.ones((n,), dtype=h.dtype, device=h.device))
        cnt = torch.clamp(segment_reduce(ones, graph_ids, n_graphs), min=1.0)
        h = pooled / cnt[:, None]
    return L.mlp_apply(params, "head", h).to(torch.float32)


def _batch_forward(params, batch: Dict[str, Tensor], cfg: PNAConfig,
                   shd=NULL) -> Tensor:
    graph = "graph_labels" in batch
    return forward(params, batch["feats"], batch["edge_index"], cfg,
                   graph_ids=batch.get("graph_ids"),
                   n_graphs=int(batch["graph_labels"].shape[0]) if graph
                   else 0, shd=shd)


def loss_fn(params, batch: Dict[str, Tensor], cfg: PNAConfig, shd=NULL
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Cross-entropy on the labelled nodes (label -1 = unlabelled or
    padding) or graphs, and the accuracy over them."""
    logits = _batch_forward(params, batch, cfg, shd)
    labels = (batch["graph_labels"] if "graph_labels" in batch
              else batch["labels"]).to(torch.int64)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[:, None])[:, 0]
    ce = torch.where(valid, logz - gold, 0.0)
    n_valid = torch.clamp(valid.sum(), min=1)
    loss = ce.sum() / n_valid
    hit = valid & (torch.argmax(logits, dim=-1) == labels)
    return loss, {"acc": hit.sum() / n_valid}


def train_step(params: Dict[str, Tensor], opt_state: opt.AdamWState,
               batch: Dict[str, Tensor], cfg: PNAConfig,
               opt_cfg: opt.AdamWConfig, shd=NULL):
    """(params, opt_state, batch) -> (params, opt_state, metrics {loss,
    acc, lr, grad_norm})."""
    with shd.scope():
        loss, parts, grads = T.value_and_grad(
            lambda p: loss_fn(p, batch, cfg, shd), params)
        params, opt_state, om = opt.update(opt_cfg, grads, opt_state,
                                           params)
    return params, opt_state, {"loss": loss, **parts, **om}


@torch.no_grad()
def serve_step(params, batch: Dict[str, Tensor], cfg: PNAConfig,
               shd=NULL) -> Tensor:
    """Inference forward (full-batch scoring): the logits."""
    return _batch_forward(params, batch, cfg, shd)

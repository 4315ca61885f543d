"""RecSys models: DLRM (MLPerf), DCN-v2, DIN, DIEN.

The counterpart of ``repro.models.recsys``. ``RecsysConfig`` is the
reference's, copied (without ``unroll``, the reference's scan-unrolling
switch for its cost analysis). ``RecsysModel`` holds the weights as named
parameters laid out as the reference's tree: ``tables.<i>`` (rows, dim),
the MLPs' ``<mlp>.<i>.w``/``.b`` (``bot``/``top`` for DLRM,
``cross``/``deep``/``out`` for DCN, ``attn``/``mlp`` for DIN and DIEN),
and DIEN's ``gru1``/``augru`` (``wx``, ``wh``, ``b``); the functions take
those tensors as a dict (``transformer.params_of``), as the reference's
take its param tree.

  * Lookups follow ``jnp.take``'s fill rule (``layers.take_rows``): an id
    in [-rows, -1] wraps, any other id outside the table reads a row of
    NaN (floats), the type's minimum (signed ints) or maximum (unsigned
    ints); a CUDA gather never sees an id outside the table.
  * Table gradients are dense (rows, dim), as ``jax.grad`` gives them, and
    AdamW decays every row.
  * DLRM's interaction multiplies in float32 (bf16 values widen exactly),
    gathers the upper triangle in ``jnp.triu_indices``' row-major order
    and only then casts to the param dtype, as the reference's
    ``preferred_element_type=float32`` product does.
  * ``quantize_tables`` is the paper's transfer to embedding storage: each
    table K-means-compressed to 1-byte codes and a (K, dim) codebook, the
    codes assigned by ``core.quantization.quantize`` (the ``kmeans_assign``
    CUDA kernel for CUDA tensors). DIN's ``din_prune_p`` keeps the top-p%
    most attended history items (``core.pruning.prune_topp``), the paper's
    attention-guided pruning applied to a user's behaviour history.
  * DIEN's two ``lax.scan``s are explicit loops over the sequence.
  * ``score_candidates`` scores one user against N candidates in one
    batched pass (the user's features broadcast).

The products are plain ``torch.matmul``, as the reference keeps them
outside Pallas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.core import pruning as core_pruning
from repro_torch.core import quantization as quant
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import segment_reduce, take_rows
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt

Tensor = torch.Tensor
NEG_INF = -1e30
_INIT_CHUNK_ROWS = 1 << 22      # bounds the float32 draw of a large table


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------

def embedding_bag(table: Tensor, values: Tensor, segment_ids: Tensor,
                  num_segments: int, mode: str = "sum") -> Tensor:
    """EmbeddingBag: the rows at ``values`` (flat multi-hot ids) summed
    into ``num_segments`` bags by ``segment_ids``; ``mode`` "mean" divides
    each bag by max(its count, 1)."""
    out = segment_reduce(take_rows(table, values), segment_ids,
                         num_segments)
    if mode == "mean":
        cnt = segment_reduce(torch.ones(values.shape, dtype=out.dtype,
                                        device=out.device),
                             segment_ids, num_segments)
        out = out / torch.clamp(cnt[:, None], min=1.0)
    return out


def lookup(tables: List[Tensor], ids: Tensor) -> Tensor:
    """Single-hot lookup: ids (B, n_fields) -> (B, n_fields, dim)."""
    return torch.stack([take_rows(t, ids[:, i]) for i, t in
                        enumerate(tables)], dim=1)


# --- paper transfer: K-Means-quantized tables ------------------------------

def quantize_tables(generator: torch.Generator, tables: List[Tensor],
                    k: int = 256, iters: int = 10, restarts: int = 2
                    ) -> Dict[str, List[Tensor]]:
    """Compress each table to (codes uint8 (rows,), codebook (K, dim)):
    a K-means fit of min(k, rows) centroids, then the codes through
    ``quant.quantize`` (the ``kmeans_assign`` kernel on the card). The
    tables are fitted in order from one generator."""
    out = {"codes": [], "codebooks": []}
    for t in tables:
        cb, _ = quant.kmeans_fit(generator, t, quant.KMeansConfig(
            k=min(k, t.shape[0]), iters=iters, n_restarts=restarts))
        out["codes"].append(quant.quantize(t, cb))
        out["codebooks"].append(cb)
    return out


def quantized_lookup(qtables: Dict[str, List[Tensor]], ids: Tensor
                     ) -> Tensor:
    """Decode-on-lookup: each field's code, then its codebook row ->
    (B, n_fields, dim). An id outside a table reads code 255 (uint8's
    fill), as ``jnp.take`` does."""
    return torch.stack([
        take_rows(cb, take_rows(codes, ids[:, i]).to(torch.int32))
        for i, (codes, cb) in enumerate(zip(qtables["codes"],
                                            qtables["codebooks"]))], dim=1)


def tables_nbytes(tables: List[Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tables)


def qtables_nbytes(qt: Dict[str, List[Tensor]]) -> int:
    return (sum(c.numel() for c in qt["codes"])
            + sum(cb.numel() * cb.element_size() for cb in qt["codebooks"]))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "dlrm"
    family: str = "dlrm"            # dlrm | dcn | din | dien
    n_dense: int = 13
    table_rows: Tuple[int, ...] = ()
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    n_cross_layers: int = 0          # dcn-v2
    # din/dien
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    gru_dim: int = 0                 # dien
    din_prune_p: float = 0.0         # paper transfer: history pruning (0=off)
    param_dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.table_rows)

    @property
    def pdtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)

    def param_count(self) -> int:
        return sum(self.table_rows) * self.embed_dim  # MLPs are negligible


def _mlp_dims(cfg: RecsysConfig) -> Dict[str, Tuple[int, ...]]:
    """Each MLP's widths, by its name in the reference's tree."""
    d = cfg.embed_dim
    if cfg.family == "dlrm":
        n_vec = cfg.n_sparse + 1
        return {"bot": (cfg.n_dense,) + cfg.bot_mlp,
                "top": (n_vec * (n_vec - 1) // 2 + d,) + cfg.top_mlp}
    if cfg.family == "dcn":
        return {"deep": (_dcn_width(cfg),) + cfg.top_mlp,
                "out": (cfg.top_mlp[-1], 1)}
    if cfg.family == "din":
        return {"attn": (4 * d,) + cfg.attn_mlp + (1,),
                "mlp": (3 * d,) + cfg.top_mlp + (1,)}
    g = cfg.gru_dim
    return {"attn": (g + d,) + cfg.attn_mlp + (1,),
            "mlp": (g + 2 * d,) + cfg.top_mlp + (1,)}


def _dcn_width(cfg: RecsysConfig) -> int:
    return cfg.n_sparse * cfg.embed_dim + cfg.n_dense


class GRU(nn.Module):
    """A GRU cell's weights: ``wx`` (d_in, 3h), ``wh`` (h, 3h), ``b``
    (3h,), the gates in the order r, z, n."""

    def __init__(self, d_in: int, d_h: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.wx = nn.Parameter(torch.empty((d_in, 3 * d_h), dtype=dtype,
                                           device=device))
        self.wh = nn.Parameter(torch.empty((d_h, 3 * d_h), dtype=dtype,
                                           device=device))
        self.b = nn.Parameter(torch.zeros((3 * d_h,), dtype=dtype,
                                          device=device))


class RecsysModel(nn.Module):
    """The weights of one recsys family, named as the reference's tree."""

    def __init__(self, cfg: RecsysConfig, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dt = cfg.pdtype
        self.tables = nn.ParameterList(
            nn.Parameter(torch.empty((r, cfg.embed_dim), dtype=dt,
                                     device=dev)) for r in cfg.table_rows)
        if cfg.family == "dcn":
            d0 = _dcn_width(cfg)
            self.cross = nn.ModuleList(L.Dense(d0, d0, dt, dev)
                                       for _ in range(cfg.n_cross_layers))
        if cfg.family == "dien":
            d, g = cfg.embed_dim, cfg.gru_dim
            self.gru1 = GRU(d, g, dt, dev)
            self.augru = GRU(g, g, dt, dev)
        for name, dims in _mlp_dims(cfg).items():
            setattr(self, name, L.mlp(dims, dt, dev))


def init(cfg: RecsysConfig, *, generator: torch.Generator, device="cuda"
         ) -> RecsysModel:
    """A model with weights drawn from ``generator`` (on ``device``) by the
    reference's distributions: tables normal / sqrt(dim), weights normal /
    sqrt(in), biases zero."""
    model = RecsysModel(cfg, device=device)
    with torch.no_grad():
        for t in model.tables:
            for r0 in range(0, t.shape[0], _INIT_CHUNK_ROWS):
                part = t[r0:r0 + _INIT_CHUNK_ROWS]
                w = torch.randn(part.shape, generator=generator,
                                device=generator.device)
                part.copy_(w.mul_(1.0 / math.sqrt(cfg.embed_dim)))
        for mod in model.modules():
            if isinstance(mod, GRU):
                for w in (mod.wx, mod.wh):
                    w.copy_(L.dense_init(generator, *w.shape, w.dtype))
    return L.draw_dense(model, generator)


def tables_of(params: Dict[str, Tensor], cfg: RecsysConfig) -> List[Tensor]:
    return [params[f"tables.{i}"] for i in range(cfg.n_sparse)]


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------

def _dot_interact(x: Tensor, emb: Tensor) -> Tensor:
    """[x; emb] (B, F, d) -> the upper-triangle pairwise dots (B,
    F(F-1)/2) in float32: the vectors widened into one float32 buffer
    (no float32 copy of ``emb`` beside it, and ``emb`` released once
    copied when the caller holds no other reference), multiplied, then
    gathered."""
    b, f, d = emb.shape[0], emb.shape[1] + 1, emb.shape[2]
    dev = emb.device
    vecs = torch.empty((b, f, d), dtype=torch.float32, device=dev)
    vecs[:, 0] = x
    vecs[:, 1:] = emb
    del emb
    g = torch.bmm(vecs, vecs.transpose(1, 2))
    iu, ju = torch.triu_indices(f, f, 1, device=dev)
    return g[:, iu, ju]


def dlrm_forward(params, dense: Tensor, sparse_ids: Tensor,
                 cfg: RecsysConfig) -> Tensor:
    x = L.mlp_apply(params, "bot", dense.to(cfg.pdtype), final_act=True)
    inter = _dot_interact(x, lookup(tables_of(params, cfg),
                                    sparse_ids)).to(cfg.pdtype)
    top_in = torch.cat([x, inter], dim=-1)
    return L.mlp_apply(params, "top", top_in)[:, 0].to(torch.float32)


# ---------------------------------------------------------------------------
# DCN-v2 (stacked: cross network then deep)
# ---------------------------------------------------------------------------

def dcn_forward(params, dense: Tensor, sparse_ids: Tensor,
                cfg: RecsysConfig) -> Tensor:
    emb = lookup(tables_of(params, cfg), sparse_ids)       # (B, F, d)
    x0 = torch.cat([emb.reshape(emb.shape[0], -1), dense.to(cfg.pdtype)],
                   dim=-1)
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * (x @ params[f"cross.{i}.w"] + params[f"cross.{i}.b"]) + x
    h = L.mlp_apply(params, "deep", x, final_act=True)
    return L.mlp_apply(params, "out", h)[:, 0].to(torch.float32)


# ---------------------------------------------------------------------------
# DIN (target attention over user history)
# ---------------------------------------------------------------------------

def din_attention(params, hist_e: Tensor, target_e: Tensor,
                  hist_mask: Tensor, cfg: RecsysConfig
                  ) -> Tuple[Tensor, Tensor]:
    """Target attention. hist_e (B, S, d), target_e (B, d) ->
    (user_vec (B, d), attn_weights (B, S))."""
    t = target_e[:, None, :].expand_as(hist_e)
    feat = torch.cat([hist_e, t, hist_e - t, hist_e * t], dim=-1)
    logits = L.mlp_apply(params, "attn", feat)[..., 0]    # (B, S)
    mask = hist_mask.to(torch.bool)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits.to(torch.float32), dim=-1)
    w = torch.where(mask, w, 0.0)
    if cfg.din_prune_p > 0:
        # the top-p% most attended items, their weights renormalised
        pr = core_pruning.prune_topp(hist_e, w, mask, p=cfg.din_prune_p)
        w_kept = torch.take_along_dim(w, pr.indices.long(), dim=-1) * pr.mask
        w_kept = w_kept / torch.clamp(w_kept.sum(-1, keepdim=True),
                                      min=1e-9)
        user = torch.einsum("bs,bsd->bd", w_kept.to(hist_e.dtype),
                            pr.embeddings)
    else:
        user = torch.einsum("bs,bsd->bd", w.to(hist_e.dtype), hist_e)
    return user, w


def din_forward(params, hist_ids: Tensor, hist_mask: Tensor,
                target_ids: Tensor, cfg: RecsysConfig) -> Tensor:
    """hist_ids (B, S), target_ids (B,) -> logits (B,)."""
    table = params["tables.0"]
    hist_e = take_rows(table, hist_ids)                   # (B, S, d)
    target_e = take_rows(table, target_ids)               # (B, d)
    user, _ = din_attention(params, hist_e, target_e, hist_mask, cfg)
    feat = torch.cat([user, target_e, user * target_e], dim=-1)
    return L.mlp_apply(params, "mlp", feat)[:, 0].to(torch.float32)


# ---------------------------------------------------------------------------
# DIEN (GRU interest extraction + AUGRU interest evolution)
# ---------------------------------------------------------------------------

def gru_cell(params, prefix: str, h: Tensor, x: Tensor, att=None) -> Tensor:
    """One GRU step of the cell ``prefix``; ``att`` (B, 1) gates the update
    gate (AUGRU). n's pre-activation is recomputed from the weights' last
    third beside the fused gates, as the reference computes it."""
    wx, wh, b = (params[f"{prefix}.{k}"] for k in ("wx", "wh", "b"))
    gates = x @ wx + h @ wh + b
    dh = h.shape[-1]
    r = torch.sigmoid(gates[:, :dh])
    z = torch.sigmoid(gates[:, dh:2 * dh])
    n = torch.tanh(x @ wx[:, 2 * dh:] + r * (h @ wh[:, 2 * dh:])
                   + b[2 * dh:])
    if att is not None:
        z = z * att
    return (1 - z) * h + z * n


def dien_forward(params, hist_ids: Tensor, hist_mask: Tensor,
                 target_ids: Tensor, cfg: RecsysConfig) -> Tensor:
    table = params["tables.0"]
    hist_e = take_rows(table, hist_ids)                   # (B, S, d)
    target_e = take_rows(table, target_ids)               # (B, d)
    b, s, d = hist_e.shape
    keep = (hist_mask.to(hist_e.dtype) > 0)[..., None]    # (B, S, 1)

    # interest extraction GRU over the history
    h = torch.zeros((b, cfg.gru_dim), dtype=hist_e.dtype,
                    device=hist_e.device)
    states = []
    for i in range(s):
        h = torch.where(keep[:, i], gru_cell(params, "gru1", h,
                                             hist_e[:, i]), h)
        states.append(h)
    states = torch.stack(states, dim=1)                   # (B, S, g)

    # attention of the target on the interest states
    t = target_e[:, None, :].expand(b, s, d)
    alog = L.mlp_apply(params, "attn", torch.cat([states, t], -1))[..., 0]
    alog = torch.where(hist_mask.to(torch.bool), alog, NEG_INF)
    att = torch.softmax(alog.to(torch.float32), -1).to(hist_e.dtype)

    # AUGRU interest evolution
    h = torch.zeros((b, cfg.gru_dim), dtype=hist_e.dtype,
                    device=hist_e.device)
    for i in range(s):
        h = torch.where(keep[:, i], gru_cell(params, "augru", h,
                                             states[:, i], att[:, i, None]),
                        h)

    hist_mean = torch.mean(hist_e * keep.to(hist_e.dtype), dim=1)
    feat = torch.cat([h, target_e, hist_mean], dim=-1)
    return L.mlp_apply(params, "mlp", feat)[:, 0].to(torch.float32)


# ---------------------------------------------------------------------------
# Unified API
# ---------------------------------------------------------------------------

@L.float32_accumulation()
def forward(params: Dict[str, Tensor], batch: Dict[str, Tensor],
            cfg: RecsysConfig) -> Tensor:
    """Logits (B,) float32 of the family's batch: ``dense`` and
    ``sparse_ids`` (dlrm, dcn) or ``hist_ids``, ``hist_mask`` and
    ``target_ids`` (din, dien)."""
    if cfg.family == "dlrm":
        return dlrm_forward(params, batch["dense"], batch["sparse_ids"], cfg)
    if cfg.family == "dcn":
        return dcn_forward(params, batch["dense"], batch["sparse_ids"], cfg)
    fwd = din_forward if cfg.family == "din" else dien_forward
    return fwd(params, batch["hist_ids"], batch["hist_mask"],
               batch["target_ids"], cfg)


def loss_fn(params, batch, cfg: RecsysConfig
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean binary cross-entropy with logits (the stable form) and the
    accuracy of ``logits > 0``."""
    logits = forward(params, batch, cfg)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"acc": acc}


def train_step(params: Dict[str, Tensor], opt_state: opt.AdamWState,
               batch: Dict[str, Tensor], cfg: RecsysConfig,
               opt_cfg: opt.AdamWConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics {loss,
    acc, lr, grad_norm}): dense grads of every table, then AdamW."""
    loss, parts, grads = T.value_and_grad(
        lambda p: loss_fn(p, batch, cfg), params)
    params, opt_state, om = opt.update(opt_cfg, grads, opt_state, params)
    return params, opt_state, {"loss": loss, **parts, **om}


@torch.no_grad()
def serve_step(params, batch, cfg: RecsysConfig) -> Tensor:
    """Click probabilities (B,)."""
    return torch.sigmoid(forward(params, batch, cfg))


@torch.no_grad()
def score_candidates(params, batch: Dict[str, Tensor],
                     candidate_ids: Tensor, cfg: RecsysConfig) -> Tensor:
    """The retrieval_cand shape: one user (``batch`` of batch 1) against N
    candidates in one batched pass -> logits (N,). DIN and DIEN take the
    candidates as targets of the user's broadcast history; DLRM and DCN
    write each candidate id into the last sparse field (the item slot)."""
    n = candidate_ids.shape[0]
    if cfg.family in ("din", "dien"):
        cb = {"hist_ids": batch["hist_ids"].expand(n, cfg.seq_len),
              "hist_mask": batch["hist_mask"].expand(n, cfg.seq_len),
              "target_ids": candidate_ids}
    else:
        sparse = batch["sparse_ids"].expand(n, cfg.n_sparse).clone()
        sparse[:, -1] = candidate_ids
        cb = {"dense": batch["dense"].expand(n, cfg.n_dense),
              "sparse_ids": sparse}
    return forward(params, cb, cfg)

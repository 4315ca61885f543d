"""Shared model building blocks: init, RMSNorm, RoPE, GQA attention with
the per-key attention mass (full or chunked-local), the SwiGLU FFN, the
MoE FFN, and for the recsys and GNN families the plain MLPs, ``jnp.take``'s
gather (``take_rows``) and the segment reductions.

The counterpart of ``repro.models.layers``. The same conventions:

  * weights are stored (in, out) in the param dtype and cast to the
    activation dtype at each product; norms, attention scores and softmax
    run in float32;
  * attention is causal GQA with RoPE, query head ``h`` reading kv head
    ``h // (n_heads // n_kv)`` (the reference's ``(n_kv, g)`` split of the
    head axis), over query blocks of ``q_chunk`` so a score block is at
    most (B, H, q_chunk, S);
  * the scores are float32 products: bf16 q and k are widened first, which
    is exact (bf16 values are float32 values), so the product is the
    reference's ``preferred_element_type=float32`` one;
  * chunked-local attention (Llama-4's iRoPE layers) attends only within
    a fixed window: query i sees keys [floor(i/chunk)*chunk, i];
  * the MoE FFN routes each token to its top-k experts, sorts the
    assignments by expert, fills each expert's ``capacity`` slots in token
    order and drops the rest (Switch-style), runs the experts as batched
    products over (E, C, D) buffers and adds the gated outputs back in
    the sorted order, then returns the load-balance aux loss.

The attention and the MoE are plain PyTorch, as the reference keeps them
outside Pallas: the last layer's probabilities give the salience, which
``scaled_dot_product_attention`` does not return, and the reference's
router, dispatch and expert products are einsums and gathers.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
NEG_INF = -1e30


@contextlib.contextmanager
def float32_accumulation():
    """bf16 products on the card accumulate in float32, as the reference's
    do, for the duration of the block; then PyTorch's flag is restored.

    PyTorch lets cuBLAS reduce bf16 products in bf16 by default
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``),
    which would make the models' numbers depend on the caller's setting.
    The models' entry points (``Transformer.forward``/``logits``,
    ``prefill``, ``decode_step``, ``ColPaliEncoder.encode_doc``/
    ``encode_query``, ``recsys.forward``, ``gnn.forward``) run under this,
    and the train steps (every one through ``transformer.value_and_grad``)
    hold it across
    the forward, the backward and every checkpoint recompute inside it;
    the flag is process-wide, so a matmul on another thread during the
    call (autograd's own workers included) sees it cleared too. Also a
    decorator. Float32 products (float32 activations) follow PyTorch's
    TF32 setting, which is off by default."""
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = saved


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> Tensor:
    """(in_dim, out_dim) weights, normal x 1/sqrt(in_dim), drawn in float32
    on the generator's device and cast to ``dtype``."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> Tensor:
    """(vocab, dim) embedding table, normal x 0.02."""
    w = torch.randn((vocab, dim), generator=gen, device=gen.device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-5) -> Tensor:
    """RMSNorm computed in float32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (..., S, H, hd), positions (..., S) -> x rotated by split halves,
    the angles in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """The projections of one GQA attention layer: ``wq``, ``wk``, ``wv``,
    ``wo`` (in, out) and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 qkv_bias: bool, dtype: torch.dtype, device: torch.device):
        super().__init__()
        q_out, kv_out = n_heads * head_dim, n_kv * head_dim

        def param(*shape, fill=None):
            t = torch.empty(shape, dtype=dtype, device=device)
            if fill is not None:
                t.fill_(fill)
            return nn.Parameter(t)

        self.wq = param(d_model, q_out)
        self.wk = param(d_model, kv_out)
        self.wv = param(d_model, kv_out)
        self.wo = param(q_out, d_model)
        if qkv_bias:
            self.bq = param(q_out, fill=0.0)
            self.bk = param(kv_out, fill=0.0)
            self.bv = param(kv_out, fill=0.0)
        else:
            self.bq = self.bk = self.bv = None


def _qkv(p: Attention, x: Tensor, n_heads: int, n_kv: int, head_dim: int
         ) -> Tuple[Tensor, Tensor, Tensor]:
    b, s, _ = x.shape
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if p.bq is not None:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    return (q.view(b, s, n_heads, head_dim), k.view(b, s, n_kv, head_dim),
            v.view(b, s, n_kv, head_dim))


def _sdpa_chunk(q_blk: Tensor, k: Tensor, v: Tensor, mask_blk: Tensor,
                want_mass: bool = True) -> Tuple[Tensor, Optional[Tensor]]:
    """q_blk (B, qc, Hkv, G, hd); k/v (B, T, Hkv, hd); mask (B or 1, qc, T).

    Returns (out (B, qc, Hkv, G, hd) in v's dtype, attn_mass (B, T) f32 or
    None): the mass is the attention each key receives, summed over heads
    and queries, for salience.
    """
    b, qc, n_kv, g, hd = q_blk.shape
    t = k.shape[1]
    qf = q_blk.permute(0, 2, 3, 1, 4).reshape(b, n_kv, g * qc, hd).float()
    scores = torch.matmul(qf, k.permute(0, 2, 3, 1).float())
    scores = scores.view(b, n_kv, g, qc, t).div_(math.sqrt(hd))
    scores.masked_fill_(~mask_blk[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.matmul(probs.to(v.dtype).view(b, n_kv, g * qc, t),
                       v.permute(0, 2, 1, 3))
    out = out.view(b, n_kv, g, qc, hd).permute(0, 3, 1, 2, 4)
    mass = probs.sum(dim=(1, 2, 3)) if want_mass else None
    return out, mass


def attention_kv(p: Attention, x: Tensor, positions: Tensor, *,
                 n_heads: int, n_kv: int, head_dim: int, theta: float,
                 chunk: int = 0, q_chunk: int = 512,
                 want_salience: bool = False, remat: bool = False
                 ) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """``attention`` that also returns its post-RoPE keys and its values
    (B, S, n_kv, hd), which prefill stores in the cache.

    ``chunk`` with 0 < chunk < S makes it chunked-local: the keys are
    padded to a multiple of ``chunk``, and a query block starting at s0
    attends only to its window [floor(s0/chunk)*chunk, +chunk), masked
    j <= i, so the query block must not straddle a window edge
    (chunk % q block == 0). The per-key mass of each window is summed
    into the window's slice and cut back to S.

    ``remat`` checkpoints each query block (``torch.utils.checkpoint``,
    non-reentrant), as the reference's ``jax.checkpoint`` of its q-chunk
    scan body: the backward keeps only the block's inputs and recomputes
    its (B, H, qc, keys) scores and probabilities. The blocks' outputs are
    collected and joined once, so no buffer is written in place under
    autograd."""
    b, s, _ = x.shape
    g = n_heads // n_kv
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)

    qc = min(q_chunk, s)
    while s % qc != 0:
        qc //= 2
    local = 0 < chunk < s
    kp, vp = k, v
    if local:
        assert chunk % qc == 0, (chunk, qc)
        pad = (-s) % chunk
        if pad:
            kp = F.pad(k, (0, 0, 0, 0, 0, pad))
            vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.view(b, s, n_kv, g, head_dim)
    outs, mass = [], {}
    for s0 in range(0, s, qc):
        if local:
            w0 = s0 // chunk * chunk
            keys, vals = kp[:, w0:w0 + chunk], vp[:, w0:w0 + chunk]
        else:
            w0, keys, vals = 0, k, v
        causal = torch.ones((qc, keys.shape[1]), dtype=torch.bool,
                            device=x.device).tril_(s0 - w0)  # j <= s0 + i
        args = (qg[:, s0:s0 + qc], keys, vals, causal[None], want_salience)
        o, m = (checkpoint(_sdpa_chunk, *args, use_reentrant=False)
                if remat else _sdpa_chunk(*args))
        outs.append(o)
        if want_salience:
            mass[w0] = m if w0 not in mass else mass[w0] + m
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    y = out.reshape(b, s, n_heads * head_dim) @ p.wo.to(out.dtype)
    sal = None
    if want_salience:
        sal = torch.cat([mass[w] for w in sorted(mass)], dim=1)[:, :s] / s
    return y, sal, k, v


def attention(p: Attention, x: Tensor, positions: Tensor, *,
              n_heads: int, n_kv: int, head_dim: int, theta: float,
              chunk: int = 0, q_chunk: int = 512,
              want_salience: bool = False
              ) -> Tuple[Tensor, Optional[Tensor]]:
    """Causal (optionally chunked-local) self-attention over x (B, S, D)
    -> (out (B, S, D), salience (B, S) f32 or None): the salience of key j
    is the attention mass it receives, summed over heads and queries, over
    S."""
    y, sal, _, _ = attention_kv(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                                head_dim=head_dim, theta=theta, chunk=chunk,
                                q_chunk=q_chunk, want_salience=want_salience)
    return y, sal


def attention_decode(p: Attention, x: Tensor, pos: int, k_cache: Tensor,
                     v_cache: Tensor, *, n_heads: int, n_kv: int,
                     head_dim: int, theta: float, chunk: int = 0
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token decode. x (B, 1, D); caches (B, S_max, n_kv, hd).

    Writes the new key and value into the caches in place at ``pos`` and
    attends over every cache slot ``j <= pos``; with 0 < chunk < S_max
    (a chunked-local layer) only over the slots of ``pos``'s window
    [floor(pos/chunk)*chunk, +chunk), which needs S_max % chunk == 0.
    Returns (out (B, 1, D), k_cache, v_cache).
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    g = n_heads // n_kv
    q, k_new, v_new = _qkv(p, x, n_heads, n_kv, head_dim)
    posb = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posb, theta)
    k_new = apply_rope(k_new, posb, theta)
    k_cache[:, pos] = k_new[:, 0]
    v_cache[:, pos] = v_new[:, 0]
    if 0 < chunk < s_max:
        assert s_max % chunk == 0, (s_max, chunk)
        w0 = pos // chunk * chunk
        k_att, v_att = k_cache[:, w0:w0 + chunk], v_cache[:, w0:w0 + chunk]
    else:
        w0, k_att, v_att = 0, k_cache, v_cache
    j = torch.arange(w0, w0 + k_att.shape[1], device=x.device)
    out, _ = _sdpa_chunk(q.view(b, 1, n_kv, g, head_dim), k_att, v_att,
                         (j <= pos)[None, None, :], want_mass=False)
    out = out.reshape(b, 1, n_heads * head_dim) @ p.wo.to(x.dtype)
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# norm and FFN modules
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones((dim,), dtype=dtype,
                                              device=device))

    def forward(self, x: Tensor) -> Tensor:
        return rms_norm(x, self.weight, self.eps)


class SwiGLU(nn.Module):
    """The dense SwiGLU FFN: ``w_gate``, ``w_up`` (d, d_ff), ``w_down``."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.w_gate = param(d_model, d_ff)
        self.w_up = param(d_model, d_ff)
        self.w_down = param(d_ff, d_model)

    def forward(self, x: Tensor) -> Tensor:
        return ffn_apply(self, x)


def ffn_apply(p: SwiGLU, x: Tensor) -> Tensor:
    dt = x.dtype
    h = F.silu(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
    return h @ p.w_down.to(dt)


# ---------------------------------------------------------------------------
# plain MLPs (the recsys and GNN families)
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """One affine layer: ``w`` (in, out) and ``b`` (out,), the reference's
    ``{"w", "b"}`` dict."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.empty((d_in, d_out), dtype=dtype,
                                          device=device))
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype,
                                          device=device))


def mlp(dims, dtype: torch.dtype, device: torch.device) -> nn.ModuleList:
    """Layers ``dims[0] -> dims[1] -> ...`` as a list of ``Dense``: the
    reference's list of ``{"w", "b"}`` dicts (params ``<name>.<i>.w``)."""
    return nn.ModuleList(Dense(dims[i], dims[i + 1], dtype, device)
                         for i in range(len(dims) - 1))


@torch.no_grad()
def draw_dense(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw the ``w`` of every ``Dense`` in ``model`` by ``dense_init``, in
    module order (biases stay zero); returns the model."""
    for mod in model.modules():
        if isinstance(mod, Dense):
            mod.w.copy_(dense_init(generator, *mod.w.shape, mod.w.dtype))
    return model


def mlp_apply(params, prefix: str, x: Tensor, final_act: bool = False
              ) -> Tensor:
    """``x @ w + b`` through the layers ``<prefix>.<i>`` of the named
    tensors ``params``, ReLU between them (and after the last with
    ``final_act``)."""
    n = 0
    while f"{prefix}.{n}.w" in params:
        n += 1
    for i in range(n):
        x = x @ params[f"{prefix}.{i}.w"] + params[f"{prefix}.{i}.b"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# gathers and segment reductions with the reference's index semantics
# ---------------------------------------------------------------------------

def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for out-of-range ids: NaN for floats, the
    minimum for signed ints, the maximum for unsigned ints, True for
    bools."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def take_rows(table: Tensor, ids: Tensor) -> Tensor:
    """``jnp.take(table, ids, axis=0)``: rows of ``table`` (rows, ...) at
    ``ids`` (any shape) -> ids.shape + table.shape[1:]. Ids in [-rows, -1]
    wrap; any other id outside the table gives a row of ``_fill_value``,
    and the gather itself never reads outside the table (on the card an
    out-of-range index would be a device-side assert)."""
    rows = table.shape[0]
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + rows, ids)
    ok = (ids >= 0) & (ids < rows)
    out = table.index_select(0, torch.where(ok, ids, 0).reshape(-1))
    out = out.reshape(*ids.shape, *table.shape[1:])
    ok = ok.reshape(*ids.shape, *(1,) * (table.dim() - 1))
    return torch.where(ok, out, _fill_value(table.dtype))


def segment_reduce(data: Tensor, segment_ids: Tensor, num_segments: int,
                   reduce: str = "sum") -> Tensor:
    """``jax.ops.segment_{sum,max,min}`` over the leading axis: data (E,
    ...) by segment id into (num_segments, ...). Ids outside [0,
    num_segments) are dropped (they go to a spare row that is cut off).
    ``reduce`` "sum" adds with ``index_add``; "amax"/"amin" take
    ``scatter_reduce`` without the initial value, so an empty segment
    stays 0 where the reference gives -inf/+inf (its callers map those
    to 0). On the card the adds are atomics: their order, and so the
    float rounding, varies from run to run."""
    seg = segment_ids.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    if reduce == "sum":
        out = out.index_add(0, seg, data)
    else:
        idx = seg.reshape(-1, *(1,) * (data.dim() - 1)).expand_as(data)
        out = out.scatter_reduce(0, idx, data, reduce, include_self=False)
    return out[:num_segments]


# ---------------------------------------------------------------------------
# MoE FFN: top-k routing, sort-based dispatch, capacity dropping
# ---------------------------------------------------------------------------

def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert: ceil(T k cf / E) rounded up to a multiple of 8,
    at least 8."""
    c = math.ceil(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, -(-c // 8) * 8)


class MoE(nn.Module):
    """The MoE FFN's weights: ``router`` (D, E), always float32;
    ``w_gate``, ``w_up`` (E, D, F) and ``w_down`` (E, F, D) in the param
    dtype; and with ``n_shared`` a ``shared`` SwiGLU of width F x
    n_shared that every token runs through."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 n_shared: int, top_k: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.top_k = top_k

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = param(d_model, n_experts, dt=torch.float32)
        self.w_gate = param(n_experts, d_model, d_ff)
        self.w_up = param(n_experts, d_model, d_ff)
        self.w_down = param(n_experts, d_ff, d_model)
        self.shared = (SwiGLU(d_model, d_ff * n_shared, dtype, device)
                       if n_shared else None)

    def forward(self, x: Tensor, capacity_factor: float = 1.25,
                expert_chunks: int = 1, remat: bool = False
                ) -> Tuple[Tensor, Tensor]:
        return moe_apply(self, x, top_k=self.top_k,
                         capacity_factor=capacity_factor,
                         expert_chunks=expert_chunks, remat=remat)


@torch.no_grad()
def moe_init(p: MoE, generator: torch.Generator) -> MoE:
    """Draw ``p``'s weights in place by the reference's scales: normal x
    1/sqrt(D) for the router, ``w_gate`` and ``w_up``, x 1/sqrt(F) for
    ``w_down``; the shared expert as a dense SwiGLU. An expert's matrix is
    drawn at a time, so the float32 draw of a bf16 stack is never whole."""
    p.router.copy_(dense_init(generator, *p.router.shape, torch.float32))
    for w in (p.w_gate, p.w_up, p.w_down):
        for e in range(w.shape[0]):
            w[e].copy_(dense_init(generator, *w.shape[1:], w.dtype))
    if p.shared is not None:
        for w in (p.shared.w_gate, p.shared.w_up, p.shared.w_down):
            w.copy_(dense_init(generator, *w.shape, w.dtype))
    return p


class MoERouting(NamedTuple):
    """Where each of the T x k assignments goes. ``order`` is the stable
    sort of the flattened (token, slot) assignments by expert; the
    ``sorted_*`` fields, ``keep`` and ``target`` are in that order."""
    probs: Tensor           # (T, E) f32, the router's softmax
    gate: Tensor            # (T, k) f32, the top-k probs renormalised
    expert: Tensor          # (T, k) int64, the chosen experts
    order: Tensor           # (T k,) int64
    sorted_expert: Tensor   # (T k,) int64
    sorted_token: Tensor    # (T k,) int64
    keep: Tensor            # (T k,) bool: within the expert's capacity
    target: Tensor          # (T k,) int64: slot e*C + position, E*C if dropped
    capacity: int


def moe_route(p: MoE, x: Tensor, top_k: int,
              capacity_factor: float) -> MoERouting:
    """Router, top-k and sort for tokens x (T, D): the softmax of the
    float32 router logits, the top-k renormalised by their sum (floored at
    1e-9), the assignments stably sorted by expert, and each one's
    position inside its expert (its index minus the expert's exclusive
    start): positions >= capacity are dropped, so an expert keeps its
    earliest tokens. No host sync, so a CUDA graph can hold it."""
    t = x.shape[0]
    e = p.router.shape[1]
    c = moe_capacity(t, e, top_k, capacity_factor)
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * top_k, device=x.device) - start[se]
    keep = pos < c
    target = torch.where(keep, se * c + pos, e * c)
    return MoERouting(probs, gate, idx, order, se, order // top_k, keep,
                      target, c)


def moe_slots(r: MoERouting, n_tokens: int) -> Tensor:
    """``token_for_slot`` (E*C,): the token each expert slot holds, or
    ``n_tokens`` (a zero row) where the slot is empty. Dropped assignments
    all write the spare slot E*C, which is cut off."""
    e_c = r.probs.shape[1] * r.capacity
    slots = torch.full((e_c + 1,), n_tokens, dtype=torch.int64,
                       device=r.order.device)
    slots[r.target] = r.sorted_token
    return slots[:e_c]


def moe_experts(xg: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor
                ) -> Tensor:
    """The experts' SwiGLU over their slots, xg (E', C, D) -> (E', C, D):
    batched products in xg's dtype (bf16 accumulates in float32 under
    ``float32_accumulation``), each cast back as the reference casts it."""
    dt = xg.dtype
    h = torch.bmm(xg, w_gate.to(dt))
    u = torch.bmm(xg, w_up.to(dt))
    return torch.bmm(F.silu(h) * u, w_down.to(dt))


def moe_combine(y: Tensor, gate_sorted: Tensor, r: MoERouting,
                rows: Tensor, lo: int, n: int) -> Tensor:
    """The outputs of experts [lo, lo + n), y (n*C, D), gated and added
    back into their tokens -> (T, D) in y's dtype. A token's k
    contributions are added in the sorted order (ascending expert), one
    after another, as the reference's scatter-add applies them; no float
    atomics, so the sum is the same on every run. ``rows`` (T, k) holds
    each token's positions in the sorted order, ascending."""
    c = r.capacity
    in_blk = (r.sorted_expert >= lo) & (r.sorted_expert < lo + n) & r.keep
    w = torch.where(in_blk, gate_sorted, 0.0).to(y.dtype)
    slot = torch.clamp(r.target - lo * c, 0, n * c - 1)
    contrib = w[rows][..., None] * y[slot[rows]]        # (T, k, D)
    out = contrib[:, 0]                                 # 0 + x is x
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def _moe_block(x_pad: Tensor, slots: Tensor, w_gate: Tensor, w_up: Tensor,
               w_down: Tensor, gate_sorted: Tensor, r: MoERouting,
               rows: Tensor, lo: int, n: int) -> Tensor:
    """Experts [lo, lo + n): gather their slots' tokens, run them, combine
    -> (T, D)."""
    c = r.capacity
    xg = x_pad[slots[lo * c:(lo + n) * c]].view(n, c, -1)
    y = moe_experts(xg, w_gate[lo:lo + n], w_up[lo:lo + n],
                    w_down[lo:lo + n])
    return moe_combine(y.view(n * c, -1), gate_sorted, r, rows, lo, n)


def moe_apply(p: MoE, x: Tensor, *, top_k: int,
              capacity_factor: float = 1.25, expert_chunks: int = 1,
              remat: bool = False) -> Tuple[Tensor, Tensor]:
    """x (T, D) -> (out (T, D) in x's dtype, aux_loss () f32).

    The reference's single-device form (one token group): ``moe_route``,
    then E / expert_chunks experts at a time (a smaller dispatch buffer
    for many experts) gathered from x with a zero row for empty slots,
    run, and combined; the blocks' sums are added in block order, each
    block checkpointed with ``remat`` when there is more than one, as the
    reference's scan checkpoints its body. The shared expert is added
    after. The aux loss is Switch's E x sum over experts of the mean
    router prob times the share of the T x k assignments it kept."""
    t, d = x.shape
    e = p.w_gate.shape[0]
    assert e % expert_chunks == 0, (e, expert_chunks)
    n = e // expert_chunks
    r = moe_route(p, x, top_k, capacity_factor)
    slots = moe_slots(r, t)
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    gate_sorted = r.gate.reshape(-1)[r.order]
    rows = torch.sort(torch.argsort(r.order).view(t, top_k), dim=-1).values
    out = None
    for blk in range(expert_chunks):
        args = (x_pad, slots, p.w_gate, p.w_up, p.w_down, gate_sorted, r,
                rows, blk * n, n)
        y = (checkpoint(_moe_block, *args, use_reentrant=False)
             if remat and expert_chunks > 1 else _moe_block(*args))
        out = y if out is None else out + y
    if p.shared is not None:
        out = out + ffn_apply(p.shared, x)
    kept = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, r.sorted_expert, r.keep.float())
    aux = e * torch.sum(r.probs.mean(0) * (kept / (t * top_k)))
    return out, aux

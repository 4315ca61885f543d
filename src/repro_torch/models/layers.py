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
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (NULL, all_to_all, local_partial,
                                       reduce_partial, shard_index)

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


def attn_specs(qkv_bias: bool) -> dict:
    """Logical specs of an ``Attention``'s parameters, by name."""
    s = {"wq": ("embed", "qkv_out"), "wk": ("embed", "kv_out"),
         "wv": ("embed", "kv_out"), "wo": ("qkv_out", "embed")}
    if qkv_bias:
        s.update(bq=("qkv_out",), bk=("kv_out",), bv=("kv_out",))
    return s


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
    return (_heads(q, n_heads, head_dim, n_kv),
            _heads(k, n_kv, head_dim, n_kv), _heads(v, n_kv, head_dim, n_kv))


def _heads(x: Tensor, n: int, hd: int, n_kv: int) -> Tensor:
    """(B, S, n*hd) -> (B, S, n, hd). A DTensor whose last dim is sharded
    inside a GQA group (the kv heads do not divide among the shards: one
    kv head of 16 at model = 2, or 256 of 128-wide heads cut 64 wide) is
    gathered on that dim first, so each shard holds whole groups or the
    heads are replicated."""
    b, s, _ = x.shape
    if isinstance(x, DTensor):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 2
              and n_kv % x.device_mesh.size(i) != 0 else p
              for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            return _local_view(x.redistribute(x.device_mesh, pl),
                               (b, s, n, hd))
    return x.view(b, s, n, hd)


def _local_view(x: DTensor, shape: Tuple[int, ...]) -> DTensor:
    """``x.view(shape)`` of a DTensor sharded on leading dims that the view
    keeps, done on the local shard: the gradient coming back is put in
    x's layout before it is viewed back (DTensor's own view cannot split
    a dim the gradient arrives sharded on)."""
    mesh = x.device_mesh
    loc = x.to_local()
    lshape = list(shape)
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            lshape[p.dim] //= mesh.size(i)
    y = loc.view(*lshape)
    return DTensor.from_local(y, mesh, x.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _pad_seq(x: Tensor, pad: int) -> Tensor:
    """(B, S, H, hd) -> (B, S + pad, H, hd), zeros after. A DTensor is
    padded on its local shard, its sequence dim gathered first (DTensor's
    own pad is not reliable across PyTorch versions)."""
    if not isinstance(x, DTensor):
        return F.pad(x, (0, 0, 0, 0, 0, pad))
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    shape = torch.Size((x.shape[0], x.shape[1] + pad, *x.shape[2:]))
    return DTensor.from_local(F.pad(x.to_local(), (0, 0, 0, 0, 0, pad)),
                              x.device_mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _merge_heads(out: Tensor, n_kv: int) -> Tensor:
    """(B, S, n_kv, G, hd) -> (B, S, n_kv*G*hd); heads that ``_heads``
    replicated are merged on the local shard (``_local_view``)."""
    b, s = out.shape[:2]
    shape = (b, s, math.prod(out.shape[2:]))
    if isinstance(out, DTensor) and not any(
            isinstance(p, Shard) and p.dim >= 2 for p in out.placements):
        return _local_view(out.contiguous(), shape)
    return out.reshape(shape)


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
    scores = scores.view(b, n_kv, g, qc, t)
    if isinstance(scores, DTensor):     # may be a partial sum: no in-place
        scores = (scores / math.sqrt(hd)).masked_fill(
            ~mask_blk[:, None, None], NEG_INF)
    else:
        scores.div_(math.sqrt(hd)).masked_fill_(~mask_blk[:, None, None],
                                                NEG_INF)
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
                 want_salience: bool = False, remat: bool = False, shd=NULL
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
    autograd.

    ``shd`` adds no constraint, as the reference's adds none: the
    projections' weight shardings pin q, k and v (a head axis that a
    shard would cut is gathered first, ``_heads``)."""
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
            kp, vp = _pad_seq(k, pad), _pad_seq(v, pad)
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
    y = _merge_heads(out, n_kv) @ p.wo.to(out.dtype)
    sal = None
    if want_salience:
        sal = torch.cat([mass[w] for w in sorted(mass)], dim=1)[:, :s] / s
    return y, sal, k, v


def attention(p: Attention, x: Tensor, positions: Tensor, *,
              n_heads: int, n_kv: int, head_dim: int, theta: float,
              chunk: int = 0, q_chunk: int = 512,
              want_salience: bool = False, shd=NULL
              ) -> Tuple[Tensor, Optional[Tensor]]:
    """Causal (optionally chunked-local) self-attention over x (B, S, D)
    -> (out (B, S, D), salience (B, S) f32 or None): the salience of key j
    is the attention mass it receives, summed over heads and queries, over
    S."""
    y, sal, _, _ = attention_kv(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                                head_dim=head_dim, theta=theta, chunk=chunk,
                                q_chunk=q_chunk, want_salience=want_salience,
                                shd=shd)
    return y, sal


def attention_decode(p: Attention, x: Tensor, pos: int, k_cache: Tensor,
                     v_cache: Tensor, *, n_heads: int, n_kv: int,
                     head_dim: int, theta: float, chunk: int = 0, shd=NULL
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
    _write_slot(k_cache, pos, k_new)
    _write_slot(v_cache, pos, v_new)
    if 0 < chunk < s_max:
        assert s_max % chunk == 0, (s_max, chunk)
        w0 = pos // chunk * chunk
        k_att, v_att = k_cache[:, w0:w0 + chunk], v_cache[:, w0:w0 + chunk]
    else:
        w0, k_att, v_att = 0, k_cache, v_cache
    j = torch.arange(w0, w0 + k_att.shape[1], device=x.device)
    out, _ = _sdpa_chunk(q.view(b, 1, n_kv, g, head_dim), k_att, v_att,
                         (j <= pos)[None, None, :], want_mass=False)
    out = _merge_heads(out, n_kv) @ p.wo.to(x.dtype)
    return out, k_cache, v_cache


def _write_slot(cache: Tensor, pos: int, new: Tensor) -> None:
    """cache[:, pos] = new[:, 0] in place; a placed cache takes ``new`` in
    its own layout and writes its shard."""
    if isinstance(cache, DTensor):
        if not isinstance(new, DTensor):
            new = DTensor.from_local(new, cache.device_mesh,
                                     [Replicate()] * cache.device_mesh.ndim,
                                     run_check=False)
        new = new.redistribute(cache.device_mesh, cache.placements)
        cache.to_local()[:, pos] = new.to_local()[:, 0]
    else:
        cache[:, pos] = new[:, 0]


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


def ffn_specs() -> dict:
    """Logical specs of a ``SwiGLU``'s parameters, by name."""
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


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
    out-of-range index would be a device-side assert). A placed table
    goes through ``_take_rows_placed``."""
    if isinstance(table, DTensor):
        return _take_rows_placed(table, ids)
    rows = table.shape[0]
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + rows, ids)
    ok = (ids >= 0) & (ids < rows)
    out = table.index_select(0, torch.where(ok, ids, 0).reshape(-1))
    out = out.reshape(*ids.shape, *table.shape[1:])
    ok = ok.reshape(*ids.shape, *(1,) * (table.dim() - 1))
    return torch.where(ok, out, _fill_value(table.dtype))


def _take_rows_placed(table: DTensor, ids: Tensor) -> DTensor:
    """``take_rows`` of a DTensor table, its rows sharded or not, as the
    per-rank program of a row-sharded lookup: the ids are gathered over
    the mesh dims that shard the rows (ids are small; the table is never
    gathered), each rank reads the ids that fall in its rows and zeros
    elsewhere, one all-reduce SUM over those dims adds the ranks' rows
    (each id read once), and only then do the ids outside the table take
    ``jnp.take``'s fill, so an out-of-range id is NaN once, not a sum.
    The result is sharded as the ids are on the other dims."""
    mesh = table.device_mesh
    rows = table.shape[0]
    tpl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in table.placements]
    if tpl != list(table.placements):
        table = table.redistribute(mesh, tpl)
    row_dims = [i for i, p in enumerate(tpl) if isinstance(p, Shard)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ipl = [Replicate() if i in row_dims else p
           for i, p in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, ipl)
    # the table is read by other ids on the ranks where the ids are sharded
    spread = [i for i, p in enumerate(ipl) if not isinstance(p, Replicate)]
    t_l = local_partial(table, spread)
    i_l = ids.to_local().to(torch.int64)
    i_l = torch.where(i_l < 0, i_l + rows, i_l)
    ok = (i_l >= 0) & (i_l < rows)
    r0 = shard_index(mesh, tuple(mesh.mesh_dim_names[i]
                                 for i in row_dims))[0] * t_l.shape[0]
    at = i_l - r0
    mine = ok & (at >= 0) & (at < t_l.shape[0])
    part = t_l.index_select(0, torch.where(mine, at, 0).reshape(-1))
    part = part.reshape(*i_l.shape, *t_l.shape[1:])
    tail = (1,) * (t_l.dim() - 1)
    part = torch.where(mine.reshape(*i_l.shape, *tail), part,
                       torch.zeros((), dtype=part.dtype, device=part.device))
    out_pl = [p if isinstance(p, Shard) else Replicate() for p in ipl]
    got = reduce_partial(part, mesh, out_pl, row_dims).to_local()
    got = torch.where(ok.reshape(*i_l.shape, *tail), got,
                      _fill_value(table.dtype))
    return DTensor.from_local(got, mesh, out_pl, run_check=False)


def from_local_rows(x: Tensor, mesh, placements, rows: int) -> DTensor:
    """Each rank's rows ``x`` as a DTensor of ``rows`` rows in all, the
    other dims whole."""
    shape = torch.Size((rows, *x.shape[1:]))
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


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
    if isinstance(data, DTensor):
        return _segment_reduce_placed(data, segment_ids, num_segments,
                                      reduce)
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


def _segment_reduce_placed(data: DTensor, segment_ids: Tensor,
                           num_segments: int, reduce: str) -> DTensor:
    """``segment_reduce`` of data whose rows are sharded, as a per-rank
    program: each rank reduces its rows into all ``num_segments`` rows,
    then one all-reduce (SUM, MAX or MIN) joins the ranks; the result is
    replicated. An empty segment is 0, as the local form gives. A max or
    min takes its value from the all-reduce and its gradient from the
    entries that equal it, on whichever rank they are."""
    mesh = data.device_mesh
    rows = [i for i, p in enumerate(data.placements)
            if isinstance(p, Shard) and p.dim == 0]
    pl = [p if i in rows else Replicate()
          for i, p in enumerate(data.placements)]
    if pl != list(data.placements):
        data = data.redistribute(mesh, pl)
    seg = segment_ids
    if isinstance(seg, DTensor):
        seg = seg.redistribute(mesh, [Shard(0) if i in rows else Replicate()
                                      for i in range(mesh.ndim)]).to_local()
    d_l = data.to_local()
    seg = seg.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    rep = [Replicate()] * mesh.ndim
    shape = (num_segments + 1, *d_l.shape[1:])
    if reduce == "sum":
        part = torch.zeros(shape, dtype=d_l.dtype, device=d_l.device)
        part = part.index_add(0, seg, d_l)[:num_segments]
        return reduce_partial(part, mesh, rep, rows)
    fill = float("-inf") if reduce == "amax" else float("inf")
    idx = seg.reshape(-1, *(1,) * (d_l.dim() - 1)).expand_as(d_l)
    start = torch.full(shape, fill, dtype=d_l.dtype, device=d_l.device)
    part = start.scatter_reduce(0, idx, d_l.detach(), reduce)
    best = reduce_partial(part[:num_segments], mesh, rep, rows,
                          "max" if reduce == "amax" else "min").to_local()
    # the entries that reach the joint extreme share its gradient evenly,
    # as ``scatter_reduce`` shares it among ties (ties on several ranks
    # counted by one more all-reduce)
    at = torch.cat([best, best.new_zeros((1, *best.shape[1:]))])
    hit = (d_l == torch.gather(at, 0, idx)).to(d_l.dtype)
    zero = torch.zeros(shape, dtype=d_l.dtype, device=d_l.device)
    ties = reduce_partial(zero.index_add(0, seg, hit)[:num_segments], mesh,
                          rep, rows).to_local()
    ties = torch.cat([ties, ties.new_ones((1, *ties.shape[1:]))])
    share = d_l * (hit / torch.clamp(torch.gather(ties, 0, idx), min=1.0))
    sel = zero.index_add(0, seg, share - share.detach())[:num_segments]
    out = torch.where(torch.isfinite(best), best, 0.0) + sel
    return DTensor.from_local(out, mesh, rep, run_check=False)


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
                expert_chunks: int = 1, remat: bool = False, shd=NULL
                ) -> Tuple[Tensor, Tensor]:
        return moe_apply(self, x, top_k=self.top_k,
                         capacity_factor=capacity_factor,
                         expert_chunks=expert_chunks, remat=remat, shd=shd)


def moe_specs(n_shared: int) -> dict:
    """Logical specs of a ``MoE``'s parameters, by name: the experts'
    stacks on "expert", the router and a shared expert as the dense FFN."""
    s = {"router": ("embed", None),
         "w_gate": ("expert", "embed", "expert_mlp"),
         "w_up": ("expert", "embed", "expert_mlp"),
         "w_down": ("expert", "expert_mlp", "embed")}
    if n_shared:
        s.update({f"shared.{k}": v for k, v in ffn_specs().items()})
    return s


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
    """Where each of the T x k assignments of a token group goes. ``order``
    is the stable sort of the flattened (token, slot) assignments by
    expert; the ``sorted_*`` fields, ``keep`` and ``target`` are in that
    order. Tokens (T, D) route as one group; tokens (G, Tg, D) as G groups
    of their own capacity, every field then with a leading G dim."""
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
    """Router, top-k and sort for tokens x (T, D) or groups (G, Tg, D):
    the softmax of the float32 router logits, the top-k renormalised by
    their sum (floored at 1e-9), each group's assignments stably sorted by
    expert, and each one's position inside its expert (its index minus
    the expert's exclusive start in the group): positions >= capacity are
    dropped, so an expert keeps a group's earliest tokens. No host sync,
    so a CUDA graph can hold it."""
    return _route(p.router, x, top_k, capacity_factor)


def _route(router: Tensor, x: Tensor, top_k: int,
           capacity_factor: float) -> MoERouting:
    t = x.shape[-2]
    e = router.shape[1]
    c = moe_capacity(t, e, top_k, capacity_factor)
    probs = torch.softmax(x.float() @ router, dim=-1)
    # top_k <= n_experts = probs.shape[-1] (the configs' routing)
    gate, idx = torch.topk(probs, top_k, dim=-1)  # noqa: TORCH04
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    lead = idx.shape[:-2]
    flat_e = idx.reshape(*lead, t * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.take_along_dim(flat_e, order, dim=-1)
    counts = torch.zeros((*lead, e), dtype=torch.int64,
                         device=x.device).scatter_add_(
        -1, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, -1) - counts
    pos = (torch.arange(t * top_k, device=x.device)
           - torch.take_along_dim(start, se, dim=-1))
    keep = pos < c
    target = torch.where(keep, se * c + pos, e * c)
    return MoERouting(probs, gate, idx, order, se, order // top_k, keep,
                      target, c)


def moe_slots(r: MoERouting, n_tokens: int) -> Tensor:
    """``token_for_slot`` (E*C,), or (G, E*C) per group: the token each
    expert slot holds, or ``n_tokens`` (a zero row) where the slot is
    empty. Dropped assignments all write the spare slot E*C, which is cut
    off."""
    e_c = r.probs.shape[-1] * r.capacity
    lead = r.target.shape[:-1]
    slots = torch.full((*lead, e_c + 1), n_tokens, dtype=torch.int64,
                       device=r.order.device)
    slots.scatter_(-1, r.target, r.sorted_token)
    return slots[..., :e_c]


def moe_experts(xg: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor
                ) -> Tensor:
    """The experts' SwiGLU over their slots, xg (E', C, D) -> (E', C, D):
    batched products in xg's dtype (bf16 accumulates in float32 under
    ``float32_accumulation``), each cast back as the reference casts it."""
    dt = xg.dtype
    h = torch.bmm(xg, w_gate.to(dt))
    u = torch.bmm(xg, w_up.to(dt))
    return torch.bmm(F.silu(h) * u, w_down.to(dt))


def _experts_grouped(xg: Tensor, w_gate: Tensor, w_up: Tensor,
                     w_down: Tensor) -> Tensor:
    """``moe_experts`` over every group's slots, xg (G, E', C, D) ->
    (G, E', C, D): an expert's rows of all groups in one product."""
    g, e, c, d = xg.shape
    if g == 1:
        return moe_experts(xg[0], w_gate, w_up, w_down)[None]
    y = moe_experts(xg.transpose(0, 1).reshape(e, g * c, d), w_gate, w_up,
                    w_down)
    return y.view(e, g, c, d).transpose(0, 1)


def moe_combine(y: Tensor, gate_sorted: Tensor, r: MoERouting,
                rows: Tensor, lo: int, n: int) -> Tensor:
    """The outputs of experts [lo, lo + n), y (n*C, D), gated and added
    back into their tokens -> (T, D) in y's dtype; per group with a
    leading G dim on every input and the result. A token's k
    contributions are added in the sorted order (ascending expert), one
    after another, as the reference's scatter-add applies them; no float
    atomics, so the sum is the same on every run. ``rows`` (T, k) holds
    each token's positions in the sorted order, ascending."""
    c = r.capacity
    in_blk = (r.sorted_expert >= lo) & (r.sorted_expert < lo + n) & r.keep
    w = torch.where(in_blk, gate_sorted, 0.0).to(y.dtype)
    slot = torch.clamp(r.target - lo * c, 0, n * c - 1)
    t, k = rows.shape[-2:]
    flat = rows.reshape(*rows.shape[:-2], t * k)
    at = torch.take_along_dim(slot, flat, dim=-1)
    ys = torch.take_along_dim(y, at[..., None], dim=-2)
    contrib = (torch.take_along_dim(w, flat, dim=-1)[..., None] * ys
               ).view(*rows.shape, y.shape[-1])          # (.., T, k, D)
    out = contrib[..., 0, :]                            # 0 + x is x
    for j in range(1, k):
        out = out + contrib[..., j, :]
    return out


class _Grouped(NamedTuple):
    """One call's routing of its G token groups and what every expert
    block reads: the tokens with a zero row after each group's (G, Tg+1,
    D), the slot table (G, E*C), the sorted gates and each token's sorted
    positions."""
    r: MoERouting
    x_pad: Tensor
    slots: Tensor
    gate_sorted: Tensor
    rows: Tensor


def _group_route(router: Tensor, xg: Tensor, top_k: int,
                 capacity_factor: float) -> _Grouped:
    g, tg, d = xg.shape
    r = _route(router, xg, top_k, capacity_factor)
    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    gate_sorted = torch.take_along_dim(r.gate.reshape(g, tg * top_k),
                                       r.order, dim=-1)
    rows = torch.sort(torch.argsort(r.order, dim=-1).view(g, tg, top_k),
                      dim=-1).values
    return _Grouped(r, x_pad, moe_slots(r, tg), gate_sorted, rows)


def _dispatch(gr: _Grouped, lo: int, n: int) -> Tensor:
    """The slots of experts [lo, lo + n) filled from each group's tokens
    -> (G, n, C, D)."""
    g, _, d = gr.x_pad.shape
    c = gr.r.capacity
    idx = gr.slots[:, lo * c:(lo + n) * c]
    if g == 1:      # the single-group form's gather, and its backward
        return gr.x_pad[0][idx[0]].view(1, n, c, d)
    xg = torch.take_along_dim(gr.x_pad, idx[..., None], dim=1)
    return xg.view(g, n, c, d)


def _moe_block(gr: _Grouped, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
               lo: int, n: int) -> Tensor:
    """Experts [lo, lo + n) of every group: gather their slots' tokens,
    run them, combine -> (G, Tg, D)."""
    y = _experts_grouped(_dispatch(gr, lo, n), w_gate[lo:lo + n],
                         w_up[lo:lo + n], w_down[lo:lo + n])
    g, _, c, d = y.shape
    return moe_combine(y.reshape(g, n * c, d), gr.gate_sorted, gr.r,
                       gr.rows, lo, n)


def _aux_terms(r: MoERouting, e: int) -> Tuple[Tensor, Tensor]:
    """(the router probs summed over the tokens (E,), the kept assignments
    counted per expert (E,) f32) over every group."""
    kept = torch.zeros(e, dtype=torch.float32,
                       device=r.keep.device).scatter_add_(
        0, r.sorted_expert.reshape(-1), r.keep.reshape(-1).float())
    return r.probs.reshape(-1, e), kept


def moe_apply(p: MoE, x: Tensor, *, top_k: int,
              capacity_factor: float = 1.25, expert_chunks: int = 1,
              remat: bool = False, shd=NULL) -> Tuple[Tensor, Tensor]:
    """x (T, D) -> (out (T, D) in x's dtype, aux_loss () f32).

    The reference's grouped dispatch: the T tokens split into G =
    ``shd.num_shards("tokens", T)`` groups of T/G (one group with
    ``NULL``), each routed with its own capacity ``moe_capacity(T/G, ...)``
    (``moe_route`` over a leading G dim), then E / expert_chunks experts
    at a time (a smaller dispatch buffer for many experts) gathered from
    each group's tokens with a zero row for empty slots, run, and combined
    per group; the blocks' sums are added in block order, each block
    checkpointed with ``remat`` when there is more than one, as the
    reference's scan checkpoints its body. The shared expert is added
    after. The aux loss is Switch's E x sum over experts of the mean
    router prob times the share of the T x k assignments it kept, over
    all groups.

    On a mesh the groups live on the ranks of the token axes and the
    experts on those of the expert axes: ``_moe_ranks`` is the per-rank
    program."""
    t, d = x.shape
    e = p.w_gate.shape[0]
    assert e % expert_chunks == 0, (e, expert_chunks)
    n = e // expert_chunks
    g = shd.num_shards("tokens", t)
    xg_tok = shd.constraint(x.reshape(g, t // g, d), "tokens", None, None)
    if isinstance(xg_tok, DTensor):
        out, aux = _moe_ranks(p, xg_tok, top_k, capacity_factor,
                              expert_chunks, remat, shd)
    else:
        gr = _group_route(p.router, xg_tok, top_k, capacity_factor)
        out = None
        for blk in range(expert_chunks):
            args = (gr, p.w_gate, p.w_up, p.w_down, blk * n, n)
            y = (checkpoint(_moe_block, *args, use_reentrant=False)
                 if remat and expert_chunks > 1 else _moe_block(*args))
            out = y if out is None else out + y
        probs, kept = _aux_terms(gr.r, e)
        aux = e * torch.sum(probs.mean(0) * (kept / (t * top_k)))
    out = shd.constraint(out, "tokens", None, None).reshape(t, d)
    if p.shared is not None:
        out = out + ffn_apply(p.shared, x)
    return out, aux


def _mesh_dims(x: DTensor, dim: int) -> List[int]:
    """The mesh dims (of size > 1) that shard ``x``'s ``dim``."""
    return [i for i, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and pl.dim == dim
            and x.device_mesh.size(i) > 1]


def _moe_ranks(p: MoE, xg_tok: DTensor, top_k: int, capacity_factor: float,
               expert_chunks: int, remat: bool, shd
               ) -> Tuple[DTensor, DTensor]:
    """The grouped MoE's per-rank program on a mesh: xg_tok (G, Tg, D)
    with G sharded on the token axes -> (out (G, Tg, D) placed as xg_tok,
    aux () replicated).

    Routing, the slot table, the dispatch gather and the combine run on
    the rank's own groups, replicated over the other mesh dims; the expert
    weights stay where their spec puts them (E on the expert axes, whole
    on the token axes). In each expert block a rank takes the block's
    experts it holds (constraint #1's expert placement, a local slice)
    and, when the token axes shard G and those experts divide among them,
    trades slots with the token ranks in one all-to-all: every token rank
    then runs its share of the experts over every group's slots, and a
    second all-to-all brings the outputs back to their groups. The outputs
    of the experts the other expert ranks hold arrive in one all-reduce of
    the block's (G, n, C, D) buffer, zero outside each rank's experts
    (constraint #2: the expert dim whole again), so the combine sees every
    expert. The aux loss's sums over the groups are all-reduced over the
    token axes."""
    mesh = xg_tok.device_mesh
    tok = _mesh_dims(xg_tok, 0)
    exp = _mesh_dims(p.w_gate, 0)
    assert not set(tok) & set(exp), (tok, exp)
    e = p.w_gate.shape[0]
    n = e // expert_chunks
    x_l = xg_tok.to_local()
    router = local_partial(p.router, tok)
    w_l = [local_partial(w, tok) for w in (p.w_gate, p.w_up, p.w_down)]
    e_lo = 0
    if exp:
        e_lo = shard_index(mesh, tuple(mesh.mesh_dim_names[i]
                                       for i in exp))[0] * w_l[0].shape[0]
    e_hi = e_lo + w_l[0].shape[0]
    if tok:
        tok_at, n_tok = shard_index(mesh, tuple(mesh.mesh_dim_names[i]
                                                for i in tok))
    rep = list(xg_tok.placements)
    gr = _group_route(router, x_l, top_k, capacity_factor)

    def block(gr, w_gate, w_up, w_down, lo):
        xg = _dispatch(gr, lo, n)
        # this rank's experts of the block, [a, b) (empty when it holds
        # none: the program stays the same on every rank)
        a = min(max(lo, e_lo), lo + n)
        b = max(a, min(lo + n, e_hi))
        if exp:     # a local slice of the slots, its gradient summed back
            xg = local_partial(DTensor.from_local(xg, mesh, rep,
                                                  run_check=False), exp)
        mine = xg[:, a - lo:b - lo]
        ws = [w[a - e_lo:b - e_lo] for w in (w_gate, w_up, w_down)]
        if tok and b > a and (b - a) % n_tok == 0:
            # all-to-all #1: the groups' slots from the token ranks to the
            # rank that runs their experts
            got = all_to_all(mine, mesh, tok, split_dim=1, cat_dim=0)
            share = (b - a) // n_tok
            ys = _experts_grouped(got, *(w[tok_at * share:
                                           (tok_at + 1) * share]
                                         for w in ws))
            # all-to-all #2: the outputs back to their groups
            ym = all_to_all(ys, mesh, tok, split_dim=0, cat_dim=1)
        else:
            ym = _experts_grouped(mine, *ws)
        if exp:     # every expert rank's outputs, in one all-reduce
            g_, _, c_, d_ = ym.shape
            y = torch.cat([ym.new_zeros((g_, a - lo, c_, d_)), ym,
                           ym.new_zeros((g_, lo + n - b, c_, d_))], dim=1)
            y = reduce_partial(y, mesh, rep, exp).to_local()
        else:
            y = ym
        g, _, c, d = y.shape
        return moe_combine(y.reshape(g, n * c, d), gr.gate_sorted, gr.r,
                           gr.rows, lo, n)

    out = None
    for blk in range(expert_chunks):
        args = (gr, *w_l, blk * n)
        y = (checkpoint(block, *args, use_reentrant=False)
             if remat and expert_chunks > 1 else block(*args))
        out = y if out is None else out + y
    probs, kept = _aux_terms(gr.r, e)
    t_all = xg_tok.shape[0] * xg_tok.shape[1]
    me = (reduce_partial(probs.sum(0), mesh, [Replicate()] * mesh.ndim,
                         tok).to_local() / t_all if tok else probs.mean(0))
    kept = reduce_partial(kept, mesh, [Replicate()] * mesh.ndim,
                          tok).to_local()
    aux = e * torch.sum(me * (kept / (t_all * top_k)))
    return (DTensor.from_local(out, mesh, rep, run_check=False),
            DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                               run_check=False))

"""Shared model building blocks: init, RMSNorm, RoPE, GQA attention with
the per-key attention mass, and the SwiGLU FFN.

The counterpart of ``repro.models.layers`` (its dense parts). The same
conventions:

  * weights are stored (in, out) in the param dtype and cast to the
    activation dtype at each product; norms, attention scores and softmax
    run in float32;
  * attention is causal GQA with RoPE, query head ``h`` reading kv head
    ``h // (n_heads // n_kv)`` (the reference's ``(n_kv, g)`` split of the
    head axis), over query blocks of ``q_chunk`` so a score block is at
    most (B, H, q_chunk, S);
  * the scores are float32 products: bf16 q and k are widened first, which
    is exact (bf16 values are float32 values), so the product is the
    reference's ``preferred_element_type=float32`` one.

The attention is plain PyTorch in every layer, as the reference keeps it
outside Pallas: the last layer's probabilities give the salience, which
``scaled_dot_product_attention`` does not return. MoE layers and the
chunked-local (iRoPE) mask are not ported yet.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

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
    ``encode_query``) run under this, and the train steps
    (``transformer.train_step``, ``colpali.train_step``) hold it across
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
                 q_chunk: int = 512, want_salience: bool = False,
                 remat: bool = False
                 ) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """``attention`` that also returns its post-RoPE keys and its values
    (B, S, n_kv, hd), which prefill stores in the cache.

    ``remat`` checkpoints each query block (``torch.utils.checkpoint``,
    non-reentrant), as the reference's ``jax.checkpoint`` of its q-chunk
    scan body: the backward keeps only the block's inputs and recomputes
    its (B, H, qc, S) scores and probabilities. The blocks' outputs are
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
    qg = q.view(b, s, n_kv, g, head_dim)
    outs, mass = [], None
    for s0 in range(0, s, qc):
        causal = torch.ones((qc, s), dtype=torch.bool,
                            device=x.device).tril_(s0)     # j <= s0 + i
        args = (qg[:, s0:s0 + qc], k, v, causal[None], want_salience)
        o, m = (checkpoint(_sdpa_chunk, *args, use_reentrant=False)
                if remat else _sdpa_chunk(*args))
        outs.append(o)
        if want_salience:
            mass = m if mass is None else mass + m
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    y = out.reshape(b, s, n_heads * head_dim) @ p.wo.to(out.dtype)
    sal = mass / s if want_salience else None
    return y, sal, k, v


def attention(p: Attention, x: Tensor, positions: Tensor, *,
              n_heads: int, n_kv: int, head_dim: int, theta: float,
              q_chunk: int = 512, want_salience: bool = False
              ) -> Tuple[Tensor, Optional[Tensor]]:
    """Causal self-attention over x (B, S, D) -> (out (B, S, D), salience
    (B, S) f32 or None): the salience of key j is the attention mass it
    receives, summed over heads and queries, over S."""
    y, sal, _, _ = attention_kv(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                                head_dim=head_dim, theta=theta,
                                q_chunk=q_chunk, want_salience=want_salience)
    return y, sal


def attention_decode(p: Attention, x: Tensor, pos: int, k_cache: Tensor,
                     v_cache: Tensor, *, n_heads: int, n_kv: int,
                     head_dim: int, theta: float
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token decode. x (B, 1, D); caches (B, S_max, n_kv, hd).

    Writes the new key and value into the caches in place at ``pos`` and
    attends over every cache slot ``j <= pos``. Returns (out (B, 1, D),
    k_cache, v_cache).
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
    mask = (torch.arange(s_max, device=x.device) <= pos)[None, None, :]
    out, _ = _sdpa_chunk(q.view(b, 1, n_kv, g, head_dim), k_cache, v_cache,
                         mask, want_mass=False)
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

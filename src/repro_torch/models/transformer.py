"""Decoder-only LM (dense, GQA, RoPE): the generator of the RAG path and
the ColPali encoder's backbone.

The counterpart of ``repro.models.transformer`` for dense layers.
``LMConfig`` is the reference's, copied with every field; a config with
MoE layers (``n_experts > 0``) or chunked-local attention
(``attn_chunk > 0``) raises ``NotImplementedError`` (ROADMAP.md §A item 5,
the training half). The reference stacks its layers and scans them; here
each layer is a ``Block`` module holding its own weights, which
``convert.lm_params_from_numpy`` fills from the reference's stacked
arrays (layer ``l`` takes slice ``l``).

Serving: ``prefill`` runs the prompt and returns the last position's
logits and the KV caches (post-RoPE keys and raw values in the
activation dtype, padded to ``max_len``); ``decode_step`` writes one
position of the caches in place and attends over every slot up to it.
``prefill`` computes each layer's keys and values once and stores the
ones its attention used; the reference recomputes them from the same
inputs, so the caches are the same.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False            # qwen2-style QKV bias
    tie_embeddings: bool = True
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    moe_top_k: int = 1
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_expert_chunks: int = 1        # sequential expert blocks (memory)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # attention structure
    attn_chunk: int = 0               # >0: chunked-local (iRoPE) layers
    global_every: int = 4             # every Nth layer stays full attention
    q_chunk: int = 512                # query block of the attention
    loss_chunk: int = 2048            # CE sequence chunk
    # dtypes; with bfloat16 activations every product casts its weight to
    # bf16 and accumulates in float32 (layers.float32_accumulation)
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    # the reference's cost-analysis switch (fully unrolled scans); the
    # port has no scans, so it changes nothing here
    unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def pdtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)

    @property
    def adtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.activation_dtype == "bfloat16"
                else torch.float32)

    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = self.n_layers * (d * (self.n_heads + 2 * self.n_kv_heads) * hd
                                + self.n_heads * hd * d)
        if self.is_moe:
            ff = self.n_layers * (
                self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
                + (3 * d * self.moe_d_ff * self.n_shared_experts))
        else:
            ff = self.n_layers * 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return attn + ff + emb + self.n_layers * 2 * d + d

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        active = self.n_layers * self.moe_top_k * 3 * d * self.moe_d_ff
        return full - all_experts + active


def _check_supported(cfg: LMConfig) -> None:
    """Raise NotImplementedError for the layer kinds not ported yet."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (n_experts={cfg.n_experts}) are not "
            "ported yet (ROADMAP.md §A item 5, the training half)")
    if cfg.attn_chunk > 0:
        raise NotImplementedError(
            f"{cfg.name}: chunked-local attention (attn_chunk="
            f"{cfg.attn_chunk}) is not ported yet (ROADMAP.md §A item 5, "
            "the training half)")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm transformer block: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: LMConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cfg.pdtype
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.qkv_bias, dt, device)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, dt, device)

    def forward(self, x: Tensor, positions: Tensor,
                want_salience: bool = False
                ) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
        """-> (x, salience or None, post-RoPE keys, values)."""
        cfg = self.cfg
        a, sal, k, v = L.attention_kv(
            self.attn, self.ln1(x), positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
            q_chunk=cfg.q_chunk, want_salience=want_salience)
        x = x + a
        x = x + self.ffn(self.ln2(x))
        return x, sal, k, v


class Transformer(nn.Module):
    """The dense LM: ``embed`` (V, D), ``blocks``, ``ln_f`` and, without
    tied embeddings, ``unembed`` (D, V). Weights are allocated in the
    param dtype on ``device`` (default ``cuda``; raises on a host without
    a card unless given ``device="cpu"``) and left undrawn: ``init`` draws
    them from a generator, ``convert.lm_params_from_numpy`` copies them."""

    def __init__(self, cfg: LMConfig, *, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.d_model), dtype=cfg.pdtype, device=dev))
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, cfg.pdtype, dev)
        self.unembed = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((cfg.d_model, cfg.vocab), dtype=cfg.pdtype,
                        device=dev)))

    def embed_tokens(self, tokens: Tensor) -> Tensor:
        """tokens (B, S) -> (B, S, D) in the activation dtype."""
        return self.embed[tokens.long()].to(self.cfg.adtype)

    @L.float32_accumulation()
    def forward_embeddings(self, x: Tensor, want_salience: bool = False
                           ) -> Tuple[Tensor, Optional[Tensor]]:
        """Every block and ``ln_f`` over embedded inputs (B, S, D) ->
        (hidden, salience (B, S) of the last layer or None). Only the last
        layer computes its attention mass: the reference computes it in
        every layer and keeps the last."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        sal = None
        last = len(self.blocks) - 1
        for i, blk in enumerate(self.blocks):
            x, sal_i, _, _ = blk(x, positions, want_salience and i == last)
            if sal_i is not None:
                sal = sal_i
        return self.ln_f(x), sal

    def forward(self, tokens: Tensor, want_salience: bool = False
                ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """tokens (B, S) -> (hidden (B, S, D), aux_loss () f32 (zero: no
        MoE), salience (B, S) or None)."""
        h, sal = self.forward_embeddings(self.embed_tokens(tokens),
                                         want_salience)
        return h, torch.zeros((), dtype=torch.float32, device=h.device), sal

    @L.float32_accumulation()
    def logits(self, h: Tensor) -> Tensor:
        """(B, S, D) -> (B, S, V) float32: the weights cast to h's dtype,
        the products accumulated in float32 (bf16 values widen exactly)."""
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return torch.matmul(h.float(), w.to(h.dtype).float())


def init(cfg: LMConfig, *, generator: torch.Generator, device="cuda"
         ) -> Transformer:
    """A Transformer with weights drawn from ``generator`` (on ``device``)
    by the reference's distributions: normal x 1/sqrt(in) for projections,
    x 0.02 for the embedding; ones for norms, zeros for biases."""
    return draw_weights(Transformer(cfg, device=device), generator)


@torch.no_grad()
def draw_weights(model: Transformer, generator: torch.Generator
                 ) -> Transformer:
    """Draw ``model``'s embedding and projections in place (its norms and
    biases keep their ones and zeros); returns the model."""
    cfg = model.cfg
    model.embed.copy_(L.embed_init(generator, cfg.vocab, cfg.d_model,
                                   cfg.pdtype))
    if model.unembed is not None:
        model.unembed.copy_(L.dense_init(generator, cfg.d_model, cfg.vocab,
                                         cfg.pdtype))
    for blk in model.blocks:
        for p in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                  blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_down):
            p.copy_(L.dense_init(generator, *p.shape, cfg.pdtype))
    return model


# ---------------------------------------------------------------------------
# serving: prefill + decode with stacked KV caches
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor   # (L, B, S_max, n_kv, hd)
    v: Tensor


def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device="cuda"
               ) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=cfg.adtype, device=dev),
                   torch.zeros(shape, dtype=cfg.adtype, device=dev))


@torch.no_grad()
@L.float32_accumulation()
def prefill(model: Transformer, tokens: Tensor, max_len: int
            ) -> Tuple[Tensor, KVCache]:
    """Run the prompt (B, S) -> (last position's logits (B, V) f32, the
    caches filled at positions [0, S) and zero up to ``max_len``)."""
    cfg = model.cfg
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    x = model.embed_tokens(tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i, blk in enumerate(model.blocks):
        x, _, k, v = blk(x, positions)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    x = model.ln_f(x)
    return model.logits(x[:, -1:])[:, 0], cache


@torch.no_grad()
@L.float32_accumulation()
def decode_step(model: Transformer, token: Tensor, cache: KVCache, pos: int
                ) -> Tuple[Tensor, KVCache]:
    """One decode step: token (B,) at position ``pos`` (the same for every
    row). Updates the caches in place; returns (logits (B, V) f32,
    cache)."""
    cfg = model.cfg
    x = model.embed_tokens(token[:, None])
    for i, blk in enumerate(model.blocks):
        a, _, _ = L.attention_decode(
            blk.attn, blk.ln1(x), pos, cache.k[i], cache.v[i],
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            theta=cfg.rope_theta)
        x = x + a
        x = x + blk.ffn(blk.ln2(x))
    x = model.ln_f(x)
    return model.logits(x)[:, 0], cache

"""Decoder-only LM (dense + MoE, GQA, RoPE, chunked-local attention): the
generator of the RAG path, the ColPali encoder's backbone, and the MoE
archs (llama4-scout, kimi-k2).

The counterpart of ``repro.models.transformer``. ``LMConfig`` is the
reference's, copied with every field. The reference stacks its layers and
scans them; here each layer is a ``Block`` module holding its own weights
(an ``ffn``, or a ``moe`` for ``n_experts > 0``), which
``convert.lm_params_from_numpy`` fills from the reference's stacked
arrays (layer ``l`` takes slice ``l``). A layer that
``LMConfig.layer_is_chunked`` marks attends within windows of
``attn_chunk`` positions whenever the sequence (or the cache) is longer
than one window; every ``global_every``-th layer attends globally.

Serving: ``prefill`` runs the prompt and returns the last position's
logits and the KV caches (post-RoPE keys and raw values in the
activation dtype, padded to ``max_len``); ``decode_step`` writes one
position of the caches in place and attends over every slot up to it (or
over its window, in a chunked layer), its MoE layers routing at capacity
factor 2.0 in one expert block, as the reference's do. ``prefill``
computes each layer's keys and values once and stores the ones its
attention used; the reference recomputes them from the same inputs, so
the caches are the same.

Training: ``loss_fn`` and ``train_step`` take the model and a dict of
named tensors (``params_of(model)``: ``embed``, ``blocks.<l>.attn.wq``,
``blocks.<l>.moe.w_gate``, ``ln_f.weight``, ...) and run the same blocks
through ``Transformer.run_blocks``, each block called with those tensors
(``torch.func.functional_call``) inside a non-reentrant checkpoint, as
the reference checkpoints its scanned block; the attention's query
blocks, the MoE's expert blocks and the loss's sequence chunks are
checkpointed too. The loss adds ``aux_loss_weight`` x the MoE layers'
summed load-balance loss. The module's own weights serve the no-grad
entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (NULL, reduce_partial, shard_index,
                                       shard_tree)
from repro_torch.models import layers as L
from repro_torch.optim import optimizer as opt

Tensor = torch.Tensor

# the MoE capacity factor of a decode step, whatever the config's
# (repro.models.transformer.decode_step routes at 2.0 in one expert block)
DECODE_CAPACITY_FACTOR = 2.0


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

    def layer_is_chunked(self) -> List[bool]:
        """Which layers use chunked-local attention: all but every
        ``global_every``-th when ``attn_chunk > 0``."""
        if self.attn_chunk <= 0:
            return [False] * self.n_layers
        return [i % self.global_every != self.global_every - 1
                for i in range(self.n_layers)]

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


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm transformer block: ``ln1``, ``attn``, ``ln2`` and an
    ``ffn`` (dense) or a ``moe``. ``chunked`` marks a chunked-local
    attention layer."""

    def __init__(self, cfg: LMConfig, device: torch.device,
                 chunked: bool = False):
        super().__init__()
        self.cfg = cfg
        self.chunked = chunked
        dt = cfg.pdtype
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.qkv_bias, dt, device)
        if cfg.is_moe:
            self.moe = L.MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                             cfg.n_shared_experts, cfg.moe_top_k, dt, device)
        else:
            self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, dt, device)

    def attn_chunk(self, n_keys: int) -> int:
        """The attention window over ``n_keys`` positions: ``attn_chunk``
        in a chunked layer when a window is shorter than them, else 0
        (global)."""
        c = self.cfg.attn_chunk
        return c if self.chunked and 0 < c < n_keys else 0

    def feed_forward(self, h: Tensor, capacity_factor: float,
                     expert_chunks: int, remat: bool = False, shd=NULL
                     ) -> Tuple[Tensor, Optional[Tensor]]:
        """The FFN or the MoE over normed h (B, S, D) -> (out, the MoE's
        aux loss or None)."""
        # the sequence is gathered before the products flatten it (DTensor
        # flattens two sharded dims on no version; the MoE's groups live on
        # the token axes alone, its first constraint)
        h = shd.constraint(h, "batch", None, None)
        if not self.cfg.is_moe:
            return self.ffn(h), None
        b, s, d = h.shape
        out, aux = self.moe(h.reshape(b * s, d), capacity_factor,
                            expert_chunks, remat, shd)
        return out.view(b, s, d), aux

    def forward(self, x: Tensor, positions: Tensor,
                want_salience: bool = False, remat: bool = False, shd=NULL
                ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor],
                           Tensor, Tensor]:
        """-> (x, aux or None, salience or None, post-RoPE keys, values);
        ``remat`` checkpoints the attention's query blocks and the MoE's
        expert blocks. The residual stream is constrained to ("batch",
        "seq_sp", None) after the attention and after the FFN, as the
        reference's block is; the attention's input is gathered over the
        sequence first (Megatron-SP's all-gather), as the FFN's is."""
        cfg = self.cfg
        a, sal, k, v = L.attention_kv(
            self.attn, shd.constraint(self.ln1(x), "batch", None, None),
            positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
            chunk=self.attn_chunk(x.shape[1]), q_chunk=cfg.q_chunk,
            want_salience=want_salience, remat=remat, shd=shd)
        x = shd.constraint(x + self._to_stream(a, shd), "batch", "seq_sp",
                           None)
        ff, aux = self.feed_forward(self.ln2(x), cfg.capacity_factor,
                                    cfg.moe_expert_chunks, remat, shd)
        x = shd.constraint(x + self._to_stream(ff, shd), "batch", "seq_sp",
                           None)
        return x, aux, sal, k, v

    @staticmethod
    def _to_stream(y: Tensor, shd) -> Tensor:
        """A branch's output in the residual stream's layout, by an
        explicit redistribute: its gradient then goes back to the branch
        in the branch's own layout. (Left to the add, DTensor would hand
        the branch the stream's sequence-sharded gradient, and its
        products' backward would flatten two sharded dims.)"""
        return shd.constraint(y, "batch", "seq_sp", None)


class Transformer(nn.Module):
    """The LM: ``embed`` (V, D), ``blocks``, ``ln_f`` and, without tied
    embeddings, ``unembed`` (D, V). Weights are allocated in the param
    dtype on ``device`` (default ``cuda``; raises on a host without a card
    unless given ``device="cpu"``) and left undrawn: ``init`` draws them
    from a generator, ``convert.lm_params_from_numpy`` copies them."""

    def __init__(self, cfg: LMConfig, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.d_model), dtype=cfg.pdtype, device=dev))
        self.blocks = nn.ModuleList(Block(cfg, dev, chunked)
                                    for chunked in cfg.layer_is_chunked())
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, cfg.pdtype, dev)
        self.unembed = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((cfg.d_model, cfg.vocab), dtype=cfg.pdtype,
                        device=dev)))

    def embed_tokens(self, tokens: Tensor,
                     params: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """tokens (B, S) -> (B, S, D) in the activation dtype, from the
        module's table or ``params["embed"]`` (a vocab-sharded table
        through ``layers.take_rows``' masked lookup)."""
        table = self.embed if params is None else params["embed"]
        if isinstance(table, DTensor):
            return L.take_rows(table, tokens).to(self.cfg.adtype)
        return table[tokens.long()].to(self.cfg.adtype)

    def run_blocks(self, x: Tensor,
                   params: Optional[Dict[str, Tensor]] = None, *,
                   want_salience: bool = False, remat: bool = False,
                   shd=NULL) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """Every block and ``ln_f`` over embedded inputs (B, S, D) ->
        (hidden, aux () f32 summed over the MoE layers (zero without
        them), salience (B, S) of the last layer or None). Only the last
        layer computes its attention mass: the reference computes it in
        every layer and keeps the last.

        With ``params`` (named as ``params_of``) each block runs on those
        tensors, so the result is differentiable in them; ``remat`` then
        checkpoints every block and, inside it, every attention query
        block and MoE expert block, as the reference does. A block's
        tensors are passed into its checkpoint, so the recompute in the
        backward reads the same weights as the forward. ``shd`` runs
        through every block."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        sal, auxes = None, []
        last = len(self.blocks) - 1
        for i, blk in enumerate(self.blocks):
            want = want_salience and i == last
            if params is None:
                x, aux, sal_i, _, _ = blk(x, positions, want, shd=shd)
            else:
                pre = f"blocks.{i}."
                bp = {n[len(pre):]: t for n, t in params.items()
                      if n.startswith(pre)}
                args = (blk, bp, x, positions, want, remat, shd)
                x, aux, sal_i = (checkpoint(_block_call, *args,
                                            use_reentrant=False)
                                 if remat else _block_call(*args))
            if aux is not None:
                auxes.append(aux)
            if sal_i is not None:
                sal = sal_i
        w = self.ln_f.weight if params is None else params["ln_f.weight"]
        aux = (torch.stack(auxes).sum() if auxes else
               torch.zeros((), dtype=torch.float32, device=x.device))
        return L.rms_norm(x, w, self.cfg.norm_eps), aux, sal

    @L.float32_accumulation()
    def forward(self, tokens: Tensor, want_salience: bool = False, shd=NULL
                ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """tokens (B, S) -> (hidden (B, S, D), aux_loss () f32 (the MoE
        layers' summed load-balance loss; zero without them), salience
        (B, S) or None)."""
        with shd.scope():
            x = shd.constraint(self.embed_tokens(tokens), "batch", "seq_sp",
                               None)
            return self.run_blocks(x, want_salience=want_salience, shd=shd)

    @L.float32_accumulation()
    def logits(self, h: Tensor) -> Tensor:
        """(B, S, D) -> (B, S, V) float32: the weights cast to h's dtype,
        the products accumulated in float32 (bf16 values widen exactly)."""
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return torch.matmul(h.float(), w.to(h.dtype).float())


def _block_call(blk: Block, bp: Dict[str, Tensor], x: Tensor,
                positions: Tensor, want_salience: bool, remat: bool,
                shd=NULL
                ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """One block on the tensors ``bp`` (named as the block's own) -> (x,
    aux or None, salience or None)."""
    x, aux, sal, _, _ = torch.func.functional_call(
        blk, bp, (x, positions, want_salience, remat, shd))
    return x, aux, sal


def init(cfg: LMConfig, *, generator: torch.Generator, device="cuda"
         ) -> Transformer:
    """A Transformer with weights drawn from ``generator`` (on ``device``)
    by the reference's distributions: normal x 1/sqrt(in) for projections,
    x 0.02 for the embedding; ones for norms, zeros for biases."""
    return draw_weights(Transformer(cfg, device=device), generator)


@torch.no_grad()
def draw_weights(model: Transformer, generator: torch.Generator
                 ) -> Transformer:
    """Draw ``model``'s embedding, projections and experts in place (its
    norms and biases keep their ones and zeros); returns the model."""
    cfg = model.cfg
    model.embed.copy_(L.embed_init(generator, cfg.vocab, cfg.d_model,
                                   cfg.pdtype))
    if model.unembed is not None:
        model.unembed.copy_(L.dense_init(generator, cfg.d_model, cfg.vocab,
                                         cfg.pdtype))
    for blk in model.blocks:
        for p in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo):
            p.copy_(L.dense_init(generator, *p.shape, cfg.pdtype))
        if cfg.is_moe:
            L.moe_init(blk.moe, generator)
        else:
            for p in (blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_down):
                p.copy_(L.dense_init(generator, *p.shape, cfg.pdtype))
    return model


def block_specs(cfg: LMConfig) -> Dict[str, tuple]:
    """Logical specs of one ``Block``'s parameters, by name."""
    s = {"ln1.weight": ("embed",), "ln2.weight": ("embed",)}
    s.update({f"attn.{k}": v for k, v in L.attn_specs(cfg.qkv_bias).items()})
    if cfg.is_moe:
        s.update({f"moe.{k}": v for k, v in
                  L.moe_specs(cfg.n_shared_experts).items()})
    else:
        s.update({f"ffn.{k}": v for k, v in L.ffn_specs().items()})
    return s


def param_specs(cfg: LMConfig) -> Dict[str, tuple]:
    """Logical specs of every parameter, keyed as ``params_of``. The
    reference stacks its blocks under a leading layer dim whose spec is
    None; ``blocks.<l>.…`` takes that spec without the layer entry
    (``convert._reference_path`` maps one name to the other)."""
    s = {"embed": ("vocab", "embed")}
    for i in range(cfg.n_layers):
        s.update({f"blocks.{i}.{k}": v for k, v in block_specs(cfg).items()})
    s["ln_f.weight"] = ("embed",)
    if not cfg.tie_embeddings:
        s["unembed"] = ("embed", "vocab")
    return s


def batch_specs() -> Dict[str, tuple]:
    """Logical specs of an LM batch (``tokens``, ``targets``)."""
    return {"tokens": ("batch", None), "targets": ("batch", None)}


@torch.no_grad()
def shard_module(model: nn.Module, shd, specs: Dict[str, tuple]
                 ) -> nn.Module:
    """Place every parameter of ``model`` by its spec (keyed as
    ``params_of``) in place: each becomes a DTensor parameter holding its
    shard, and the whole tensor it replaces is freed unless the caller
    holds it. ``NULL`` leaves the model as it is. Returns the model."""
    if shd.mesh is None:
        return model
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        placed = shard_tree(shd, specs[name], p.detach())
        mod.register_parameter(attr, nn.Parameter(
            placed, requires_grad=p.requires_grad))
        del p, placed
    return model


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def params_of(model: nn.Module) -> Dict[str, Tensor]:
    """The model's parameters as a dict of named tensors (detached, sharing
    the module's storage): the ``params`` of ``loss_fn``, ``train_step``
    and the optimizer."""
    return {n: p.detach() for n, p in model.named_parameters()}


@torch.no_grad()
def load_params(model: nn.Module, params: Dict[str, Tensor]) -> nn.Module:
    """Copy ``params`` (named as ``params_of``) into the module's own
    weights, e.g. to serve a trained model; returns the model."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"load_params: names differ: "
                       f"{sorted(set(own) ^ set(params))}")
    for name, p in own.items():
        p.copy_(params[name])
    return model


def _chunk_ce(h: Tensor, t: Tensor, w: Tensor, shd=NULL
              ) -> Tuple[Tensor, Tensor]:
    """Summed next-token CE of one sequence chunk and its count of valid
    targets (t >= 0): float32 logits from h and w in h's dtype, put on
    ("batch", None, "vocab") as the reference puts them (a vocab-sharded
    chunk goes through ``_vocab_ce``)."""
    valid = t >= 0
    safe = torch.clamp(t, min=0).long()
    logits = torch.matmul(h.float(), w.to(h.dtype).float())
    logits = shd.constraint(logits, "batch", None, "vocab")
    if isinstance(logits, DTensor):
        return _vocab_ce(logits, t)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(valid, logz - gold, 0.0)
    return ce.sum(), valid.sum()


def _vocab_ce(logits: DTensor, t: Tensor) -> Tuple[DTensor, DTensor]:
    """``_chunk_ce``'s sums from logits (B, ck, V) whose vocab dim is
    sharded: the per-rank program of a logsumexp and a gold-logit gather
    across the vocab shards. Each rank takes its slice's max (all-reduce
    MAX, no gradient: the shift cancels), its sum of exp (all-reduce SUM)
    and the gold logits that fall in its slice (all-reduce SUM: zero
    elsewhere, so each target's logit is read once). The sums over the
    batch rows come back as partial sums over the batch's mesh dims,
    reduced to replicated scalars."""
    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == 2]
    rows = [i for i, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim < 2]
    row_pl = [p if i in rows else Replicate()
              for i, p in enumerate(logits.placements)]
    t_l = (t.redistribute(mesh, row_pl) if isinstance(t, DTensor)
           else distribute_tensor(t, mesh, row_pl)).to_local()
    lg = logits.to_local()
    v0 = shard_index(mesh, tuple(mesh.mesh_dim_names[i]
                                 for i in vocab))[0] * lg.shape[-1]
    m = reduce_partial(lg.detach().amax(-1), mesh, row_pl, vocab,
                       "max").to_local()
    se = reduce_partial(torch.exp(lg - m[..., None]).sum(-1), mesh, row_pl,
                        vocab).to_local()
    logz = m + torch.log(se)
    at = t_l.long() - v0
    mine = (at >= 0) & (at < lg.shape[-1])
    gold = torch.gather(lg, -1, torch.where(mine, at, 0)[..., None])[..., 0]
    gold = reduce_partial(torch.where(mine, gold, 0.0), mesh, row_pl,
                          vocab).to_local()
    valid = t_l >= 0
    ce = torch.where(valid, logz - gold, 0.0)
    rep_pl = [Replicate()] * mesh.ndim
    return (reduce_partial(ce.sum(), mesh, rep_pl, rows),
            reduce_partial(valid.sum(), mesh, rep_pl, rows))


def loss_fn(model: Transformer, params: Dict[str, Tensor], tokens: Tensor,
            targets: Tensor, *, remat: bool = True, shd=NULL
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token CE over ``params``, in sequence chunks of
    ``cfg.loss_chunk`` (halved until they divide S), each chunk
    checkpointed with ``remat`` so its (B, chunk, V) float32 logits are
    recomputed in the backward. Targets < 0 are masked; the mean is over
    max(valid, 1) targets. Returns (ce + aux_loss_weight x aux, {ce, aux})
    with aux the MoE layers' summed load-balance loss (zero without
    them).

    ``shd`` runs through the blocks; the hidden stream leaves sequence
    parallelism, ("batch", None, None), before the chunks are cut, and
    each chunk's logits are vocab-sharded, as in the reference."""
    cfg = model.cfg
    x = shd.constraint(model.embed_tokens(tokens, params), "batch", "seq_sp",
                       None)
    h, aux, _ = model.run_blocks(x, params, remat=remat, shd=shd)
    h = shd.constraint(h, "batch", None, None)
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    s = h.shape[1]
    ck = min(cfg.loss_chunk, s)
    while s % ck != 0:
        ck //= 2
    sums, counts = [], []
    for c0 in range(0, s, ck):
        args = (h[:, c0:c0 + ck], targets[:, c0:c0 + ck], w, shd)
        ce_sum, n = (checkpoint(_chunk_ce, *args, use_reentrant=False)
                     if remat else _chunk_ce(*args))
        sums.append(ce_sum)
        counts.append(n)
    n_valid = torch.clamp(torch.stack(counts).sum(), min=1)
    ce = torch.stack(sums).sum() / n_valid
    return ce + cfg.aux_loss_weight * aux, {"ce": ce, "aux": aux}


def value_and_grad(loss: Callable, params: Dict[str, Tensor], *args,
                   **kwargs):
    """(loss(params_with_grad, ...), parts) and its grads, keyed as
    ``params``, under ``layers.float32_accumulation`` across the forward,
    the backward and every checkpoint recompute. A parameter the loss does
    not read gets a zero grad, as ``jax.grad`` gives."""
    with L.float32_accumulation():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        value, parts = loss(p, *args, **kwargs)
        grads = torch.autograd.grad(value, list(p.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    parts = {k: v.detach() for k, v in parts.items()}
    return value.detach(), parts, dict(zip(p, grads))


def train_step(model: Transformer, params: Dict[str, Tensor],
               opt_state: opt.AdamWState, batch: Dict[str, Tensor],
               opt_cfg: opt.AdamWConfig, *, remat: bool = True, shd=NULL):
    """(params, opt_state, {tokens, targets}) -> (params, opt_state,
    metrics {loss, ce, aux, lr, grad_norm}); the inputs are left as they
    were. With ``shd`` the params, state and batch are placed by their
    specs (``param_specs``, ``opt.state_specs``, ``batch_specs``)."""
    with shd.scope():
        loss, parts, grads = value_and_grad(
            lambda p: loss_fn(model, p, batch["tokens"], batch["targets"],
                              remat=remat, shd=shd), params)
        params, opt_state, om = opt.update(opt_cfg, grads, opt_state,
                                           params)
    return params, opt_state, {"loss": loss, **parts, **om}


# ---------------------------------------------------------------------------
# serving: prefill + decode with stacked KV caches
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor   # (L, B, S_max, n_kv, hd)
    v: Tensor


def cache_specs() -> KVCache:
    """Logical specs of the caches: layer, batch, slot, kv head, dim."""
    spec = (None, "batch", "kv_seq", "kv_heads", None)
    return KVCache(spec, spec)


def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device="cuda",
               shd=NULL) -> KVCache:
    """Zero caches (L, B, max_len, n_kv, hd) in the activation dtype; with
    ``shd`` placed by ``cache_specs`` (each rank allocates its shard)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    if shd.mesh is not None:
        pl = shd.placements(cache_specs().k, shape, unit_axes=False)
        return KVCache(*(dtensor_zeros(shape, dtype=cfg.adtype,
                                       device_mesh=shd.mesh, placements=pl)
                         for _ in range(2)))
    dev = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=cfg.adtype, device=dev),
                   torch.zeros(shape, dtype=cfg.adtype, device=dev))


def _cache_write(cache: Tensor, layer: int, val: Tensor, s0: int,
                 s1: int) -> None:
    """cache[layer, :, s0:s1] = val (B, s1 - s0, n_kv, hd); a placed
    cache takes ``val`` in its layout and writes its own shard."""
    if not isinstance(cache, DTensor):
        cache[layer, :, s0:s1] = val
        return
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()
          for p in cache.placements]
    val = (val.redistribute(cache.device_mesh, pl) if isinstance(val, DTensor)
           else distribute_tensor(val, cache.device_mesh, pl))
    cache.to_local()[layer, :, s0:s1] = val.to_local()


def _cache_layer(cache: Tensor, layer: int) -> Tensor:
    """Layer ``layer`` of a cache, a view that writes go through."""
    if not isinstance(cache, DTensor):
        return cache[layer]
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()
          for p in cache.placements]
    return DTensor.from_local(cache.to_local()[layer], cache.device_mesh, pl,
                              run_check=False, shape=cache.shape[1:],
                              stride=cache[layer].stride())


@torch.no_grad()
@L.float32_accumulation()
def prefill(model: Transformer, tokens: Tensor, max_len: int, shd=NULL
            ) -> Tuple[Tensor, KVCache]:
    """Run the prompt (B, S) -> (last position's logits (B, V) f32, the
    caches filled at positions [0, S) and zero up to ``max_len``). The
    blocks run as in ``forward``: chunked layers attend within windows
    when S exceeds one, and the MoE routes at the config's capacity
    factor and expert chunks. With ``shd`` the caches are placed by
    ``cache_specs`` and each block's constraints apply."""
    cfg = model.cfg
    b, s = tokens.shape
    with shd.scope():
        cache = init_cache(cfg, b, max_len, device=tokens.device, shd=shd)
        x = model.embed_tokens(tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for i, blk in enumerate(model.blocks):
            x, _, _, k, v = blk(x, positions, shd=shd)
            _cache_write(cache.k, i, k, 0, s)
            _cache_write(cache.v, i, v, 0, s)
        x = model.ln_f(x)
        return model.logits(x[:, -1:])[:, 0], cache


@torch.no_grad()
@L.float32_accumulation()
def decode_step(model: Transformer, token: Tensor, cache: KVCache, pos: int,
                shd=NULL) -> Tuple[Tensor, KVCache]:
    """One decode step: token (B,) at position ``pos`` (the same for every
    row). Updates the caches in place; returns (logits (B, V) f32,
    cache). A chunked layer attends within ``pos``'s window when the
    cache is longer than one; MoE layers route the B tokens at
    ``DECODE_CAPACITY_FACTOR`` in one expert block, whatever the
    config's. ``shd`` reaches the attention and the MoE, as in the
    reference (its decode adds no residual constraint)."""
    cfg = model.cfg
    with shd.scope():
        x = model.embed_tokens(token[:, None])
        for i, blk in enumerate(model.blocks):
            a, _, _ = L.attention_decode(
                blk.attn, blk.ln1(x), pos, _cache_layer(cache.k, i),
                _cache_layer(cache.v, i), n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
                chunk=blk.attn_chunk(cache.k.shape[2]), shd=shd)
            x = x + a
            ff, _ = blk.feed_forward(blk.ln2(x), DECODE_CAPACITY_FACTOR, 1,
                                     shd=shd)
            x = x + ff
        x = model.ln_f(x)
        return model.logits(x)[:, 0], cache

"""ColPali-style retrieval encoder: the paper's backbone (ColQwen2.5 class).

The counterpart of ``repro.models.colpali`` (its serving half):

  * documents arrive as precomputed patch embeddings (B, M, d_patch), what
    a frozen vision tower would emit (the modality frontend is a stub, as
    in the reference); ``patch_proj`` maps them into the LM's d_model;
    queries are token ids through the LM's embedding table;
  * the LM backbone (qwen2-1.5b in the colpali-hpc config) contextualises
    the sequence, causally; padded patches and tokens still attend, as in
    the reference, and are masked afterwards;
  * ``out_proj`` maps hidden states to the D=128 retrieval space,
    L2-normalised in the activation dtype, then returned as float32;
  * the backbone's last-layer attention mass per position, over S, is the
    salience that drives the paper's §III-C pruning. It sums to
    ``n_heads`` over a sequence before the mask.

Training: in-batch contrastive late interaction (ColPali's objective),
a softmax over MaxSim(query_i, doc_j) / temperature with the matching doc
on the diagonal. ``contrastive_loss`` and ``train_step`` take the encoder
and a dict of named tensors (``transformer.params_of``) and run the
backbone through ``Transformer.run_blocks`` with a checkpoint per block,
as the reference does; the salience is not computed there (the loss does
not read it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import late_interaction as li
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import NULL
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ColPaliConfig:
    name: str = "colpali"
    backbone: T.LMConfig = dataclasses.field(default_factory=T.LMConfig)
    d_patch: int = 768           # frozen vision-tower output dim (stub)
    proj_dim: int = 128          # retrieval embedding dim (paper: D=128)
    n_patches: int = 64          # patches per document page
    query_len: int = 32          # query token budget
    temperature: float = 0.02

    def param_count(self) -> int:
        return (self.backbone.param_count()
                + self.d_patch * self.backbone.d_model
                + self.backbone.d_model * self.proj_dim)


class ColPaliEncoder(nn.Module):
    """``patch_proj`` (d_patch, D), the ``backbone`` Transformer and
    ``out_proj`` (D, proj_dim), allocated on ``device`` (default ``cuda``)
    and left undrawn (``init`` or ``convert.colpali_params_from_numpy``
    fills them)."""

    def __init__(self, cfg: ColPaliConfig, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        bb = cfg.backbone
        self.cfg = cfg
        self.backbone = T.Transformer(bb, device=dev)
        self.patch_proj = nn.Parameter(torch.empty(
            (cfg.d_patch, bb.d_model), dtype=bb.pdtype, device=dev))
        self.out_proj = nn.Parameter(torch.empty(
            (bb.d_model, cfg.proj_dim), dtype=bb.pdtype, device=dev))

    def _patch_inputs(self, patches: Tensor,
                      params: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """Patches (B, M, d_patch) -> (B, M, D) in the activation dtype."""
        dt = self.cfg.backbone.adtype
        w = self.patch_proj if params is None else params["patch_proj"]
        return patches.to(dt) @ w.to(dt)

    def _encode(self, x: Tensor, mask: Tensor,
                params: Optional[Dict[str, Tensor]], want_salience: bool,
                remat: bool = False, shd=NULL
                ) -> Tuple[Tensor, Optional[Tensor]]:
        """Embedded inputs (B, S, D) -> (embeddings (B, S, proj_dim) f32,
        L2-normalised (the norm in float32, the division in the activation
        dtype), and the salience or None; both zero where ``mask`` is
        False), over the module's weights or ``params``."""
        bp = None if params is None else _backbone_params(params)
        h, _, sal = self.backbone.run_blocks(x, bp,
                                             want_salience=want_salience,
                                             remat=remat, shd=shd)
        w = self.out_proj if params is None else params["out_proj"]
        # the sequence gathered before the product flattens it, as the
        # blocks' inputs are (``transformer.Block.forward``)
        h = shd.constraint(h, "batch", None, None)
        e = h @ w.to(h.dtype)
        norm = torch.linalg.vector_norm(e.float(), dim=-1, keepdim=True)
        e = e / norm.clamp_min(1e-6).to(e.dtype)
        e = (e * mask[..., None].to(e.dtype)).float()
        return e, (sal * mask.to(sal.dtype) if want_salience else None)

    @torch.no_grad()
    @L.float32_accumulation()
    def encode_doc(self, patches: Tensor, patch_mask: Tensor, shd=NULL
                   ) -> Tuple[Tensor, Tensor]:
        """patches (B, M, d_patch) -> (embeddings (B, M, proj_dim) f32,
        salience (B, M) f32), both zero on padded patches. With ``shd``
        the projected patches are put on ("batch", None, None), as in the
        reference; a placed result is for the caller to take whole
        (``dist.sharding.full_tensor``) before a kernel reads it."""
        with shd.scope():
            x = shd.constraint(self._patch_inputs(patches), "batch", None,
                               None)
            return self._encode(x, patch_mask, None, True, shd=shd)

    @torch.no_grad()
    @L.float32_accumulation()
    def encode_query(self, tokens: Tensor, token_mask: Tensor, shd=NULL
                     ) -> Tuple[Tensor, Tensor]:
        """tokens (B, Lq) -> (embeddings (B, Lq, proj_dim) f32, salience
        (B, Lq) f32), both zero on padded tokens."""
        with shd.scope():
            return self._encode(self.backbone.embed_tokens(tokens),
                                token_mask, None, True, shd=shd)


def _backbone_params(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {n[len("backbone."):]: t for n, t in params.items()
            if n.startswith("backbone.")}


def encode_doc_train(enc: ColPaliEncoder, params: Dict[str, Tensor],
                     patches: Tensor, patch_mask: Tensor, *,
                     remat: bool = True, shd=NULL) -> Tensor:
    """``encode_doc``'s embeddings over ``params``, differentiable in
    them; no salience."""
    x = shd.constraint(enc._patch_inputs(patches, params), "batch", None,
                       None)
    return enc._encode(x, patch_mask, params, False, remat, shd)[0]


def encode_query_train(enc: ColPaliEncoder, params: Dict[str, Tensor],
                       tokens: Tensor, token_mask: Tensor, *,
                       remat: bool = True, shd=NULL) -> Tensor:
    """``encode_query``'s embeddings over ``params``, differentiable in
    them; no salience."""
    x = enc.backbone.embed_tokens(tokens, _backbone_params(params))
    return enc._encode(x, token_mask, params, False, remat, shd)[0]


def param_specs(cfg: ColPaliConfig) -> Dict[str, tuple]:
    """Logical specs of every parameter, keyed as ``params_of``."""
    s = {f"backbone.{k}": v for k, v in T.param_specs(cfg.backbone).items()}
    s.update(patch_proj=(None, "embed"), out_proj=("embed", None))
    return s


def batch_specs() -> Dict[str, tuple]:
    """Logical specs of a contrastive batch."""
    return {"query_tokens": ("batch", None), "query_mask": ("batch", None),
            "doc_patches": ("batch", None, None),
            "doc_mask": ("batch", None)}


def contrastive_loss(enc: ColPaliEncoder, params: Dict[str, Tensor],
                     batch: Dict[str, Tensor], *, remat: bool = True,
                     shd=NULL) -> Tuple[Tensor, Dict[str, Tensor]]:
    """In-batch late-interaction contrastive loss over ``params``.

    batch: query_tokens (B, Lq), query_mask, doc_patches (B, M, d_patch),
    doc_mask. Positive pairs on the diagonal. Returns (loss, {acc}): acc
    is the share of queries whose best doc (the first maximum) is their
    own."""
    q = encode_query_train(enc, params, batch["query_tokens"],
                           batch["query_mask"], remat=remat, shd=shd)
    d = encode_doc_train(enc, params, batch["doc_patches"],
                         batch["doc_mask"], remat=remat, shd=shd)
    scores = li.maxsim(q, batch["query_mask"], d, batch["doc_mask"])
    scores = scores / enc.cfg.temperature
    b = scores.shape[0]
    labels = torch.arange(b, device=scores.device)
    logz = torch.logsumexp(scores, dim=-1)
    gold = scores[labels, labels]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(scores, dim=-1) == labels).float())
    return loss, {"acc": acc}


def train_step(enc: ColPaliEncoder, params: Dict[str, Tensor],
               opt_state: opt.AdamWState, batch: Dict[str, Tensor],
               opt_cfg: opt.AdamWConfig, *, remat: bool = True, shd=NULL):
    """(params, opt_state, batch) -> (params, opt_state, metrics {loss,
    acc, lr, grad_norm}); the inputs are left as they were."""
    with shd.scope():
        loss, parts, grads = T.value_and_grad(
            lambda p: contrastive_loss(enc, p, batch, remat=remat, shd=shd),
            params)
        params, opt_state, om = opt.update(opt_cfg, grads, opt_state,
                                           params)
    return params, opt_state, {"loss": loss, **parts, **om}


def init(cfg: ColPaliConfig, *, generator: torch.Generator, device="cuda"
         ) -> ColPaliEncoder:
    """An encoder with weights drawn from ``generator`` (on ``device``) by
    the reference's distributions (``transformer.draw_weights`` for the
    backbone, normal x 1/sqrt(in) for the two projections)."""
    enc = ColPaliEncoder(cfg, device=device)
    bb = cfg.backbone
    T.draw_weights(enc.backbone, generator)
    with torch.no_grad():
        enc.patch_proj.copy_(L.dense_init(generator, cfg.d_patch,
                                          bb.d_model, bb.pdtype))
        enc.out_proj.copy_(L.dense_init(generator, bb.d_model, cfg.proj_dim,
                                        bb.pdtype))
    return enc

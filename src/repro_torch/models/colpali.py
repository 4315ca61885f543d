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

The contrastive loss and the train step wait for the training slice
(ROADMAP.md §A item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

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

    def _embed_out(self, h: Tensor, mask: Tensor) -> Tensor:
        """Hidden states -> L2-normalised (norm in float32, the division in
        the activation dtype), masked, returned as float32."""
        e = h @ self.out_proj.to(h.dtype)
        norm = torch.linalg.vector_norm(e.float(), dim=-1, keepdim=True)
        e = e / norm.clamp_min(1e-6).to(e.dtype)
        e = e * mask[..., None].to(e.dtype)
        return e.float()

    @torch.no_grad()
    @L.float32_accumulation()
    def encode_doc(self, patches: Tensor, patch_mask: Tensor
                   ) -> Tuple[Tensor, Tensor]:
        """patches (B, M, d_patch) -> (embeddings (B, M, proj_dim) f32,
        salience (B, M) f32), both zero on padded patches."""
        dt = self.cfg.backbone.adtype
        x = patches.to(dt) @ self.patch_proj.to(dt)
        h, sal = self.backbone.forward_embeddings(x, want_salience=True)
        return (self._embed_out(h, patch_mask),
                sal * patch_mask.to(sal.dtype))

    @torch.no_grad()
    @L.float32_accumulation()
    def encode_query(self, tokens: Tensor, token_mask: Tensor
                     ) -> Tuple[Tensor, Tensor]:
        """tokens (B, Lq) -> (embeddings (B, Lq, proj_dim) f32, salience
        (B, Lq) f32), both zero on padded tokens."""
        x = self.backbone.embed_tokens(tokens)
        h, sal = self.backbone.forward_embeddings(x, want_salience=True)
        return (self._embed_out(h, token_mask),
                sal * token_mask.to(sal.dtype))


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

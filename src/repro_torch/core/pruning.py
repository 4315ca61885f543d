"""Attention-guided dynamic pruning (HPC-ColPali §III-C), in PyTorch.

The counterpart of ``repro.core.pruning``: keep the top-p% most salient
patches, ceil(M * p / 100) of them, computed in Python. The selection is a
stable descending sort, so equal salience keeps the lowest patch index
first, the order ``lax.top_k`` gives. ``salience_from_attention`` turns
an attention tensor into that salience; ``compute_saved_fraction`` is the
compute the pruning saves.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor
NEG_INF = -1e30


class Pruned(NamedTuple):
    """Result of top-p pruning on a bag of patch embeddings."""

    embeddings: Tensor  # (..., M_keep, D)
    indices: Tensor     # (..., M_keep) int32 — positions kept, salience-desc
    mask: Tensor        # (..., M_keep) bool — False for padded/invalid slots
    salience: Tensor    # (..., M_keep) — salience of kept patches


def keep_count(m: int, p: float) -> int:
    """ceil(M * p / 100), clamped to [1, M]."""
    return max(1, min(m, int(math.ceil(m * p / 100.0))))


def _top_salience(salience: Tensor, mask: Tensor,
                  m_keep: int) -> Tuple[Tensor, Tensor]:
    masked = torch.where(mask.to(torch.bool), salience, NEG_INF)
    srt = torch.sort(masked, dim=-1, descending=True, stable=True)
    return srt.values[..., :m_keep], srt.indices[..., :m_keep]


def prune_topp(embeddings: Tensor, salience: Tensor, mask: Tensor, *,
               p: float) -> Pruned:
    """Keep the top-p% most salient patches of (..., M, D) embeddings.

    Invalid patches get NEG_INF salience, so they are kept only when fewer
    than M_keep valid ones exist, and then with mask False and zeroed
    embeddings.
    """
    m_keep = keep_count(embeddings.shape[-2], p)
    top_sal, top_idx = _top_salience(salience, mask, m_keep)
    kept_mask = top_sal > NEG_INF / 2
    kept = torch.take_along_dim(embeddings, top_idx[..., None], dim=-2)
    kept = kept * kept_mask[..., None].to(kept.dtype)
    return Pruned(kept, top_idx.to(torch.int32), kept_mask, top_sal)


def prune_topp_codes(codes: Tensor, salience: Tensor, mask: Tensor, *,
                     p: float):
    """prune_topp over integer codes (..., M) -> (kept codes, indices,
    mask, salience). Codes are gathered as int32 (torch has no gather for
    uint16) and returned in their own dtype."""
    m_keep = keep_count(codes.shape[-1], p)
    top_sal, top_idx = _top_salience(salience, mask, m_keep)
    kept_mask = top_sal > NEG_INF / 2
    kept = torch.take_along_dim(codes.to(torch.int32), top_idx, dim=-1)
    return kept.to(codes.dtype), top_idx.to(torch.int32), kept_mask, top_sal


def compute_saved_fraction(m: int, p: float) -> float:
    """Fraction of late-interaction compute removed by pruning one side to
    p%: the doc factor of O(Mq * Md) falls to ceil(M*p/100)/M."""
    return 1.0 - keep_count(m, p) / m


def salience_from_attention(attn: Tensor,
                            query_len_mask: Optional[Tensor] = None
                            ) -> Tensor:
    """Aggregate a (..., H, Tq, Tk) attention tensor into per-position
    salience (..., Tk): the mean over heads and query positions of the
    attention mass key j receives, times the optional mask."""
    sal = attn.mean(dim=(-3, -2))
    if query_len_mask is not None:
        sal = sal * query_len_mask.to(sal.dtype)
    return sal

"""The flat index over a quantized patch corpus, in PyTorch.

The counterpart of the flat part of ``repro.core.index``: an exhaustive
fused ADC scan over the (pruned) codes, streamed through core/scan.py.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import scan as scan_mod

Tensor = torch.Tensor


class FlatIndex(NamedTuple):
    codes: Tensor       # (N, Md) uint8/uint16 centroid indices
    mask: Tensor        # (N, Md) bool
    codebook: Tensor    # (K, D) float32
    doc_ids: Tensor     # (N,) int32 global ids


def build_flat(codes: Tensor, mask: Tensor, codebook: Tensor,
               doc_ids: Optional[Tensor] = None) -> FlatIndex:
    if doc_ids is None:
        doc_ids = torch.arange(codes.shape[0], dtype=torch.int32,
                               device=codes.device)
    return FlatIndex(codes, mask, codebook, doc_ids)


def search_flat(index: FlatIndex, q: Tensor, q_mask: Tensor, *, k: int,
                scan: Optional[scan_mod.ScanConfig] = None
                ) -> Tuple[Tensor, Tensor]:
    """Exhaustive ADC MaxSim scan -> (scores (B, k), doc_ids (B, k)); rows
    beyond N (k > N) carry id -1 and the -inf sentinel."""
    return scan_mod.quantized_maxsim_topk(
        q, q_mask, index.codes, index.mask, index.codebook, k=k,
        doc_ids=index.doc_ids, scan=scan)


def _gather_candidates(candidate_ids: Tensor, doc_ids: Tensor,
                       *leaves: Tensor) -> Tuple[Tensor, Tensor, Tuple[Tensor, ...]]:
    """Gather per-query candidate rows (B, P) of corpus *positions* (-1 =
    empty slot) -> (global ids (B, P), valid (B, P), leaves (B, P, ...))."""
    valid = candidate_ids >= 0
    safe = torch.clamp(candidate_ids, min=0).to(torch.int64)
    ids = torch.where(valid, doc_ids[safe], -1).to(torch.int32)
    return ids, valid, tuple(leaf[safe] for leaf in leaves)


def search_flat_candidates(index: FlatIndex, q: Tensor, q_mask: Tensor,
                           candidate_ids: Tensor, *, k: int,
                           scan: Optional[scan_mod.ScanConfig] = None
                           ) -> Tuple[Tensor, Tensor]:
    """ADC MaxSim over a (B, P) candidate pool, through the scan's
    per-query layout; -1 slots and k > P rows carry the sentinel."""
    ids, valid, (codes, mask) = _gather_candidates(
        candidate_ids, index.doc_ids, index.codes, index.mask)
    return scan_mod.quantized_maxsim_topk(
        q, q_mask, codes, mask, index.codebook, k=k,
        doc_ids=ids, valid=valid, scan=scan)

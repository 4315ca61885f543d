"""Exhaustive indexes over a patch corpus, in PyTorch.

The counterpart of the monolithic (unsegmented) flat, float-flat and
Hamming parts of ``repro.core.index``. Each is an exhaustive scan streamed
through core/scan.py, plus a candidate search that scores a (B, P) pool of
corpus positions through the scan's per-query layout:

  * FlatIndex      — fused ADC scan over the (pruned) quantized codes;
  * FloatFlatIndex — float MaxSim over raw embeddings (ColPali-Full);
  * HammingIndex   — popcount MaxSim over b-bit codes.
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


class FloatFlatIndex(NamedTuple):
    """Uncompressed baseline (ColPali-Full)."""
    embeddings: Tensor  # (N, Md, D) float32
    mask: Tensor        # (N, Md) bool
    doc_ids: Tensor     # (N,) int32


def build_float_flat(embeddings: Tensor, mask: Tensor,
                     doc_ids: Optional[Tensor] = None) -> FloatFlatIndex:
    if doc_ids is None:
        doc_ids = torch.arange(embeddings.shape[0], dtype=torch.int32,
                               device=embeddings.device)
    return FloatFlatIndex(embeddings, mask, doc_ids)


def search_float_flat(index: FloatFlatIndex, q: Tensor, q_mask: Tensor, *,
                      k: int, scan: Optional[scan_mod.ScanConfig] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Exhaustive float MaxSim scan, streamed (see search_flat)."""
    return scan_mod.maxsim_topk(q, q_mask, index.embeddings, index.mask,
                                k=k, doc_ids=index.doc_ids, scan=scan)


def search_float_flat_candidates(index: FloatFlatIndex, q: Tensor,
                                 q_mask: Tensor, candidate_ids: Tensor, *,
                                 k: int,
                                 scan: Optional[scan_mod.ScanConfig] = None
                                 ) -> Tuple[Tensor, Tensor]:
    """Float MaxSim over a (B, P) candidate pool: the cascade's rerank.
    The positions go to the scan as ``rows``, so the kernel reads each
    candidate's embeddings through its id and the pool's (B, P, Md, D)
    embeddings are never copied; only the ids are mapped here."""
    ids, valid, _ = _gather_candidates(candidate_ids, index.doc_ids)
    return scan_mod.maxsim_topk(q, q_mask, index.embeddings, index.mask, k=k,
                                doc_ids=ids, valid=valid, scan=scan,
                                rows=candidate_ids.to(torch.int32))


class HammingIndex(NamedTuple):
    codes: Tensor     # (N, Md) uint16 b-bit codes
    mask: Tensor      # (N, Md) bool
    doc_ids: Tensor   # (N,) int32
    bits: int         # b = ceil(log2 K)


def build_hamming(codes: Tensor, mask: Tensor, bits: int,
                  doc_ids: Optional[Tensor] = None) -> HammingIndex:
    if doc_ids is None:
        doc_ids = torch.arange(codes.shape[0], dtype=torch.int32,
                               device=codes.device)
    return HammingIndex(codes.to(torch.uint16), mask, doc_ids, int(bits))


def search_hamming(index: HammingIndex, q_codes: Tensor, q_mask: Tensor, *,
                   bits: int, k: int,
                   scan: Optional[scan_mod.ScanConfig] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Popcount MaxSim scan, streamed (see search_flat); int32 scores."""
    return scan_mod.hamming_maxsim_topk(
        q_codes, q_mask, index.codes, index.mask, bits=bits, k=k,
        doc_ids=index.doc_ids, scan=scan)


def search_hamming_candidates(index: HammingIndex, q_codes: Tensor,
                              q_mask: Tensor, candidate_ids: Tensor, *,
                              bits: int, k: int,
                              scan: Optional[scan_mod.ScanConfig] = None
                              ) -> Tuple[Tensor, Tensor]:
    """Popcount MaxSim over a (B, P) candidate pool (per-query layout)."""
    ids, valid, (codes, mask) = _gather_candidates(
        candidate_ids, index.doc_ids, index.codes, index.mask)
    return scan_mod.hamming_maxsim_topk(
        q_codes, q_mask, codes, mask, bits=bits, k=k, doc_ids=ids,
        valid=valid, scan=scan)


def search_hamming_floor(index: HammingIndex, q_codes: Tensor,
                         q_mask: Tensor, *, bits: int, k: int,
                         scan: Optional[scan_mod.ScanConfig] = None
                         ) -> Tuple[Tensor, Tensor]:
    """Degraded-serving floor: the Hamming scan alone, with its int32
    scores cast to float32 so every rung of the degradation ladder returns
    the same dtypes."""
    scores, ids = search_hamming(index, q_codes, q_mask, bits=bits, k=k,
                                 scan=scan)
    return scores.to(torch.float32), ids

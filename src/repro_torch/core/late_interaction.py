"""Late-interaction (MaxSim) scoring in PyTorch: float and quantized (ADC).

score(q, d) = sum_i  max_j  <q_i, d_j>        (ColBERT / ColPali)

The counterpart of ``repro.core.late_interaction``. These are the
unblocked forms: the streaming scan (core/scan.py) and the CUDA kernel in
kernels/quantized_maxsim.py compute the same scores block by block.

Quantized scoring uses the ADC trick: queries stay float, documents are
1-byte codes, and the query x centroid table T = Q C^T (Mq x K dots, once
per query) turns scoring a document patch into a table lookup.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_max(sim: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
    """Max over the last (doc-patch) axis, ignoring invalid patches.

    sim: (..., Mq, Md), d_mask broadcastable (..., 1, Md) -> (..., Mq).
    """
    return torch.where(d_mask.to(torch.bool), sim, NEG_INF).amax(dim=-1)


def maxsim(q: torch.Tensor, q_mask: torch.Tensor, d: torch.Tensor,
           d_mask: torch.Tensor) -> torch.Tensor:
    """Float late interaction.

    q (B, Mq, D), q_mask (B, Mq) bool, d (N, Md, D), d_mask (N, Md) bool
    -> scores (B, N) float32.
    """
    sim = torch.einsum("bqd,nkd->bnqk", q.float(), d.float())
    per_q = _masked_max(sim, d_mask[None, :, None, :])        # (B, N, Mq)
    per_q = per_q * q_mask[:, None, :].to(per_q.dtype)
    return per_q.sum(dim=-1)


def adc_table(q: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Query-token x centroid similarity table T (B, Mq, K), float32."""
    return torch.einsum("bqd,kd->bqk", q.float(), codebook.float())


def quantized_maxsim(q: torch.Tensor, q_mask: torch.Tensor,
                     d_codes: torch.Tensor, d_mask: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """ADC late interaction over a quantized corpus.

    q (B, Mq, D) float queries, d_codes (N, Md) uint8/uint16 centroid
    indices, codebook (K, D) -> scores (B, N) float32, equal (up to float
    association) to maxsim(q, decode(d_codes)).
    """
    table = adc_table(q, codebook)                            # (B, Mq, K)
    sim = table[:, :, d_codes.to(torch.int64)]                # (B, Mq, N, Md)
    sim = sim.movedim(2, 1)                                   # (B, N, Mq, Md)
    per_q = _masked_max(sim, d_mask[None, :, None, :])
    per_q = per_q * q_mask[:, None, :].to(per_q.dtype)
    return per_q.sum(dim=-1)


def quantized_maxsim_decode(q: torch.Tensor, q_mask: torch.Tensor,
                            d_codes: torch.Tensor, d_mask: torch.Tensor,
                            codebook: torch.Tensor) -> torch.Tensor:
    """Decode-then-score variant (the paper's literal §III-E1 path), kept
    as an equivalence oracle for quantized_maxsim."""
    d = codebook[d_codes.to(torch.int64)]
    return maxsim(q, q_mask, d, d_mask)

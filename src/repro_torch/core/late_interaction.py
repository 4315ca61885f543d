"""Late-interaction (MaxSim) scoring in PyTorch: float and quantized (ADC).

score(q, d) = sum_i  max_j  <q_i, d_j>        (ColBERT / ColPali)

The counterpart of ``repro.core.late_interaction``. These are the
unblocked forms: the streaming scan (core/scan.py) and the CUDA kernels in
kernels/ compute the same scores block by block.

Quantized scoring uses the ADC trick: queries stay float, documents are
1-byte codes, and the query x centroid table T = Q C^T (Mq x K dots, once
per query) turns scoring a document patch into a table lookup. Binary
scoring (§III-D) reads the codes as b-bit strings: sim = b - hamming.
"""
from __future__ import annotations

import torch

from repro_torch.core import binary as binary_mod

NEG_INF = -1e30
# binary_maxsim's masked-patch value: an int32, as in the reference's jnp
# path (repro.core.late_interaction.binary_maxsim)
BINARY_MASKED = -(2 ** 20)


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


def binary_maxsim(q_codes: torch.Tensor, q_mask: torch.Tensor,
                  d_codes: torch.Tensor, d_mask: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """Hamming-similarity late interaction (binary mode, §III-D).

    sim(i, j) = bits - hamming(q_i, d_j); a masked patch counts as the
    int32 ``-(2**20)`` and scores are int32 sums, so an all-masked doc
    scores ``sum_i qm_i * -(2**20)``. q_codes (B, Mq), d_codes (N, Md)
    -> (B, N) int32.
    """
    sim = binary_mod.hamming_sim_matrix(
        q_codes[:, None, :], d_codes[None, :, :], bits)       # (B, N, Mq, Md)
    sim = torch.where(d_mask.to(torch.bool)[None, :, None, :], sim,
                      BINARY_MASKED)
    per_q = sim.amax(dim=-1)                                  # (B, N, Mq)
    per_q = per_q * q_mask[:, None, :].to(torch.int32)
    return per_q.sum(dim=-1, dtype=torch.int32)


def single_vector_score(q: torch.Tensor, q_mask: torch.Tensor,
                        d: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
    """DistilCol-style single-vector baseline: mean-pool both sides, dot.

    (B, Mq, D) x (N, Md, D) -> (B, N).
    """
    qm = q_mask[..., None].to(q.dtype)
    dm = d_mask[..., None].to(d.dtype)
    q_pool = (q * qm).sum(dim=1) / torch.clamp(qm.sum(dim=1), min=1.0)
    d_pool = (d * dm).sum(dim=1) / torch.clamp(dm.sum(dim=1), min=1.0)
    q_pool = q_pool / torch.clamp(
        torch.linalg.vector_norm(q_pool, dim=-1, keepdim=True), min=1e-9)
    d_pool = d_pool / torch.clamp(
        torch.linalg.vector_norm(d_pool, dim=-1, keepdim=True), min=1e-9)
    return q_pool @ d_pool.t()


def late_interaction_flops(mq: int, md: int, d: int, n_docs: int) -> int:
    """FLOPs of one query's float late interaction over n_docs documents."""
    return 2 * mq * md * d * n_docs


def adc_flops(mq: int, md: int, d: int, k: int, n_docs: int) -> int:
    """FLOPs of ADC scoring: one table build (the per-doc gathers, max and
    sum are O(mq*md*n_docs) adds, not counted)."""
    return 2 * mq * k * d

"""Public wrappers over the kernels, dispatched on the tensors' device.

The counterpart of ``repro.kernels.ops``. ``impl="auto"`` launches the
CUDA kernel for CUDA tensors and runs the plain PyTorch version for CPU
tensors (the single policy lives in ``core.scan.resolve_impl``);
``"plain"`` forces the plain version. A CUDA tensor under ``"auto"``
either launches the kernel or raises: nothing falls back to the plain
version. There is no padding: the kernels mask their own ragged edge.
"""
from __future__ import annotations

import torch

from repro_torch.core import late_interaction as li
from repro_torch.core.scan import resolve_impl
from repro_torch.kernels import hamming as hamming_k
from repro_torch.kernels import kmeans_assign as kmeans_k
from repro_torch.kernels import maxsim as maxsim_k
from repro_torch.kernels import quantized_maxsim as qmaxsim_k


def maxsim(q: torch.Tensor, q_mask: torch.Tensor, docs, d_mask, *,
           rows=None, impl: str = "auto") -> torch.Tensor:
    """Float MaxSim scores (B, N) f32: docs (N, Md, D) shared or
    (B, P, Md, D) per query; with ``rows`` (B, P) int32 positions into a
    shared corpus (one tensor or a tuple of segments; -1 = empty slot),
    the rows read in place -> (B, P)."""
    mode = resolve_impl(impl, (rows if rows is not None else docs).device)
    qf = q.to(torch.float32).contiguous()
    qm = q_mask.to(torch.float32).contiguous()
    if mode == "plain":
        return maxsim_k.maxsim_plain(qf, qm, docs, d_mask, rows=rows)
    if rows is not None:
        return maxsim_k.maxsim_cuda(qf, qm, docs, d_mask,
                                    rows=rows.to(torch.int32).contiguous())
    return maxsim_k.maxsim_cuda(qf, qm, docs.to(torch.float32), d_mask)


def quantized_maxsim(q: torch.Tensor, q_mask: torch.Tensor,
                     codes: torch.Tensor, d_mask: torch.Tensor,
                     codebook: torch.Tensor, *, impl: str = "auto"
                     ) -> torch.Tensor:
    """Fused ADC MaxSim scores (B, N) over a quantized corpus: codes
    (N, Md) shared or (B, P, Md) per query."""
    mode = resolve_impl(impl, codes.device)
    table = li.adc_table(q, codebook).contiguous()
    qm = q_mask.to(torch.float32).contiguous()
    if mode == "plain":
        return qmaxsim_k.quantized_maxsim_plain(table, qm, codes, d_mask)
    return qmaxsim_k.quantized_maxsim_cuda(table, qm, codes, d_mask)


def hamming_maxsim(q_codes: torch.Tensor, q_mask: torch.Tensor,
                   d_codes: torch.Tensor, d_mask: torch.Tensor, *, bits: int,
                   impl: str = "auto") -> torch.Tensor:
    """Binary-mode MaxSim scores (B, N) int32 (the reference's wrapper
    returns the same integers as f32): d_codes (N, Md) shared or
    (B, P, Md) per query."""
    mode = resolve_impl(impl, d_codes.device)
    qc = q_codes.to(torch.int32).contiguous()
    qm = q_mask.to(torch.int32).contiguous()
    if mode == "plain":
        return hamming_k.hamming_maxsim_plain(qc, qm, d_codes, d_mask, bits)
    return hamming_k.hamming_maxsim_cuda(qc, qm, d_codes, d_mask, bits)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """Nearest-centroid codes (N,) int32."""
    mode = resolve_impl(impl, x.device)
    if mode == "plain":
        return kmeans_k.kmeans_assign_plain(x, centroids)
    return kmeans_k.kmeans_assign_cuda(x.float().contiguous(),
                                       centroids.float().contiguous())

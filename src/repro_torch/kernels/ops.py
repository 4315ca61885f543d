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
from repro_torch.kernels import kmeans_assign as kmeans_k
from repro_torch.kernels import quantized_maxsim as qmaxsim_k


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


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """Nearest-centroid codes (N,) int32."""
    mode = resolve_impl(impl, x.device)
    if mode == "plain":
        return kmeans_k.kmeans_assign_plain(x, centroids)
    return kmeans_k.kmeans_assign_cuda(x.float().contiguous(),
                                       centroids.float().contiguous())

"""Streaming ADC scan engine: blocked score + top-k fusion, in PyTorch.

The counterpart of ``repro.core.scan``. The corpus is swept in fixed-size
doc blocks; each block is scored by the quantized MaxSim kernel (the CUDA
kernel for CUDA tensors, its plain version for CPU tensors — see
``resolve_impl``) and folded into a running (B, k) top-k merge buffer, so
neither the (B, Mq, N, Md) similarity tensor nor the (B, N) score matrix
ever exists. Peak scan memory is O(B * block_docs) on the kernel path and
O(B * Mq * block_docs * Md) on the plain path.

Numerical contract, as in the reference: blocks are visited in doc order
and the carried buffer sits before the new block in every merge, and the
merge is a *stable* descending sort, so equal scores resolve to the lowest
doc position exactly as one global ``lax.top_k`` would (``torch.topk``
promises no order among equal values, so it is not used).

The two layouts:

  * shared corpus  — codes (N, Md): every query scores every doc;
  * per-query candidates — codes (B, P, Md): each query scores its own
    pool (the facade rerank). Each block goes to the kernel in one
    launch, through the pool's batch stride.

Sentinel contract: rows beyond the valid pool carry doc id -1 and the
merge-buffer init score (-inf), strictly below any real document; slots
with ``valid=False`` score exactly NEG_INF with id -1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import late_interaction as li
from repro_torch.kernels import quantized_maxsim as qmaxsim_k

NEG_INF = li.NEG_INF
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Knobs of the streaming scan.

    block_docs: documents scored per sweep step (one kernel launch).
    impl: "auto" (the CUDA kernel for CUDA tensors, the plain version for
        CPU tensors) or "plain".
    """

    block_docs: int = 256
    impl: str = "auto"


DEFAULT = ScanConfig()


def resolve_impl(impl: str, device) -> str:
    """Resolve the dispatcher key for tensors on ``device``.

    The single auto policy of the port: "auto" is "cuda" for a CUDA
    device and "plain" for the CPU — decided by where the tensors are,
    never by what the host has. "plain" forces the plain version.
    """
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "plain"
    if impl != "plain":
        raise ValueError(f"unknown scan impl {impl!r}; expected auto|plain")
    return impl


def score_sentinel(dtype: torch.dtype):
    """Merge-buffer init value: below every representable real score."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _streaming_topk(score_block: Callable[..., Tensor], payload: tuple,
                    doc_ids: Tensor, valid: Tensor, *, b: int, n: int,
                    k: int, block_docs: int, per_query: bool,
                    score_dtype: torch.dtype,
                    carry: Optional[Tuple[Tensor, Tensor]] = None
                    ) -> Tuple[Tensor, Tensor]:
    """Loop over doc blocks with a running (B, k) top-k merge buffer.

    score_block(*payload_block) -> (B, T) scores for one block; payload
    leaves have the doc axis at dim 1 (per_query) or dim 0 (shared).
    ``carry`` seeds the merge buffer with a previous sweep's
    (scores (B, k), ids (B, k)); it sits first in every merge, so ties
    resolve to the carried (earlier) documents.
    """
    device = doc_ids.device
    sent = score_sentinel(score_dtype)
    if carry is not None:
        top_s = carry[0].to(score_dtype)
        top_i = carry[1].to(torch.int32)
    else:
        top_s = torch.full((b, k), sent, dtype=score_dtype, device=device)
        top_i = torch.full((b, k), -1, dtype=torch.int32, device=device)
    if n == 0:
        return top_s, top_i
    block = max(1, min(block_docs, n))
    axis = 1 if per_query else 0
    doc_ids = doc_ids.to(torch.int32)
    invalid_score = NEG_INF if score_dtype.is_floating_point else sent

    # full blocks, then the ragged N % block tail at its natural size
    for start in range(0, n, block):
        t = min(block, n - start)
        blk = tuple(a.narrow(axis, start, t) for a in payload)
        ids = doc_ids.narrow(doc_ids.dim() - 1, start, t)
        v = valid.narrow(valid.dim() - 1, start, t)
        s = score_block(*blk)                                 # (B, T)
        v = v.expand(s.shape)
        ids = ids.expand(s.shape)
        s = torch.where(v, s, invalid_score)
        ids = torch.where(v, ids, -1)
        cat_s = torch.cat([top_s, s], dim=1)
        cat_i = torch.cat([top_i, ids], dim=1)
        srt, sel = torch.sort(cat_s, dim=1, descending=True, stable=True)
        top_s = srt[:, :k]
        top_i = torch.gather(cat_i, 1, sel[:, :k])
    return top_s, top_i


def _prep(n: int, doc_ids: Optional[Tensor], valid: Optional[Tensor],
          per_query: bool, b: int, device) -> Tuple[Tensor, Tensor]:
    if doc_ids is None:
        doc_ids = torch.arange(n, dtype=torch.int32, device=device)
    if valid is None:
        shape = (b, n) if per_query and doc_ids.dim() == 2 else (n,)
        valid = torch.ones(shape, dtype=torch.bool, device=device)
    return doc_ids, valid


def quantized_maxsim_topk(q: Tensor, q_mask: Tensor, codes: Tensor,
                          d_mask: Tensor, codebook: Tensor, *, k: int,
                          doc_ids: Optional[Tensor] = None,
                          valid: Optional[Tensor] = None,
                          scan: Optional[ScanConfig] = None,
                          carry: Optional[Tuple[Tensor, Tensor]] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Streaming fused ADC MaxSim top-k.

    q (B, Mq, D), q_mask (B, Mq) bool, codebook (K, D);
    codes/d_mask (N, Md) shared or (B, P, Md) per-query candidates.
    Optional doc_ids ((N,) or (B, P)) map scan positions to global ids;
    optional valid ((N,) or (B, P)) marks real pool slots; optional
    carry seeds the merge buffer with a previous sweep's (B, k) result.
    -> (scores (B, k) f32, doc_ids (B, k) int32).
    """
    scan = scan if scan is not None else DEFAULT
    mode = resolve_impl(scan.impl, codes.device)
    per_query = codes.dim() == 3
    b = q.shape[0]
    n = codes.shape[1] if per_query else codes.shape[0]
    table = li.adc_table(q, codebook).contiguous()            # (B, Mq, K)
    q_mask_f = q_mask.to(torch.float32).contiguous()
    doc_ids, valid = _prep(n, doc_ids, valid, per_query, b, codes.device)
    kernel = (qmaxsim_k.quantized_maxsim_cuda if mode == "cuda"
              else qmaxsim_k.quantized_maxsim_plain)

    def score_block(c, m):
        return kernel(table, q_mask_f, c, m)

    return _streaming_topk(score_block, (codes, d_mask), doc_ids, valid,
                           b=b, n=n, k=k, block_docs=scan.block_docs,
                           per_query=per_query, score_dtype=torch.float32,
                           carry=carry)

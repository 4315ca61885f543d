"""Gradient compression for bandwidth-bound data parallelism.

The counterpart of ``repro.optim.grad_compression``, over dicts of named
tensors:

  * int8 stochastic-rounding quantization (4x less all-reduce traffic;
    unbiased, so convergence holds in expectation). The uniform draws come
    from an explicit ``torch.Generator``, so the codes differ from the
    reference's at the same seed; the codec itself is the same;
  * top-k sparsification with error feedback: only the k largest |g|
    entries per tensor are sent, the residual is kept and added back next
    step.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tensor = torch.Tensor


# --- int8 stochastic-rounding codec ----------------------------------------

class QGrad(NamedTuple):
    q: Tensor      # int8
    scale: Tensor  # f32 per-tensor scale, 0-d


def quantize_grad(generator: torch.Generator, g: Tensor) -> QGrad:
    """Round g / scale up with probability equal to its fraction, down
    otherwise (scale = max|g| / 127)."""
    amax = g.abs().amax()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    x = g / scale
    lo = torch.floor(x)
    p_up = x - lo
    up = torch.rand(g.shape, generator=generator, device=g.device) < p_up
    q = torch.clamp(lo + up.to(x.dtype), -127, 127).to(torch.int8)
    return QGrad(q, scale.to(torch.float32))


def dequantize_grad(qg: QGrad) -> Tensor:
    return qg.q.to(torch.float32) * qg.scale


def compress_tree_int8(generator: torch.Generator, grads: Dict[str, Tensor]
                       ) -> Dict[str, QGrad]:
    return {k: quantize_grad(generator, g) for k, g in grads.items()}


def decompress_tree_int8(qtree: Dict[str, QGrad]) -> Dict[str, Tensor]:
    return {k: dequantize_grad(qg) for k, qg in qtree.items()}


def compressed_bytes_int8(grads: Dict[str, Tensor]) -> int:
    return sum(g.numel() + 4 for g in grads.values())


# --- top-k + error feedback -------------------------------------------------

class TopKState(NamedTuple):
    residual: Dict[str, Tensor]   # error-feedback accumulator, float32


def topk_init(grads_template: Dict[str, Tensor]) -> TopKState:
    return TopKState({k: torch.zeros_like(g, dtype=torch.float32)
                      for k, g in grads_template.items()})


def topk_compress(grads: Dict[str, Tensor], state: TopKState, frac: float
                  ) -> Tuple[Dict[str, Tensor], TopKState, dict]:
    """Keep the top-``frac`` entries (by |g|) of (grad + residual) per
    tensor. Returns (dense grads with zeros at the dropped positions, the
    new state, {nnz, total, ratio})."""
    kept, resid = {}, {}
    for name, g in grads.items():
        acc = g.to(torch.float32) + state.residual[name]
        k = max(1, int(acc.numel() * frac))
        flat = acc.reshape(-1)
        # k = max(1, numel * frac) <= numel for frac <= 1
        idx = torch.topk(flat.abs(), k).indices  # noqa: TORCH04
        out = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
        kept[name] = out.reshape(g.shape)
        resid[name] = acc - kept[name]
    nnz = sum(max(1, int(g.numel() * frac)) for g in grads.values())
    total = sum(g.numel() for g in grads.values())
    return kept, TopKState(resid), {"nnz": nnz, "total": total,
                                    "ratio": nnz / total}

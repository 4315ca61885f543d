"""Fused ADC MaxSim: the CUDA kernel's wrapper and its plain version.

    out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j]} T[b, i, codes[n, j]]

The counterpart of ``repro.kernels.quantized_maxsim`` (the Pallas kernel
``quantized_maxsim_pallas``). The kernel is ``csrc/quantized_maxsim.cu``;
its source note says what bounds it on the H100 and how it is laid out.

Both functions take the two layouts of the streaming scan:

  * shared corpus — codes/d_mask (N, Md): every query scores every doc;
  * per-query pools — codes/d_mask (B, P, Md): query b scores its own P.

``quantized_maxsim_cuda`` reads the codes (uint8, or uint16 for K > 256)
and the bool mask as stored, so the scan never widens them in device
memory; a slice of a per-query pool along P goes in as it is, through its
batch stride. ``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.core.late_interaction import NEG_INF
from repro_torch.kernels import _build

launches = 0
_count_lock = threading.Lock()

_CODE_BYTES = {torch.uint8: 1, torch.uint16: 2}
_MASK_DTYPES = (torch.bool, torch.uint8)


def quantized_maxsim_plain(table: torch.Tensor, q_mask: torch.Tensor,
                           codes: torch.Tensor,
                           d_mask: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the counterpart of
    ``repro.kernels.ref.quantized_maxsim``, extended to per-query pools).

    table (B, Mq, K) f32, q_mask (B, Mq) 0/1, codes (N, Md) or (B, P, Md)
    integer, d_mask of the codes' shape (nonzero = valid) -> (B, N) f32.
    """
    b, mq, _ = table.shape
    idx = codes.to(torch.int64)
    if codes.dim() == 3:
        _, p, md = codes.shape
        sim = torch.gather(table, 2, idx.reshape(b, 1, p * md).expand(
            b, mq, p * md)).reshape(b, mq, p, md)             # (B, Mq, P, Md)
        valid = (d_mask != 0)[:, None]
    else:
        sim = table[:, :, idx]                                # (B, Mq, N, Md)
        valid = (d_mask != 0)[None, None]
    per_q = torch.where(valid, sim, NEG_INF).amax(dim=-1)     # (B, Mq, N)
    per_q = per_q * q_mask.to(per_q.dtype)[:, :, None]
    return per_q.sum(dim=1)


def _check_layout(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name} must be contiguous in its last two dims "
                         f"(strides {t.stride()})")


def quantized_maxsim_cuda(table: torch.Tensor, q_mask: torch.Tensor,
                          codes: torch.Tensor,
                          d_mask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    ``quantized_maxsim_plain`` with table/q_mask float32 and contiguous,
    codes uint8/uint16 and d_mask bool/uint8. Codes >= K score as masked
    (quantize never produces them). Raises on anything else."""
    global launches
    if table.device.type != "cuda":
        raise ValueError(f"quantized_maxsim_cuda needs CUDA tensors, got "
                         f"{table.device}")
    for name, t in (("q_mask", q_mask), ("codes", codes), ("d_mask", d_mask)):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")
    if table.dtype != torch.float32 or q_mask.dtype != torch.float32:
        raise ValueError("table and q_mask must be float32")
    if not (table.is_contiguous() and q_mask.is_contiguous()):
        raise ValueError("table and q_mask must be contiguous")
    if codes.dtype not in _CODE_BYTES:
        raise ValueError(f"codes must be uint8 or uint16, got {codes.dtype}")
    if d_mask.dtype not in _MASK_DTYPES:
        raise ValueError(f"d_mask must be bool or uint8, got {d_mask.dtype}")
    b, mq, k = table.shape
    if tuple(q_mask.shape) != (b, mq):
        raise ValueError(f"q_mask has shape {tuple(q_mask.shape)}, expected "
                         f"{(b, mq)}")
    if codes.dim() == 3:
        _, n, md = codes.shape
        _check_layout("codes", codes, (b, n, md))
        code_bstride = codes.stride(0)
    elif codes.dim() == 2:
        n, md = codes.shape
        _check_layout("codes", codes, (n, md))
        code_bstride = 0
    else:
        raise ValueError(f"codes must be (N, Md) or (B, P, Md), got "
                         f"{tuple(codes.shape)}")
    _check_layout("d_mask", d_mask, codes.shape)
    mask_bstride = d_mask.stride(0) if codes.dim() == 3 else 0
    out = torch.empty((b, n), dtype=torch.float32, device=table.device)
    if b == 0 or n == 0:
        return out
    lib = _build.library()
    smem = lib.hpc_qmaxsim_smem_bytes(mq, k, md)
    if smem > 232448:
        raise ValueError(f"quantized_maxsim_cuda needs {smem} B of shared "
                         f"memory at Mq={mq}, K={k}, Md={md}; a block may "
                         "use 232448")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.hpc_qmaxsim(
        table.data_ptr(), q_mask.data_ptr(), codes.data_ptr(),
        _CODE_BYTES[codes.dtype], d_mask.data_ptr(), out.data_ptr(),
        b, mq, k, n, md, code_bstride, mask_bstride, stream)
    _build.check(err, "quantized_maxsim kernel launch")
    with _count_lock:
        launches += 1
    return out

"""Float MaxSim late interaction: the CUDA kernel's wrapper and its plain
version.

    out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j]} <q[b, i], d[n, j]>

The counterpart of ``repro.kernels.maxsim`` (the Pallas kernel
``maxsim_pallas``). The kernel is ``csrc/maxsim.cu``; its source note says
what bounds it on the H100 and how it is laid out. It computes the dot
products itself, in f32 FMAs (no TF32), and a masked patch counts as
-1e30, so an all-masked doc scores ``sum_i qm_i * -1e30``.

Both functions take the two layouts of the streaming scan: a shared corpus
(docs (N, Md, D), d_mask (N, Md)) and per-query pools (docs (B, P, Md, D),
d_mask (B, P, Md)). A slice of a per-query pool along P goes into the
kernel through its batch stride. ``launches`` counts the kernel launches of
this process.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.core.late_interaction import NEG_INF
from repro_torch.kernels import _build

launches = 0
_count_lock = threading.Lock()


def maxsim_plain(q: torch.Tensor, q_mask: torch.Tensor, docs: torch.Tensor,
                 d_mask: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the counterpart of
    ``repro.kernels.ref.maxsim``, extended to per-query pools).

    q (B, Mq, D), q_mask (B, Mq) 0/1, docs (N, Md, D) or (B, P, Md, D),
    d_mask of the docs' leading shape (nonzero = valid) -> (B, N) f32.
    """
    q = q.float()
    if docs.dim() == 4:
        sim = torch.einsum("bqd,bpmd->bqpm", q, docs.float())  # (B, Mq, P, Md)
        valid = (d_mask != 0)[:, None]
    else:
        sim = torch.einsum("bqd,nmd->bqnm", q, docs.float())   # (B, Mq, N, Md)
        valid = (d_mask != 0)[None, None]
    per_q = torch.where(valid, sim, NEG_INF).amax(dim=-1)      # (B, Mq, N)
    per_q = per_q * q_mask.to(per_q.dtype)[:, :, None]
    return per_q.sum(dim=1)


def maxsim_cuda(q: torch.Tensor, q_mask: torch.Tensor, docs: torch.Tensor,
                d_mask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    ``maxsim_plain`` with q and q_mask float32 and contiguous, docs float32
    and d_mask bool/uint8. Raises on anything else."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"maxsim_cuda needs CUDA tensors, got {q.device}")
    for name, t in (("q_mask", q_mask), ("docs", docs), ("d_mask", d_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if (q.dtype != torch.float32 or q_mask.dtype != torch.float32
            or docs.dtype != torch.float32):
        raise ValueError("q, q_mask and docs must be float32")
    if not (q.is_contiguous() and q_mask.is_contiguous()):
        raise ValueError("q and q_mask must be contiguous")
    if d_mask.dtype not in _build.MASK_DTYPES:
        raise ValueError(f"d_mask must be bool or uint8, got {d_mask.dtype}")
    b, mq, d = q.shape
    if tuple(q_mask.shape) != (b, mq):
        raise ValueError(f"q_mask has shape {tuple(q_mask.shape)}, expected "
                         f"{(b, mq)}")
    per_query = docs.dim() == 4
    if per_query:
        _, n, md, _ = docs.shape
        _build.check_layout("docs", docs, (b, n, md, d), batch_strided=True)
    elif docs.dim() == 3:
        n, md, _ = docs.shape
        _build.check_layout("docs", docs, (n, md, d))
    else:
        raise ValueError(f"docs must be (N, Md, D) or (B, P, Md, D), got "
                         f"{tuple(docs.shape)}")
    _build.check_layout("d_mask", d_mask, docs.shape[:-1],
                        batch_strided=per_query)
    if b == 0 or n == 0 or mq == 0:
        return torch.zeros((b, n), dtype=torch.float32, device=q.device)
    if md == 0:
        raise ValueError("maxsim_cuda needs at least one patch per doc")
    lib = _build.library()
    smem = lib.hpc_maxsim_smem_bytes(d)
    if smem > _build.MAX_SMEM:
        raise ValueError(f"maxsim_cuda needs {smem} B of shared memory at "
                         f"D={d}; a block may use {_build.MAX_SMEM}")
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hpc_maxsim(
        q.data_ptr(), q_mask.data_ptr(), docs.data_ptr(), d_mask.data_ptr(),
        out.data_ptr(), b, mq, n, md, d, docs.stride(0) if per_query else 0,
        d_mask.stride(0) if per_query else 0, stream)
    _build.check(err, "maxsim kernel launch")
    with _count_lock:
        launches += 1
    return out

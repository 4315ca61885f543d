"""Binary (Hamming) MaxSim: the CUDA kernel's wrapper and its plain version.

    out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j]}
                    (bits - popcount((q[b, i] ^ codes[n, j]) & (2^bits - 1)))

The counterpart of ``repro.kernels.hamming`` (the Pallas kernel
``hamming_maxsim_pallas``). The kernel is ``csrc/hamming_maxsim.cu``; its
source note says what bounds it on the H100 and how it is laid out.

Scores are int32 on both paths and a masked patch counts as the int32
``-(2**20)``, as in the reference's jnp path (``li.binary_maxsim``). The
TPU kernel accumulates in f32 with -1e30 masking instead; the two differ
only for documents with no valid patch (ROADMAP caveat C4). Every other
score is an exact small integer, so kernel and plain version agree bit for
bit.

Both functions take the two layouts of the streaming scan: a shared corpus
(codes/d_mask (N, Md)) and per-query pools (codes/d_mask (B, P, Md)).
``hamming_maxsim_cuda`` reads the codes (uint8 or uint16) and the bool mask
as stored; a slice of a per-query pool along P goes in through its batch
stride. ``launches`` counts the kernel launches of this process and
``launch_shapes`` maps each distinct launch's ``hpc_hamming_geometry``
arguments to its geometry (``kernels.vmem``). Under a ``FakeTensorMode``
the wrapper launches nothing: it records the launch and returns an empty
output of the declared shape (``vmem.fake_launch``).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.core import binary as binary_mod
from repro_torch.core.late_interaction import BINARY_MASKED
from repro_torch.kernels import _build, vmem

launches = 0
launch_shapes: dict = {}
_count_lock = threading.Lock()


def launch_cost(b: int, mq: int, n: int, md: int, code_bytes: int,
                mask_bytes: int, per_query: bool):
    """(FLOPs, bytes) of one launch with every patch valid: a popcount per
    query patch and doc patch; every input read once, the output written
    once (chip_smoke.py's ``_hamming_cost``)."""
    slots = (b if per_query else 1) * n * md
    pops = mq * slots * (1 if per_query else b)
    return float(pops), float(2 * b * mq * 4 + slots * (code_bytes + mask_bytes)
                              + b * n * 4)


def hamming_maxsim_plain(q_codes: torch.Tensor, q_mask: torch.Tensor,
                         codes: torch.Tensor, d_mask: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``li.binary_maxsim``,
    extended to per-query pools).

    A b-bit code takes one of 2^b values, so the similarity of every query
    patch to every possible code is one small (B, Mq, 2^b) table, and a
    document patch's similarity is a lookup in it (the ADC form of the
    quantized scan; a direct popcount over the (B, Mq, N, Md) block is
    ~10x slower on the CPU).

    q_codes (B, Mq) integer, q_mask (B, Mq) 0/1 weights, codes (N, Md) or
    (B, P, Md) integer, d_mask of the codes' shape (nonzero = valid) ->
    (B, N) int32.
    """
    b, mq = q_codes.shape
    every_code = torch.arange(1 << bits, dtype=torch.int32,
                              device=q_codes.device)
    table = bits - binary_mod.hamming_distance(
        q_codes[:, :, None], every_code, bits)                # (B, Mq, 2^b)
    idx = codes.to(torch.int64) & ((1 << bits) - 1)
    if codes.dim() == 3:
        _, p, md = codes.shape
        sim = torch.gather(table, 2, idx.reshape(b, 1, p * md).expand(
            b, mq, p * md)).reshape(b, mq, p, md)             # (B, Mq, P, Md)
        valid = (d_mask != 0)[:, None]
    else:
        sim = table[:, :, idx]                                # (B, Mq, N, Md)
        valid = (d_mask != 0)[None, None]
    per_q = torch.where(valid, sim, BINARY_MASKED).amax(dim=-1)  # (B, Mq, N)
    per_q = per_q * q_mask.to(torch.int32)[:, :, None]
    return per_q.sum(dim=1, dtype=torch.int32)


def hamming_maxsim_cuda(q_codes: torch.Tensor, q_mask: torch.Tensor,
                        codes: torch.Tensor, d_mask: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    ``hamming_maxsim_plain`` with q_codes and q_mask int32 and contiguous,
    codes uint8/uint16 and d_mask bool/uint8, 1 <= bits <= 16. Raises on
    anything else."""
    global launches
    if q_codes.device.type != "cuda":
        raise ValueError(f"hamming_maxsim_cuda needs CUDA tensors, got "
                         f"{q_codes.device}")
    for name, t in (("q_mask", q_mask), ("codes", codes), ("d_mask", d_mask)):
        if t.device != q_codes.device:
            raise ValueError(f"{name} is on {t.device}, q_codes on "
                             f"{q_codes.device}")
    if q_codes.dtype != torch.int32 or q_mask.dtype != torch.int32:
        raise ValueError("q_codes and q_mask must be int32")
    if not (q_codes.is_contiguous() and q_mask.is_contiguous()):
        raise ValueError("q_codes and q_mask must be contiguous")
    if codes.dtype not in _build.CODE_BYTES:
        raise ValueError(f"codes must be uint8 or uint16, got {codes.dtype}")
    if d_mask.dtype not in _build.MASK_DTYPES:
        raise ValueError(f"d_mask must be bool or uint8, got {d_mask.dtype}")
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in [1, 16], got {bits}")
    b, mq = q_codes.shape
    if tuple(q_mask.shape) != (b, mq):
        raise ValueError(f"q_mask has shape {tuple(q_mask.shape)}, expected "
                         f"{(b, mq)}")
    if codes.dim() == 3:
        _, n, md = codes.shape
        _build.check_layout("codes", codes, (b, n, md), batch_strided=True)
    elif codes.dim() == 2:
        n, md = codes.shape
        _build.check_layout("codes", codes, (n, md))
    else:
        raise ValueError(f"codes must be (N, Md) or (B, P, Md), got "
                         f"{tuple(codes.shape)}")
    _build.check_layout("d_mask", d_mask, codes.shape,
                        batch_strided=codes.dim() == 3)
    per_query = codes.dim() == 3
    geom = vmem.hamming_geometry(b, n, bits)
    key = (b, n, bits)
    cost = launch_cost(b, mq, n, md, _build.CODE_BYTES[codes.dtype],
                       d_mask.element_size(), per_query)
    if vmem.is_fake(q_codes):
        return vmem.fake_launch(geom, q_codes.device, {"args": key},
                                *cost, outputs=(((b, n), torch.int32),))
    out = torch.empty((b, n), dtype=torch.int32, device=q_codes.device)
    if geom is None:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(q_codes.device).cuda_stream
    err = lib.hpc_hamming_maxsim(
        q_codes.data_ptr(), q_mask.data_ptr(), codes.data_ptr(),
        _build.CODE_BYTES[codes.dtype], d_mask.data_ptr(), out.data_ptr(),
        b, mq, n, md, bits, codes.stride(0) if per_query else 0,
        d_mask.stride(0) if per_query else 0, stream)
    _build.check(err, "hamming_maxsim kernel launch")
    with _count_lock:
        launches += 1
        launch_shapes.setdefault(key, geom)
    vmem.record_launch(geom, {"args": key}, *cost)
    return out

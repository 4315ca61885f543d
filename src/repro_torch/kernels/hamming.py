"""Binary (Hamming) MaxSim: the CUDA kernel's wrappers and their plain
versions.

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

Two entries, each with a CUDA wrapper and a plain version:

  * scores: ``hamming_maxsim_{cuda,plain}`` -> (B, N) int32;
  * per-range top-k: ``hamming_maxsim_topk_{cuda,plain}`` split the N
    positions into ranges of ``range_len`` and return each range's top
    ``min(k, range_len)`` as (scores, positions) (B, ranges, min(k, R))
    int32, ordered by score descending, then position ascending. Slots
    with ``valid`` False score the int32 minimum with position -1; a range
    shorter than k is padded with (int32 minimum, -1). The streaming scan
    (``core.scan.hamming_maxsim_topk``) merges the lists once per sweep.

Both take the two layouts of the streaming scan: a shared corpus
(codes/d_mask (N, Md)) and per-query pools (codes/d_mask (B, P, Md)). The
CUDA wrappers read the codes (uint8 or uint16) and the bool mask as
stored; a slice of a per-query pool along P goes in through its batch
stride. ``launches`` counts the kernel launches of both entries in this
process and ``launch_shapes`` maps each distinct launch's
``hpc_hamming_geometry`` arguments to its geometry (``kernels.vmem``).
Under a ``FakeTensorMode`` the wrappers launch nothing: they record the
launch and return empty outputs of the declared shapes
(``vmem.fake_launch``).
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.core import binary as binary_mod
from repro_torch.core.late_interaction import BINARY_MASKED
from repro_torch.kernels import _build, vmem
from repro_torch.kernels.quantized_maxsim import range_topk_plain

launches = 0
launch_shapes: dict = {}
_count_lock = threading.Lock()

# Range lengths of the CUDA launch: at most the kernel's shared score buffer
# (256 slots). A block scores its range for up to 32 queries of the shared
# corpus (one query of a per-query pool), so the launch takes the longest
# range that still gives every SM BLOCKS_PER_SM blocks. chip_smoke.py times
# the stage-1 sweep at half, once and twice the chosen length.
MAX_RANGE = 256
MIN_RANGE = 2
BLOCKS_PER_SM = 2
INVALID = torch.iinfo(torch.int32).min


def launch_range_len(b: int, mq: int, n: int, bits: int, device,
                     per_query: bool = False) -> int:
    """The CUDA launch's range length for B queries over N positions: the
    longest power of two in [MIN_RANGE, MAX_RANGE] whose grid still
    numbers BLOCKS_PER_SM blocks for every SM of the card."""
    qpb = vmem.hamming_queries_per_block(b, mq, bits, per_query)
    groups = -(-b // max(qpb, 1))
    want = BLOCKS_PER_SM * vmem.sm_count(device)
    r = MAX_RANGE
    while r > MIN_RANGE and groups * -(-n // r) < want:
        r //= 2
    return r


def launch_cost(b: int, mq: int, n: int, md: int, code_bytes: int,
                mask_bytes: int, per_query: bool, out_bytes: int):
    """(pairs, bytes) of one launch with every patch valid: a (query
    patch, doc patch) pair per query and doc slot of its docs, standing as
    the operations; every input read once, the outputs written once
    (chip_smoke.py's ``_hamming_cost``)."""
    slots = (b if per_query else 1) * n * md
    pairs = mq * slots * (1 if per_query else b)
    return float(pairs), float(2 * b * mq * 4
                               + slots * (code_bytes + mask_bytes) + out_bytes)


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


def hamming_maxsim_topk_plain(q_codes: torch.Tensor, q_mask: torch.Tensor,
                              codes: torch.Tensor, d_mask: torch.Tensor,
                              valid: Optional[torch.Tensor], *, bits: int,
                              k: int, range_len: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-range top-k in plain PyTorch: the same lists as
    ``hamming_maxsim_topk_cuda``, one range scored at a time (the memory
    of ``hamming_maxsim_plain`` over ``range_len`` docs).

    valid: None (all valid), (N,) or (B, N) bool.
    -> (scores (B, ranges, min(k, R)) int32, positions of the same shape
    int32).
    """
    return range_topk_plain(
        lambda c, m: hamming_maxsim_plain(q_codes, q_mask, c, m, bits),
        codes, d_mask, valid, b=q_codes.shape[0], k=k, range_len=range_len,
        dtype=torch.int32, invalid=INVALID, pad=INVALID)


def _check_inputs(name: str, q_codes: torch.Tensor, q_mask: torch.Tensor,
                  codes: torch.Tensor, d_mask: torch.Tensor, bits: int):
    """Raise on what the kernel does not take; -> (b, mq, n, md, codes'
    batch stride, d_mask's batch stride)."""
    if q_codes.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q_codes.device}")
    for arg, t in (("q_mask", q_mask), ("codes", codes), ("d_mask", d_mask)):
        if t.device != q_codes.device:
            raise ValueError(f"{arg} is on {t.device}, q_codes on "
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
    per_query = codes.dim() == 3
    _build.check_layout("d_mask", d_mask, codes.shape, batch_strided=per_query)
    return (b, mq, n, md, codes.stride(0) if per_query else 0,
            d_mask.stride(0) if per_query else 0)


def _count(geom, key, cost) -> None:
    global launches
    with _count_lock:
        launches += 1
        launch_shapes.setdefault(key, geom)
    vmem.record_launch(geom, {"args": key}, *cost)


def hamming_maxsim_cuda(q_codes: torch.Tensor, q_mask: torch.Tensor,
                        codes: torch.Tensor, d_mask: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """Launch the scores-only kernel on the current stream; same contract
    as ``hamming_maxsim_plain`` with q_codes and q_mask int32 and
    contiguous, codes uint8/uint16 and d_mask bool/uint8, 1 <= bits <= 16.
    A block scores ``launch_range_len`` documents. Raises on anything
    else."""
    b, mq, n, md, c_bs, m_bs = _check_inputs(
        "hamming_maxsim_cuda", q_codes, q_mask, codes, d_mask, bits)
    per_query = codes.dim() == 3
    r = launch_range_len(b, mq, n, bits, q_codes.device, per_query)
    key = (b, mq, n, md, bits, int(per_query), r, 0)
    geom = vmem.hamming_geometry(*key)
    cost = launch_cost(b, mq, n, md, _build.CODE_BYTES[codes.dtype],
                       d_mask.element_size(), per_query, b * n * 4)
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
        b, mq, n, md, bits, c_bs, m_bs, r, stream)
    _build.check(err, "hamming_maxsim kernel launch")
    _count(geom, key, cost)
    return out


def hamming_maxsim_topk_cuda(q_codes: torch.Tensor, q_mask: torch.Tensor,
                             codes: torch.Tensor, d_mask: torch.Tensor,
                             valid: Optional[torch.Tensor], *, bits: int,
                             k: int, range_len: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the per-range top-k kernel on the current stream, one launch
    for all N positions; same contract as ``hamming_maxsim_topk_plain``
    (inputs as ``hamming_maxsim_cuda``; valid None, or bool/uint8 (N,) or
    (B, N) dense along N). ``range_len`` defaults to ``launch_range_len``.
    Raises on anything else."""
    b, mq, n, md, c_bs, m_bs = _check_inputs(
        "hamming_maxsim_topk_cuda", q_codes, q_mask, codes, d_mask, bits)
    v_bs = 0
    if valid is not None:
        if valid.device != q_codes.device:
            raise ValueError(f"valid is on {valid.device}, q_codes on "
                             f"{q_codes.device}")
        if valid.dtype not in _build.MASK_DTYPES:
            raise ValueError(f"valid must be bool or uint8, got "
                             f"{valid.dtype}")
        if valid.dim() == 2:
            _build.check_layout("valid", valid, (b, n), batch_strided=True)
            v_bs = valid.stride(0)
        else:
            _build.check_layout("valid", valid, (n,))
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    per_query = codes.dim() == 3
    r = range_len if range_len is not None else launch_range_len(
        b, mq, n, bits, q_codes.device, per_query)
    if not 1 <= r <= MAX_RANGE:
        raise ValueError(f"range_len must be in [1, {MAX_RANGE}], got {r}")
    kk = min(k, r)
    n_ranges = -(-n // r)
    key = (b, mq, n, md, bits, int(per_query), r, kk)
    geom = vmem.hamming_geometry(*key)
    cost = launch_cost(b, mq, n, md, _build.CODE_BYTES[codes.dtype],
                       d_mask.element_size(), per_query,
                       b * n_ranges * kk * 8 + (
                           0 if valid is None else valid.numel()))
    shape = (b, n_ranges, kk)
    if vmem.is_fake(q_codes):
        return vmem.fake_launch(geom, q_codes.device, {"args": key}, *cost,
                                outputs=((shape, torch.int32),
                                         (shape, torch.int32)))
    out_s = torch.empty(shape, dtype=torch.int32, device=q_codes.device)
    out_p = torch.empty(shape, dtype=torch.int32, device=q_codes.device)
    if geom is None:
        return out_s, out_p
    lib = _build.library()
    stream = torch.cuda.current_stream(q_codes.device).cuda_stream
    err = lib.hpc_hamming_maxsim_topk(
        q_codes.data_ptr(), q_mask.data_ptr(), codes.data_ptr(),
        _build.CODE_BYTES[codes.dtype], d_mask.data_ptr(),
        None if valid is None else valid.data_ptr(), v_bs,
        out_s.data_ptr(), out_p.data_ptr(), b, mq, n, md, bits, c_bs, m_bs,
        r, kk, stream)
    _build.check(err, "hamming_maxsim_topk kernel launch")
    _count(geom, key, cost)
    return out_s, out_p

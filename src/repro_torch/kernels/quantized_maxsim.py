"""Fused ADC MaxSim: the CUDA kernel's wrappers and their plain versions.

    out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j]} T[b, i, codes[n, j]]

The counterpart of ``repro.kernels.quantized_maxsim`` (the Pallas kernel
``quantized_maxsim_pallas``). The kernel is ``csrc/quantized_maxsim.cu``;
its source note says what bounds it on the H100 and how it is laid out.

Two entries, each with a CUDA wrapper and a plain version:

  * scores: ``quantized_maxsim_{cuda,plain}`` -> (B, N) scores;
  * per-range top-k: ``quantized_maxsim_topk_{cuda,plain}`` split the N
    positions into ranges of ``range_len`` and return each range's top
    ``min(k, range_len)`` as (scores, positions) (B, ranges, min(k, R)),
    ordered by score descending, then position ascending. Slots with
    ``valid`` False score exactly NEG_INF with position -1; a range
    shorter than k is padded with (-inf, -1). The streaming scan
    (``core.scan.quantized_maxsim_topk``) merges the lists once per sweep.

All take the two layouts of the streaming scan:

  * shared corpus — codes/d_mask (N, Md): every query scores every doc;
  * per-query pools — codes/d_mask (B, P, Md): query b scores its own P.

The CUDA wrappers read the codes (uint8, or uint16 for K > 256) and the
bool mask as stored, so the scan never widens them in device memory; a
slice of a per-query pool along P goes in as it is, through its batch
stride. ``launches`` counts the kernel launches of both entries in this
process and ``launch_shapes`` maps each distinct launch's
``hpc_qmaxsim_geometry`` arguments to its geometry (``kernels.vmem``).
Under a ``FakeTensorMode`` the wrappers launch nothing: they record the
launch and return empty outputs of the declared shapes
(``vmem.fake_launch``).
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.core.late_interaction import NEG_INF
from repro_torch.kernels import _build, vmem

launches = 0
launch_shapes: dict = {}
_count_lock = threading.Lock()

# Range lengths of the CUDA launch: at most the kernel's shared score buffer
# (256 slots). The launch takes the longest range that still gives every SM
# BLOCKS_PER_SM (query, range) pairs, but no shorter than MIN_RANGE: a
# block stages a 32 KB table whatever its range, so a block of a tiny pool
# should still score a few documents. chip_smoke.py times the sweep, the
# rerank and stage 2 at half, once and twice the chosen length.
MAX_RANGE = 256
MIN_RANGE = 2
BLOCKS_PER_SM = 1

def launch_range_len(b: int, n: int, device) -> int:
    """The CUDA launch's range length for B queries over N positions: the
    longest power of two in [MIN_RANGE, MAX_RANGE] whose B x ranges still
    number BLOCKS_PER_SM for every SM of the card."""
    want = BLOCKS_PER_SM * vmem.sm_count(device)
    r = MAX_RANGE
    while r > MIN_RANGE and b * -(-n // r) < want:
        r //= 2
    return r


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


def range_topk_plain(score, codes: torch.Tensor, d_mask: torch.Tensor,
                     valid: Optional[torch.Tensor], *, b: int, k: int,
                     range_len: int, dtype: torch.dtype, invalid,
                     pad) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-range top-k lists of a plain scorer, one range at a time:
    ``score(codes_range, d_mask_range)`` -> (B, T) scores; slots with
    ``valid`` False score ``invalid`` with position -1, a short range is
    padded with (``pad``, -1), each list ordered by score descending, then
    position ascending (a stable sort). -> (scores (B, ranges, min(k, R))
    ``dtype``, positions int32)."""
    per_query = codes.dim() == 3
    n = codes.shape[-2]
    r, kk = range_len, min(k, range_len)
    n_ranges = -(-n // r)
    out_s = torch.empty((b, n_ranges, kk), dtype=dtype, device=codes.device)
    out_p = torch.empty((b, n_ranges, kk), dtype=torch.int32,
                        device=codes.device)
    axis = 1 if per_query else 0
    for start in vmem.sweep(range(0, n, r), n):
        g = start // r
        t = min(r, n - start)
        s = score(codes.narrow(axis, start, t), d_mask.narrow(axis, start, t))
        pos = torch.arange(start, start + t, dtype=torch.int32,
                           device=codes.device).expand(b, t)
        if valid is not None:
            v = valid.narrow(valid.dim() - 1, start, t).expand(b, t)
            s = torch.where(v, s, invalid)
            pos = torch.where(v, pos, -1)
        if t < kk:                                 # pad a short range
            s = torch.cat([s, s.new_full((b, kk - t), pad)], 1)
            pos = torch.cat([pos, pos.new_full((b, kk - t), -1)], 1)
        srt, sel = torch.sort(s, dim=1, descending=True, stable=True)
        out_s[:, g] = srt[:, :kk]
        out_p[:, g] = torch.gather(pos, 1, sel[:, :kk])
    return out_s, out_p


def quantized_maxsim_topk_plain(table: torch.Tensor, q_mask: torch.Tensor,
                                codes: torch.Tensor, d_mask: torch.Tensor,
                                valid: Optional[torch.Tensor], *, k: int,
                                range_len: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-range top-k in plain PyTorch: the same lists as
    ``quantized_maxsim_topk_cuda``. It scores one range at a time, so its
    memory is that of ``quantized_maxsim_plain`` over ``range_len`` docs.

    valid: None (all valid), (N,) or (B, N) bool.
    -> (scores (B, ranges, min(k, R)) f32, positions of the same shape
    int32).
    """
    return range_topk_plain(
        lambda c, m: quantized_maxsim_plain(table, q_mask, c, m), codes,
        d_mask, valid, b=table.shape[0], k=k, range_len=range_len,
        dtype=torch.float32, invalid=NEG_INF, pad=float("-inf"))


def _check_inputs(name: str, table: torch.Tensor, q_mask: torch.Tensor,
                  codes: torch.Tensor, d_mask: torch.Tensor):
    """Raise on what the kernel does not take; -> (b, mq, k, n, md, codes'
    batch stride, d_mask's batch stride)."""
    if table.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {table.device}")
    for arg, t in (("q_mask", q_mask), ("codes", codes), ("d_mask", d_mask)):
        if t.device != table.device:
            raise ValueError(f"{arg} is on {t.device}, table on "
                             f"{table.device}")
    if table.dtype != torch.float32 or q_mask.dtype != torch.float32:
        raise ValueError("table and q_mask must be float32")
    if not (table.is_contiguous() and q_mask.is_contiguous()):
        raise ValueError("table and q_mask must be contiguous")
    if codes.dtype not in _build.CODE_BYTES:
        raise ValueError(f"codes must be uint8 or uint16, got {codes.dtype}")
    if d_mask.dtype not in _build.MASK_DTYPES:
        raise ValueError(f"d_mask must be bool or uint8, got {d_mask.dtype}")
    b, mq, k = table.shape
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
    return (b, mq, k, n, md, codes.stride(0) if per_query else 0,
            d_mask.stride(0) if per_query else 0)


def launch_cost(b: int, mq: int, k: int, n: int, md: int, code_bytes: int,
                mask_bytes: int, per_query: bool, out_bytes: int):
    """(lookups, bytes) of one launch with every patch valid: a masked
    max-lookup per query patch and doc slot of that query's docs; every
    input read once, the outputs written once (chip_smoke.py's
    ``_qmaxsim_cost``). The lookups stand as its operations."""
    slots = (b if per_query else 1) * n * md
    lookups = mq * slots * (1 if per_query else b)
    return float(lookups), float(b * mq * k * 4 + b * mq * 4
                                 + slots * (code_bytes + mask_bytes)
                                 + out_bytes)


def _geometry(codes, b, mq, k, n, md, c_bs, m_bs, r, top_k, max_q):
    """The launch's geometry and its ``hpc_qmaxsim_geometry`` arguments."""
    per_query = c_bs != 0 or m_bs != 0
    key = (_build.CODE_BYTES[codes.dtype], b, mq, k, n, md, int(per_query),
           r, top_k, max_q, vmem.sm_count(codes.device))
    return vmem.qmaxsim_geometry(*key[:6], per_query, *key[7:]), key


def _count(geom, key, cost) -> None:
    global launches
    with _count_lock:
        launches += 1
        launch_shapes.setdefault(key, geom)
    vmem.record_launch(geom, {"args": key}, *cost)


def quantized_maxsim_cuda(table: torch.Tensor, q_mask: torch.Tensor,
                          codes: torch.Tensor,
                          d_mask: torch.Tensor) -> torch.Tensor:
    """Launch the scores-only kernel on the current stream; same contract
    as ``quantized_maxsim_plain`` with table/q_mask float32 and contiguous,
    codes uint8/uint16 and d_mask bool/uint8. Codes >= K score as masked
    (quantize never produces them). Raises on anything else."""
    b, mq, k, n, md, c_bs, m_bs = _check_inputs(
        "quantized_maxsim_cuda", table, q_mask, codes, d_mask)
    r = launch_range_len(b, n, table.device) if b and n else MAX_RANGE
    geom, key = _geometry(codes, b, mq, k, n, md, c_bs, m_bs, r, 0, 4)
    cost = launch_cost(b, mq, k, n, md, key[0], d_mask.element_size(),
                       bool(key[6]), b * n * 4)
    if vmem.is_fake(table):
        return vmem.fake_launch(geom, table.device, {"args": key}, *cost,
                                outputs=(((b, n), torch.float32),))
    out = torch.empty((b, n), dtype=torch.float32, device=table.device)
    if geom is None:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.hpc_qmaxsim(
        table.data_ptr(), q_mask.data_ptr(), codes.data_ptr(),
        _build.CODE_BYTES[codes.dtype], d_mask.data_ptr(), out.data_ptr(),
        b, mq, k, n, md, c_bs, m_bs, r, key[10], stream)
    _build.check(err, "quantized_maxsim kernel launch")
    _count(geom, key, cost)
    return out


def quantized_maxsim_topk_cuda(table: torch.Tensor, q_mask: torch.Tensor,
                               codes: torch.Tensor, d_mask: torch.Tensor,
                               valid: Optional[torch.Tensor], *, k: int,
                               range_len: Optional[int] = None,
                               max_queries_per_block: int = 4
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the per-range top-k kernel on the current stream, one launch
    for all N positions; same contract as ``quantized_maxsim_topk_plain``
    (inputs as ``quantized_maxsim_cuda``; valid None, or bool/uint8 (N,) or
    (B, N) dense along N). ``range_len`` defaults to
    ``launch_range_len(B, N)``. On the shared corpus a block scores up to
    four queries at once (two for K > 256); ``max_queries_per_block`` (1,
    2 or 4) caps that, for timing the kernel against fewer. Raises on
    anything else."""
    b, mq, kc, n, md, c_bs, m_bs = _check_inputs(
        "quantized_maxsim_topk_cuda", table, q_mask, codes, d_mask)
    v_bs = 0
    if valid is not None:
        if valid.device != table.device:
            raise ValueError(f"valid is on {valid.device}, table on "
                             f"{table.device}")
        if valid.dtype not in _build.MASK_DTYPES:
            raise ValueError(f"valid must be bool or uint8, got "
                             f"{valid.dtype}")
        if valid.dim() == 2:
            _build.check_layout("valid", valid, (b, n), batch_strided=True)
            v_bs = valid.stride(0)
        else:
            _build.check_layout("valid", valid, (n,))
    r = range_len if range_len is not None else (
        launch_range_len(b, n, table.device) if n else MAX_RANGE)
    if not 1 <= r <= MAX_RANGE:
        raise ValueError(f"range_len must be in [1, {MAX_RANGE}], got {r}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_queries_per_block not in (1, 2, 4):
        raise ValueError(f"max_queries_per_block must be 1, 2 or 4, got "
                         f"{max_queries_per_block}")
    kk = min(k, r)
    n_ranges = -(-n // r)
    geom, key = _geometry(codes, b, mq, kc, n, md, c_bs, m_bs, r, kk,
                          max_queries_per_block)
    cost = launch_cost(b, mq, kc, n, md, key[0], d_mask.element_size(),
                       bool(key[6]), b * n_ranges * kk * 8 + (
                           0 if valid is None else valid.numel()))
    if vmem.is_fake(table):
        shape = (b, n_ranges, kk)
        return vmem.fake_launch(geom, table.device, {"args": key}, *cost,
                                outputs=((shape, torch.float32),
                                         (shape, torch.int32)))
    out_s = torch.empty((b, n_ranges, kk), dtype=torch.float32,
                        device=table.device)
    out_p = torch.empty((b, n_ranges, kk), dtype=torch.int32,
                        device=table.device)
    if geom is None:
        return out_s, out_p
    lib = _build.library()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.hpc_qmaxsim_topk(
        table.data_ptr(), q_mask.data_ptr(), codes.data_ptr(),
        _build.CODE_BYTES[codes.dtype], d_mask.data_ptr(),
        None if valid is None else valid.data_ptr(), v_bs,
        out_s.data_ptr(), out_p.data_ptr(), b, mq, kc, n, md, c_bs, m_bs, r,
        kk, max_queries_per_block, key[10], stream)
    _build.check(err, "quantized_maxsim_topk kernel launch")
    _count(geom, key, cost)
    return out_s, out_p

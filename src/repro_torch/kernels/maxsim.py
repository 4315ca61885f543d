"""Float MaxSim late interaction: the CUDA kernel's wrapper and its plain
version.

    out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j]} <q[b, i], d[n, j]>

The counterpart of ``repro.kernels.maxsim`` (the Pallas kernel
``maxsim_pallas``). The kernel is ``csrc/maxsim.cu``; its source note says
what bounds it on the H100 and how it is laid out. It computes the dot
products on the tensor cores in 3xTF32 (a split-precision f32 product,
within a few f32 ulps of f32 FMAs), and a masked patch counts as -1e30, so
an all-masked doc scores ``sum_i qm_i * -1e30``.

Both functions take three layouts: a shared corpus (docs (N, Md, D),
d_mask (N, Md)), per-query pools (docs (B, P, Md, D), d_mask (B, P, Md);
a slice along P goes into the kernel through its batch stride), and
candidate rows: ``rows`` (B, P) int32 corpus positions into a shared
corpus, read through their ids (no (B, P, Md, D) copy on the card). With
rows the corpus may be a sequence of segments (docs a tuple of
(cap_s, Md, D) tensors, d_mask a tuple of their masks): position r lies
in the segment that holds positions start_s .. start_s + cap_s - 1, in
order. The kernel reads them through a table of at most
``MAX_SEGMENTS`` entries per launch. A -1 slot scores NEG_INF, the
scan's score for an empty slot; an id >= N (N = every segment's rows)
scores NaN (the kernel never reads it). ``launches`` counts the kernel
launches of this process and ``launch_shapes`` maps each distinct launch's
``hpc_maxsim_geometry`` arguments to its geometry (``kernels.vmem``);
under a ``FakeTensorMode`` nothing is launched (``vmem.fake_launch``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.late_interaction import NEG_INF
from repro_torch.kernels import _build, vmem

launches = 0
launch_shapes: dict = {}
_count_lock = threading.Lock()

# the kernel's layouts (csrc/maxsim.cu)
_SHARED, _PER_QUERY, _ROWS = 0, 1, 2
# entries of the rows layout's segment table (kMaxSegments in maxsim.cu);
# a corpus of more segments takes one launch per group of this many
MAX_SEGMENTS = 32

Corpus = Union[torch.Tensor, Sequence[torch.Tensor]]


def launch_cost(b: int, mq: int, n_out: int, md: int, d: int,
                mask_bytes: int, rows: bool):
    """(FLOPs, bytes) of one launch with every patch valid: 2 D FLOPs per
    query patch and doc patch of each query's docs; every input read once
    (with rows: each slot's row), the output written once (chip_smoke.py's
    ``_maxsim_cost``)."""
    per_query_docs = n_out
    flops = 2.0 * d * mq * md * per_query_docs * b
    docs = (b * n_out if rows else n_out) * md * (d * 4 + mask_bytes)
    return flops, float(b * mq * d * 4 + b * mq * 4 + docs
                        + (b * n_out * 4 if rows else 0) + b * n_out * 4)


def _segments(docs: Corpus, d_mask: Corpus
              ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """The rows layout's corpus as (segments, their masks)."""
    if isinstance(docs, torch.Tensor):
        return (docs,), (d_mask,)
    segs, masks = tuple(docs), tuple(d_mask)
    if not segs or len(segs) != len(masks):
        raise ValueError(f"{len(segs)} segments with {len(masks)} masks")
    return segs, masks


def maxsim_plain(q: torch.Tensor, q_mask: torch.Tensor, docs: Corpus,
                 d_mask: Corpus, rows: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the counterpart of
    ``repro.kernels.ref.maxsim``, extended to per-query pools).

    q (B, Mq, D), q_mask (B, Mq) 0/1, docs (N, Md, D) or (B, P, Md, D),
    d_mask of the docs' leading shape (nonzero = valid) -> (B, N) f32.
    With ``rows`` (B, P) of positions into a shared corpus (one tensor, or
    a tuple of segments): the rows are gathered, segment by segment, and
    scored as per-query pools -> (B, P); -1 slots score NEG_INF and ids
    >= N NaN, as in the kernel.
    """
    if rows is not None:
        segs, masks = _segments(docs, d_mask)
        r = rows.long()
        pool = torch.zeros(tuple(rows.shape) + tuple(segs[0].shape[1:]),
                           dtype=segs[0].dtype, device=segs[0].device)
        pool_mask = torch.zeros(tuple(rows.shape) + tuple(masks[0].shape[1:]),
                                dtype=masks[0].dtype, device=segs[0].device)
        start = 0
        for seg, m in zip(segs, masks):
            cap = seg.shape[0]
            local = r - start
            inside = (local >= 0) & (local < cap)
            if cap:
                idx = local.clamp(0, cap - 1)
                pool = torch.where(inside[..., None, None], seg[idx], pool)
                pool_mask = torch.where(inside[..., None], m[idx], pool_mask)
            start += cap
        out = maxsim_plain(q, q_mask, pool, pool_mask)
        out = torch.where(rows >= start, float("nan"), out)
        return torch.where(rows < 0, NEG_INF, out)
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


def maxsim_cuda(q: torch.Tensor, q_mask: torch.Tensor, docs: Corpus,
                d_mask: Corpus, rows: Optional[torch.Tensor] = None, *,
                max_queries_per_block: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    ``maxsim_plain`` with q and q_mask float32 and contiguous, docs float32,
    d_mask bool/uint8 and rows int32 with unit inner stride. Raises on
    anything else. ``max_queries_per_block`` caps the queries one block
    serves on a shared corpus; 1 is the earlier (B, doc) design, kept only
    to time the two side by side."""
    if rows is not None:
        return _maxsim_rows_cuda(q, q_mask, *_segments(docs, d_mask), rows,
                                 max_queries_per_block)
    return _launch(q, q_mask, docs, d_mask, None, None,
                   max_queries_per_block)


def _maxsim_rows_cuda(q, q_mask, segs, masks, rows, max_queries_per_block):
    """The rows layout over a segment table; a corpus of more than
    MAX_SEGMENTS segments takes one launch per group of them, each filling
    the slots whose positions fall in its group."""
    starts = [0]
    for seg in segs:
        starts.append(starts[-1] + int(seg.shape[0]))
    out = None
    for g0 in range(0, len(segs), MAX_SEGMENTS):
        g1 = min(g0 + MAX_SEGMENTS, len(segs))
        base, end = starts[g0], starts[g1]
        table = (segs[g0:g1], masks[g0:g1],
                 [s - base for s in starts[g0:g1]])
        if g0 == 0:
            out = _launch(q, q_mask, segs[0], masks[0], rows, table,
                          max_queries_per_block)
            continue
        part = _launch(q, q_mask, segs[g0], masks[g0], rows - base, table,
                       max_queries_per_block)
        out = torch.where((rows >= base) & (rows < end), part, out)
    return out


def _launch(q, q_mask, docs, d_mask, rows, table, max_queries_per_block):
    """One kernel launch. ``table`` (segments, masks, starts) is the rows
    layout's corpus; docs/d_mask then stand for its first segment in the
    shape checks."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"maxsim_cuda needs CUDA tensors, got {q.device}")
    named = [("q_mask", q_mask), ("docs", docs), ("d_mask", d_mask)]
    if rows is not None:
        named.append(("rows", rows))
        named += [(f"segment {i}", t) for i, t in
                  enumerate(table[0] + table[1])]
    for name, t in named:
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
    if rows is not None:
        if per_query:
            raise ValueError("rows index a shared corpus (N, Md, D), got "
                             f"docs {tuple(docs.shape)}")
        if rows.dtype != torch.int32:
            raise ValueError(f"rows must be int32, got {rows.dtype}")
        if rows.dim() != 2 or rows.shape[0] != b:
            raise ValueError(f"rows must be (B={b}, P), got "
                             f"{tuple(rows.shape)}")
        _build.check_layout("rows", rows, rows.shape, batch_strided=True)
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
    n_seg, seg_docs, seg_mask, seg_start = 0, None, None, None
    fake = vmem.is_fake(q)
    if rows is not None:
        segs, masks, starts = table
        for i, (seg, m) in enumerate(zip(segs, masks)):
            if seg.dtype != torch.float32 or m.dtype not in _build.MASK_DTYPES:
                raise ValueError(f"segment {i}: docs must be float32 and "
                                 "masks bool or uint8")
            _build.check_layout(f"segment {i}", seg, (seg.shape[0], md, d))
            _build.check_layout(f"segment {i} mask", m, (seg.shape[0], md))
        n_seg = len(segs)
        n = starts[-1] + int(segs[-1].shape[0])
        if not fake:
            seg_docs = (ctypes.c_void_p * n_seg)(*[t.data_ptr() for t in segs])
            seg_mask = (ctypes.c_void_p * n_seg)(*[t.data_ptr()
                                                   for t in masks])
            seg_start = (ctypes.c_int * n_seg)(*starts)
    n_out = rows.shape[1] if rows is not None else n
    if b == 0 or n_out == 0 or mq == 0:
        return torch.zeros((b, n_out), dtype=torch.float32, device=q.device)
    if md == 0:
        raise ValueError("maxsim_cuda needs at least one patch per doc")
    if not 1 <= max_queries_per_block <= 8:
        raise ValueError(f"max_queries_per_block must be in [1, 8], got "
                         f"{max_queries_per_block}")
    layout = _ROWS if rows is not None else (_PER_QUERY if per_query
                                             else _SHARED)
    sms = vmem.sm_count(q.device)
    key = (layout, b, mq, n_out, md, d, max_queries_per_block, sms)
    geom = vmem.maxsim_geometry(*key)
    cost = launch_cost(b, mq, n_out, md, d, d_mask.element_size(),
                       rows is not None)
    if fake:
        return vmem.fake_launch(geom, q.device, {"args": key}, *cost)
    lib = _build.library()
    out = torch.empty((b, n_out), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hpc_maxsim(
        q.data_ptr(), q_mask.data_ptr(), docs.data_ptr(), d_mask.data_ptr(),
        rows.data_ptr() if rows is not None else None, out.data_ptr(),
        layout, b, mq, n_out, md, d, n,
        docs.stride(0) if per_query else 0,
        d_mask.stride(0) if per_query else 0,
        rows.stride(0) if rows is not None else 0, n_seg, seg_docs, seg_mask,
        seg_start, max_queries_per_block, sms, stream)
    _build.check(err, "maxsim kernel launch")
    with _count_lock:
        launches += 1
        launch_shapes.setdefault(key, geom)
    vmem.record_launch(geom, {"args": key}, *cost)
    return out

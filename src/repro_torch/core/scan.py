"""Streaming scan engine: blocked score + top-k fusion, in PyTorch.

The counterpart of ``repro.core.scan``. The corpus is swept by a MaxSim
kernel, quantized (ADC), float or binary (Hamming): the CUDA kernel for
CUDA tensors, its plain version for CPU tensors (see ``resolve_impl``).
Neither the (B, Mq, N, Md) similarity tensor nor the (B, N) score matrix
ever exists:

  * the float sweep scores fixed-size doc blocks, one launch each, and
    folds each block into a running (B, k) top-k merge buffer;
  * the ADC and Hamming sweeps (``quantized_maxsim_topk``,
    ``hamming_maxsim_topk``) score contiguous ranges of positions and
    keep each range's top min(k, R) (score, position) pairs; on a CUDA
    tensor one launch does every range of the sweep, and the ranges'
    lists are merged once. Their candidate buffer is
    (B, ranges x min(k, R)), at most MAX_CANDIDATES entries per merge.

Peak scan memory is O(B * block_docs) on the float kernel path,
O(MAX_CANDIDATES) on the ADC and Hamming kernel paths, and
O(B * Mq * block_docs * Md) on the plain paths.

Numerical contract, as in the reference: positions are visited in doc
order and the carried buffer sits before the new candidates in every
merge, and the merge is a *stable* descending sort, so equal scores
resolve to the lowest doc position exactly as one global ``lax.top_k``
would (``torch.topk`` promises no order among equal values, so it is not
used). The range lists are ordered by score, then position, and go into
the merge in range order, which keeps that tie order.

The two layouts:

  * shared corpus  — codes (N, Md) / docs (N, Md, D): every query scores
    every doc (flat, float_flat, hamming);
  * per-query candidates — codes (B, P, Md) / docs (B, P, Md, D): each
    query scores its own pool (the facade rerank, the cascade's stage 2).
    The kernels take a pool slice through its batch stride. The float
    sweep also takes candidate rows: (B, P) positions into a shared
    (N, Md, D) corpus, or into the segments of a segmented one, read
    through their ids (the cascade's stage 3).

Sentinel contract: rows beyond the valid pool carry doc id -1 and the
merge-buffer init score (-inf for float scores, the int32 minimum for
Hamming scores), strictly below any real document; slots with
``valid=False`` score exactly NEG_INF (float) or the int32 minimum
(Hamming) with id -1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import late_interaction as li
from repro_torch.kernels import hamming as hamming_k
from repro_torch.kernels import maxsim as maxsim_k
from repro_torch.kernels import quantized_maxsim as qmaxsim_k
from repro_torch.kernels import vmem

NEG_INF = li.NEG_INF
Tensor = torch.Tensor

# Candidate entries (B x ranges x per-range k) the ADC and Hamming sweeps
# merge at once: 2^22, 16 MiB of scores and 16 MiB of positions. At the
# serve cell (B=8, N=4,194,304, k=32, 256-doc ranges) one sweep is one
# chunk.
MAX_CANDIDATES = 1 << 22


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Knobs of the streaming scan.

    block_docs: documents scored per sweep step. The float sweep
        launches its kernel once per block on either path; the plain ADC
        and Hamming sweeps score one block per step and keep its top k.
        The CUDA ADC and Hamming sweeps do not read it: each kernel scores
        the whole sweep in one launch, over ranges whose length it picks
        from the shape (``launch_range_len`` of ``kernels.quantized_maxsim``
        and ``kernels.hamming``).
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


def _init_buffer(b: int, k: int, score_dtype: torch.dtype, device,
                 carry: Optional[Tuple[Tensor, Tensor]]
                 ) -> Tuple[Tensor, Tensor]:
    """The (B, k) merge buffer: ``carry``, or sentinel scores and id -1."""
    if carry is not None:
        return carry[0].to(score_dtype), carry[1].to(torch.int32)
    return (torch.full((b, k), score_sentinel(score_dtype), dtype=score_dtype,
                       device=device),
            torch.full((b, k), -1, dtype=torch.int32, device=device))


def _merge(top_s: Tensor, top_i: Tensor, s: Tensor, ids: Tensor, k: int
           ) -> Tuple[Tensor, Tensor]:
    """Fold candidates (B, T) into the (B, k) buffer: one stable descending
    sort of [buffer, candidates], so ties keep the buffer first and then
    the candidates' order."""
    cat_s = torch.cat([top_s, s], dim=1)
    cat_i = torch.cat([top_i, ids], dim=1)
    srt, sel = torch.sort(cat_s, dim=1, descending=True, stable=True)
    return srt[:, :k], torch.gather(cat_i, 1, sel[:, :k])


def _head(s: Tensor, ids: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The candidates' own top k in the merge's order (score descending,
    then list order): merging the buffer with it gives what merging it
    with every candidate gives, both sorts being stable, and the (B, k +
    C) concatenation of a sweep's lists never exists (it held the ADC
    sweep's peak above the reference's budget of 16 B per document)."""
    if s.shape[1] <= k:
        return s, ids
    srt, sel = torch.sort(s, dim=1, descending=True, stable=True)
    return srt[:, :k].contiguous(), torch.gather(ids, 1, sel[:, :k])


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
    sent = score_sentinel(score_dtype)
    top_s, top_i = _init_buffer(b, k, score_dtype, doc_ids.device, carry)
    if n == 0:
        return top_s, top_i
    block = max(1, min(block_docs, n))
    axis = 1 if per_query else 0
    doc_ids = doc_ids.to(torch.int32)
    invalid_score = NEG_INF if score_dtype.is_floating_point else sent

    # full blocks, then the ragged N % block tail at its natural size
    for start in vmem.sweep(range(0, n, block), n):
        t = min(block, n - start)
        blk = tuple(a.narrow(axis, start, t) for a in payload)
        ids = doc_ids.narrow(doc_ids.dim() - 1, start, t)
        v = valid.narrow(valid.dim() - 1, start, t)
        with tracing.span("scan.block"):
            s = score_block(*blk)                             # (B, T)
            v = v.expand(s.shape)
            ids = ids.expand(s.shape)
            s = torch.where(v, s, invalid_score)
            ids = torch.where(v, ids, -1)
        with tracing.span("scan.merge"):
            top_s, top_i = _merge(top_s, top_i, s, ids, k)
    return top_s, top_i


def _prep(n: int, doc_ids: Optional[Tensor], valid: Optional[Tensor],
          per_query: bool, b: int, device) -> Tuple[Tensor, Tensor]:
    if doc_ids is None:
        doc_ids = torch.arange(n, dtype=torch.int32, device=device)
    if valid is None:
        shape = (b, n) if per_query and doc_ids.dim() == 2 else (n,)
        valid = torch.ones(shape, dtype=torch.bool, device=device)
    return doc_ids, valid


def _sweep_lists(range_lists: Callable[..., Tuple[Tensor, Tensor]],
                 codes: Tensor, d_mask: Tensor, doc_ids: Tensor,
                 valid: Tensor, top_s: Tensor, top_i: Tensor, *, b: int,
                 n: int, k: int, range_len: int, per_query: bool
                 ) -> Tuple[Tensor, Tensor]:
    """Merge a sweep's per-range top-k lists into the (B, k) buffer.

    ``range_lists(codes, d_mask, valid)`` -> (scores, positions) (B,
    ranges, min(k, R)) of the positions it is given, as the kernels'
    top-k entries return them. Each chunk of whole ranges, its lists
    within MAX_CANDIDATES entries, takes one call and one merge (on a CUDA
    tensor one launch); positions become ids and the lists go into the
    merge in range order.
    """
    r = range_len
    chunk = r * max(1, MAX_CANDIDATES // max(1, b * min(k, r)))
    axis = 1 if per_query else 0
    doc_ids = doc_ids.to(torch.int32)
    for start in vmem.sweep(range(0, n, chunk), n):
        t = min(chunk, n - start)
        with tracing.span("scan.lists"):
            s, pos = range_lists(codes.narrow(axis, start, t),
                                 d_mask.narrow(axis, start, t),
                                 valid.narrow(valid.dim() - 1, start, t))
        with tracing.span("scan.merge"):
            # positions -> ids, each list-sized temporary dropped once used
            pos = pos.reshape(b, -1)
            ok = pos >= 0
            safe = torch.clamp(pos, min=0).to(torch.int64)
            del pos
            ids = doc_ids.narrow(doc_ids.dim() - 1, start, t)
            ids = ids[safe] if ids.dim() == 1 else torch.gather(ids, 1, safe)
            del safe
            ids = torch.where(ok, ids, -1)
            del ok
            top_s, top_i = _merge(top_s, top_i,
                                  *_head(s.reshape(b, -1), ids, k), k)
            del s, ids      # not alive while the next chunk is scored
    return top_s, top_i


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

    The positions are cut into ranges (``block_docs`` long on the plain
    path, ``launch_range_len`` on the CUDA path), each range keeps its top
    min(k, R), and the ranges' lists are merged into the buffer in range
    order: on a CUDA tensor one launch and one merge per sweep, unless the
    lists would pass MAX_CANDIDATES entries, when each chunk of ranges
    takes its own launch and merge.
    """
    scan = scan if scan is not None else DEFAULT
    mode = resolve_impl(scan.impl, codes.device)
    per_query = codes.dim() == 3
    b = q.shape[0]
    n = codes.shape[1] if per_query else codes.shape[0]
    top_s, top_i = _init_buffer(b, k, torch.float32, codes.device, carry)
    if n == 0:
        return top_s, top_i
    table = li.adc_table(q, codebook).contiguous()            # (B, Mq, K)
    q_mask_f = q_mask.to(torch.float32).contiguous()
    doc_ids, valid = _prep(n, doc_ids, valid, per_query, b, codes.device)
    if mode == "cuda":
        r = qmaxsim_k.launch_range_len(b, n, codes.device)
        lists = qmaxsim_k.quantized_maxsim_topk_cuda
    else:
        r = max(1, min(scan.block_docs, n))
        lists = qmaxsim_k.quantized_maxsim_topk_plain

    def range_lists(c, m, v):
        return lists(table, q_mask_f, c, m, v, k=k, range_len=r)

    return _sweep_lists(range_lists, codes, d_mask, doc_ids, valid, top_s,
                        top_i, b=b, n=n, k=k, range_len=r,
                        per_query=per_query)


def maxsim_topk(q: Tensor, q_mask: Tensor, docs: Tensor, d_mask: Tensor, *,
                k: int, doc_ids: Optional[Tensor] = None,
                valid: Optional[Tensor] = None,
                scan: Optional[ScanConfig] = None,
                carry: Optional[Tuple[Tensor, Tensor]] = None,
                rows: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Streaming float MaxSim top-k.

    docs/d_mask are a shared (N, Md, D) corpus or (B, P, Md, D) per-query
    candidate pools — the two layouts of ``quantized_maxsim_topk``, with
    the same doc_ids/valid/carry. With ``rows`` (B, P) int32 corpus
    positions (-1 = empty slot), docs/d_mask stay the shared corpus and
    each query scores its own P rows, read through their ids: the
    cascade's float rerank, with no (B, P, Md, D) copy on the card; the
    sweep streams blocks along P and doc_ids/valid are (B, P). With rows,
    docs/d_mask may also be tuples of segments: one corpus whose positions
    run through the segments in order (a segmented state).
    -> (scores (B, k) f32, doc_ids (B, k) int32).
    """
    scan = scan if scan is not None else DEFAULT
    device = rows.device if rows is not None else docs.device
    mode = resolve_impl(scan.impl, device)
    per_query = rows is not None or docs.dim() == 4
    b = q.shape[0]
    if rows is not None:
        n = rows.shape[1]
    else:
        n = docs.shape[1] if per_query else docs.shape[0]
    qf = q.to(torch.float32).contiguous()
    q_mask_f = q_mask.to(torch.float32).contiguous()
    doc_ids, valid = _prep(n, doc_ids, valid, per_query, b, device)
    kernel = (maxsim_k.maxsim_cuda if mode == "cuda"
              else maxsim_k.maxsim_plain)

    if rows is not None:
        def score_block(r):
            return kernel(qf, q_mask_f, docs, d_mask, rows=r)
        payload = (rows.to(torch.int32),)
    else:
        def score_block(d, m):
            return kernel(qf, q_mask_f, d, m)
        payload = (docs, d_mask)

    return _streaming_topk(score_block, payload, doc_ids, valid,
                           b=b, n=n, k=k, block_docs=scan.block_docs,
                           per_query=per_query, score_dtype=torch.float32,
                           carry=carry)


def hamming_maxsim_topk(q_codes: Tensor, q_mask: Tensor, d_codes: Tensor,
                        d_mask: Tensor, *, bits: int, k: int,
                        doc_ids: Optional[Tensor] = None,
                        valid: Optional[Tensor] = None,
                        scan: Optional[ScanConfig] = None,
                        carry: Optional[Tuple[Tensor, Tensor]] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Streaming binary MaxSim top-k.

    d_codes/d_mask are a shared (N, Md) code corpus or (B, P, Md)
    per-query pools. Scores are int32 on every impl and the sentinel is
    the int32 minimum. A doc with no valid patch scores
    ``sum_i qm_i * -(2**20)`` on both impls, as the reference's jnp path
    does; the reference's Pallas path clamps its f32 ``-1e30`` sums to the
    int32 minimum instead (ROADMAP caveat C4).
    -> (scores (B, k) int32, doc_ids (B, k) int32).

    The sweep of ``quantized_maxsim_topk``: ranges of ``block_docs`` on the
    plain path and ``launch_range_len`` on the CUDA path each keep their
    top min(k, R), and the ranges' lists are merged in range order; on a
    CUDA tensor one launch and one merge per sweep (per chunk of
    MAX_CANDIDATES list entries).
    """
    scan = scan if scan is not None else DEFAULT
    mode = resolve_impl(scan.impl, d_codes.device)
    per_query = d_codes.dim() == 3
    b, mq = q_codes.shape
    n = d_codes.shape[1] if per_query else d_codes.shape[0]
    top_s, top_i = _init_buffer(b, k, torch.int32, d_codes.device, carry)
    if n == 0:
        return top_s, top_i
    qc = q_codes.to(torch.int32).contiguous()
    qm = q_mask.to(torch.int32).contiguous()
    doc_ids, valid = _prep(n, doc_ids, valid, per_query, b, d_codes.device)
    if mode == "cuda":
        r = hamming_k.launch_range_len(b, mq, n, bits, d_codes.device,
                                       per_query)
        lists = hamming_k.hamming_maxsim_topk_cuda
    else:
        r = max(1, min(scan.block_docs, n))
        lists = hamming_k.hamming_maxsim_topk_plain

    def range_lists(c, m, v):
        return lists(qc, qm, c, m, v, bits=bits, k=k, range_len=r)

    return _sweep_lists(range_lists, d_codes, d_mask, doc_ids, valid, top_s,
                        top_i, b=b, n=n, k=k, range_len=r,
                        per_query=per_query)

"""Declarative memory-budget manifests for every search entry point.

The counterpart of ``repro.analysis.manifests``: the same 17 manifests
under the reference's names, trace geometry and budgets. Each
``BudgetManifest`` registers one hot-path entry point with the budget
analyzer (``analysis.jaxpr_budget``): a ``trace(n, device)`` callable
returning ``(fn, args)`` with tensors without data at corpus size ``n``
(``IndexBackend.abstract_state`` under the analyzer's ``FakeTensorMode``),
plus the contract numbers the recorded run must honor:

  * ``max_block_bytes`` — the largest intermediate the entry point may
    allocate (the blocked-scan working set);
  * ``max_bytes_per_doc`` — how fast the peak live bytes above the inputs
    may grow per document: doc ids (4 B), validity masks (1 B) and
    code-payload handling fit; a (B, N) float score matrix (32 B/doc at
    B = 8) or the unblocked (B, Mq, N, Md) gather (~2 KB/doc) do not;
  * ``out_dtypes`` — float32 scores + int32 doc ids everywhere except
    hamming, whose popcount scores stay int32 end to end;
  * ``cost`` — an optional ``CostContract`` checked by the cost model
    (``analysis.cost_model``): design envelopes with headroom; drift
    against today's numbers is gated by ``COST_baseline_torch.json``.

The trace geometry is the reference's: B 8, Mq 8, Md 16, D 16, K 256,
N 2^20, N_alt 2^19, IVF n_list 1024; the scan block is the production 256
and the scan pinned to ``impl="plain"`` (the reference pins ``"jnp"``):
the plain block scorers expose every intermediate the budget bounds.

``real`` manifests: the HNSW descent syncs on data (the greedy levels'
stopping test, 8 host syncs a search), which tensors without data cannot
answer. Those trace on real CPU tensors at the same geometry, drawn from
``SEED`` (a random graph of the state's shape: the walk's work per step,
not its path, is what the budget bounds).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.analysis.cost_model import CostContract
from repro_torch.core import scan as scan_mod
from repro_torch.retrieval.base import Query, code_dtype, get_backend
from repro_torch.retrieval.config import HPCConfig

__all__ = ["BudgetManifest", "get_manifest", "manifests"]

# Trace geometry: small constants, a large corpus.
B = 8          # query batch
MQ = 8         # query patches
MD = 16        # doc patches
D = 16         # embedding dim
K = 256        # codebook size
TOP_K = 16     # result depth
RERANK = 64    # facade rerank candidate depth
N = 1 << 20    # corpus size (primary trace)
N_ALT = 1 << 19  # secondary trace for growth classification
IVF_N_LIST = 1024  # routing clusters at corpus scale (cap = 2N/n_list)
SEED = 0       # the real-tensor traces' draws

SCAN = scan_mod.ScanConfig(block_docs=256, impl="plain")

MiB = 2 ** 20


@dataclasses.dataclass(frozen=True)
class BudgetManifest:
    """One entry point's memory/dtype contract (see module docstring)."""

    name: str
    trace: Callable[..., Tuple[Callable, tuple]]
    max_block_bytes: int = 64 * MiB
    max_bytes_per_doc: float = 16.0
    out_dtypes: Optional[Tuple] = (torch.float32, torch.int32)
    n: int = N
    n_alt: int = N_ALT
    cost: Optional[CostContract] = None
    real: bool = False
    notes: str = ""


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def abstract_query(device, b: int = B, mq: int = MQ, d: int = D) -> Query:
    """A shape-only Query at the trace geometry."""
    return Query(embeddings=_empty((b, mq, d), torch.float32, device),
                 mask=_empty((b, mq), torch.bool, device),
                 salience=_empty((b, mq), torch.float32, device))


def _search(backend):
    def fn(state, query):
        return backend.search(state, query, k=TOP_K, scan=SCAN)
    return fn


def _backend_trace(backend_name: str, **knobs):
    """Trace builder for ``backend.search`` over its abstract state."""
    def trace(n: int, device="cpu"):
        backend = get_backend(backend_name)
        state = backend.abstract_state(n=n, md=MD, d=D, k=K, device=device,
                                       **knobs)
        return _search(backend), (state, abstract_query(device))
    return trace


def _segmented_trace(backend_name: str, seg_fn: Callable[[int], Tuple],
                     **knobs):
    """Trace builder for ``backend.search`` over a *segmented* state;
    ``seg_fn(n)`` gives the per-segment capacities (ivf: bucket caps)."""
    def trace(n: int, device="cpu"):
        backend = get_backend(backend_name)
        state = backend.abstract_state(n=n, md=MD, d=D, k=K, device=device,
                                       segments=seg_fn(n), **knobs)
        return _search(backend), (state, abstract_query(device))
    return trace


def _lsm_segments(n: int) -> Tuple[int, int, int]:
    """The steady churn shape: one base segment, one grown delta, one fresh
    small append, all block-aligned."""
    return (n, n >> 4, 256)


def _draw_hnsw(state, n: int, gen: torch.Generator):
    """A real HNSW state with the abstract state's shapes: random vectors,
    codes and masks, and a random graph (every slot a node id)."""
    def draw(payload):
        cap, d = payload.doc_vecs.shape
        levels, _, w = payload.neighbors.shape
        md = payload.codes.shape[1]
        return payload._replace(
            doc_vecs=torch.randn(cap, d, generator=gen),
            neighbors=torch.randint(0, cap, (levels, cap, w), generator=gen,
                                    dtype=torch.int32),
            node_level=torch.randint(0, levels, (cap,), generator=gen,
                                     dtype=torch.int32),
            codes=torch.randint(0, K, (cap, md), generator=gen,
                                dtype=torch.int64).to(payload.codes.dtype),
            mask=torch.rand(cap, md, generator=gen) < 0.9,
            doc_ids=torch.arange(cap, dtype=torch.int32),
            codebook=torch.randn(K, payload.codebook.shape[1],
                                 generator=gen))
    hs = state.backend_state
    seg = hs.index
    if hasattr(seg, "segments"):
        p = draw(seg.segments[0])
        cap = p.doc_vecs.shape[0]
        idx = dataclasses.replace(
            seg, segments=(p,), live=(torch.rand(cap, generator=gen) < 0.95,),
            pos_of_id=torch.arange(seg.pos_of_id.shape[0],
                                   dtype=torch.int32))
    else:
        p = idx = draw(seg)
    rows = state.rerank_codes.shape[0]
    return state._replace(
        codebook=p.codebook, backend_state=dataclasses.replace(hs, index=idx),
        rerank_codes=torch.randint(0, K, (rows, MD), generator=gen,
                                   dtype=torch.int64).to(code_dtype(K)),
        rerank_mask=torch.ones(rows, MD, dtype=torch.bool))


def _real_query(gen: torch.Generator) -> Query:
    return Query(embeddings=torch.randn(B, MQ, D, generator=gen),
                 mask=torch.ones(B, MQ, dtype=torch.bool),
                 salience=torch.rand(B, MQ, generator=gen))


def _hnsw_trace(segments: bool):
    """The HNSW search on real CPU tensors (its descent syncs on data)."""
    def trace(n: int, device="cpu"):
        backend = get_backend("hnsw")
        knobs = {"segments": (n,)} if segments else {}
        gen = torch.Generator().manual_seed(SEED)
        state = _draw_hnsw(backend.abstract_state(n=n, md=MD, d=D, k=K,
                                                  **knobs), n, gen)
        return _search(backend), (state, _real_query(gen))
    return trace


def _rerank_trace(n: int, device="cpu"):
    """Facade rerank: gather candidate codes, rescore unpruned."""
    from repro_torch.retrieval.retriever import Retriever
    r = Retriever(HPCConfig(backend="flat", scan_block_docs=SCAN.block_docs,
                            scan_impl=SCAN.impl))
    state = get_backend("flat").abstract_state(n=n, md=MD, d=D, k=K,
                                               device=device)
    ids = _empty((B, RERANK), torch.int32, device)

    def fn(state, query, ids):
        return r._rerank(state, query, ids, k=TOP_K)
    return fn, (state, abstract_query(device), ids)


def _scan_quantized_shared_trace(n: int, device="cpu"):
    """The scan engine itself, shared-corpus layout (flat's hot path)."""
    q = abstract_query(device)
    codes = _empty((n, MD), code_dtype(K), device)
    mask = _empty((n, MD), torch.bool, device)
    cb = _empty((K, D), torch.float32, device)

    def fn(qe, qm, codes, mask, cb):
        return scan_mod.quantized_maxsim_topk(qe, qm, codes, mask, cb,
                                              k=TOP_K, scan=SCAN)
    return fn, (q.embeddings, q.mask, codes, mask, cb)


def _scan_quantized_per_query_trace(n: int, device="cpu"):
    """Per-query candidate-pool layout (ivf buckets / hnsw beam / rerank);
    ``n`` is the per-query pool size, so growth is per pooled candidate."""
    q = abstract_query(device)
    codes = _empty((B, n, MD), code_dtype(K), device)
    mask = _empty((B, n, MD), torch.bool, device)
    cb = _empty((K, D), torch.float32, device)
    ids = _empty((B, n), torch.int32, device)
    valid = _empty((B, n), torch.bool, device)

    def fn(qe, qm, codes, mask, cb, ids, valid):
        return scan_mod.quantized_maxsim_topk(qe, qm, codes, mask, cb,
                                              k=TOP_K, doc_ids=ids,
                                              valid=valid, scan=SCAN)
    return fn, (q.embeddings, q.mask, codes, mask, cb, ids, valid)


def _scan_maxsim_trace(n: int, device="cpu"):
    """Float scan over an uncompressed (N, Md, D) corpus."""
    q = abstract_query(device)
    docs = _empty((n, MD, D), torch.float32, device)
    mask = _empty((n, MD), torch.bool, device)

    def fn(qe, qm, docs, mask):
        return scan_mod.maxsim_topk(qe, qm, docs, mask, k=TOP_K, scan=SCAN)
    return fn, (q.embeddings, q.mask, docs, mask)


def _scan_hamming_trace(n: int, device="cpu"):
    """Popcount scan over b-bit binary codes (int32 scores)."""
    q_codes = _empty((B, MQ), torch.uint8, device)
    q_mask = _empty((B, MQ), torch.bool, device)
    d_codes = _empty((n, MD), torch.uint8, device)
    d_mask = _empty((n, MD), torch.bool, device)

    def fn(qc, qm, dc, dm):
        return scan_mod.hamming_maxsim_topk(qc, qm, dc, dm, bits=8,
                                            k=TOP_K, scan=SCAN)
    return fn, (q_codes, q_mask, d_codes, d_mask)


_MANIFESTS: Dict[str, BudgetManifest] = {}


def _register(m: BudgetManifest) -> None:
    if m.name in _MANIFESTS:
        raise ValueError(f"duplicate manifest {m.name!r}")
    _MANIFESTS[m.name] = m


for _m in (
    BudgetManifest(
        name="search_flat",
        trace=_backend_trace("flat"),
        cost=CostContract(max_flops_per_doc=4096, max_bytes_per_doc=512),
        notes="The blocked scan may keep doc ids / validity O(N); the "
              "(B, N) score matrix (32 B/doc at B=8) must never come "
              "back."),
    BudgetManifest(
        name="search_float_flat",
        trace=_backend_trace("float_flat"),
        cost=CostContract(max_flops_per_doc=65536,
                          max_bytes_per_doc=12288),
        notes="Uncompressed baseline: the (N, Md, D) corpus is an input, "
              "not an intermediate; blocks of it are views, never "
              "copied whole."),
    BudgetManifest(
        name="search_hamming",
        trace=_backend_trace("hamming"),
        out_dtypes=(torch.int32, torch.int32),
        cost=CostContract(max_flops_per_doc=16384,
                          max_bytes_per_doc=8192),
        notes="Popcount MaxSim: scores stay int32 end to end (the dtype "
              "contract half of this entry)."),
    BudgetManifest(
        name="search_ivf",
        trace=_backend_trace("ivf", n_list=IVF_N_LIST, n_probe=8),
        notes="Probed-bucket gathers scale with bucket cap = 2N/n_list: "
              "~2 B/doc each for codes+mask at n_list=1024, n_probe=8."),
    BudgetManifest(
        name="search_hnsw",
        trace=_hnsw_trace(segments=False),
        real=True,
        notes="The beam's visited bitmask is (B, N) bool = 8 B/doc at "
              "B=8; everything else is O(ef_search). Traced on real CPU "
              "tensors: the greedy descent syncs on data."),
    BudgetManifest(
        name="search_cascade",
        trace=_backend_trace("cascade", p1=1024, p2=64),
        cost=CostContract(max_flops_per_doc=16384,
                          max_bytes_per_doc=12288),
        notes="Staged funnel: the hamming prefilter is the only O(N) "
              "pass (blocked, like search_hamming); the ADC and float "
              "stages score per-query (B, p1)/(B, p2) pools — O(budget), "
              "never a full-corpus gather. Float scores out (exact "
              "rerank)."),
    BudgetManifest(
        name="search_flat_segmented",
        trace=_segmented_trace("flat", _lsm_segments),
        notes="LSM segment sweep: the same blocked scan per segment with "
              "the (B, k) merge buffer carried across — per-segment "
              "ids/valid stay O(cap), nothing new scales with N."),
    BudgetManifest(
        name="search_float_flat_segmented",
        trace=_segmented_trace("float_flat", _lsm_segments),
        notes="Float segment sweep: block views per segment; tombstone "
              "live bits add 1 B/slot."),
    BudgetManifest(
        name="search_hamming_segmented",
        trace=_segmented_trace("hamming", _lsm_segments),
        out_dtypes=(torch.int32, torch.int32),
        notes="Binary segment sweep: int32 popcount scores end to end, "
              "merge buffer carried across segments."),
    BudgetManifest(
        name="search_ivf_segmented",
        trace=_segmented_trace(
            "ivf", lambda n: (2 * n // IVF_N_LIST, 8),
            n_list=IVF_N_LIST, n_probe=8),
        notes="Shared routing centroids scored once; per-segment probed "
              "gathers scale with that segment's bucket cap (2N/n_list "
              "for the base, O(1) for deltas)."),
    BudgetManifest(
        name="search_hnsw_segmented",
        trace=_hnsw_trace(segments=True),
        real=True,
        notes="Single growable graph segment: the walk is the monolithic "
              "one plus an O(N) live-bit lookup folded into the validity "
              "mask. Traced on real CPU tensors."),
    BudgetManifest(
        name="search_cascade_segmented",
        trace=_segmented_trace("cascade", _lsm_segments, p1=1024, p2=64),
        notes="Segmented funnel: hamming prefilter sweeps segments "
              "blocked; ADC/float stages resolve global ids via pos_of_id "
              "(O(B * budget) gathers) across segments."),
    BudgetManifest(
        name="retriever_rerank",
        trace=_rerank_trace,
        notes="Candidate gather from the unpruned (N, Md) code corpus: "
              "all intermediates are O(B * rerank depth), none scale "
              "with N."),
    BudgetManifest(
        name="scan_quantized_shared",
        trace=_scan_quantized_shared_trace,
        cost=CostContract(max_flops_per_doc=4096, max_bytes_per_doc=512),
        notes="The scan engine itself, shared-corpus layout."),
    BudgetManifest(
        name="scan_quantized_per_query",
        trace=_scan_quantized_per_query_trace,
        max_bytes_per_doc=48.0,
        cost=CostContract(max_flops_per_doc=8192,
                          max_bytes_per_doc=2048),
        notes="Per-query pools carry (B, P) ids/valid by construction: "
              "B * 5 B per pooled candidate before scoring starts."),
    BudgetManifest(
        name="scan_maxsim",
        trace=_scan_maxsim_trace,
        cost=CostContract(max_flops_per_doc=65536,
                          max_bytes_per_doc=12288),
        notes="Float scan: block views of the fp32 corpus are the working "
              "set; nothing else may scale with N."),
    BudgetManifest(
        name="scan_hamming",
        trace=_scan_hamming_trace,
        out_dtypes=(torch.int32, torch.int32),
        cost=CostContract(max_flops_per_doc=16384,
                          max_bytes_per_doc=8192),
        notes="Binary scan: int32 popcount scores, packed-code blocks."),
):
    _register(_m)


def manifests() -> Tuple[BudgetManifest, ...]:
    """Every registered manifest, name-ordered (stable CLI/CI output)."""
    return tuple(_MANIFESTS[k] for k in sorted(_MANIFESTS))


def get_manifest(name: str) -> BudgetManifest:
    try:
        return _MANIFESTS[name]
    except KeyError:
        raise KeyError(
            f"no manifest {name!r}; registered: {sorted(_MANIFESTS)}"
        ) from None

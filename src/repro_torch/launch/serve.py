"""Retrieval serving CLI: build an HPC-ColPali index over a synthetic corpus
and serve queries through the asyncio continuous-batching server.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 4096 \
      --queries 256 --backend flat --k 256 --p 60 --device cuda

``--backend`` is any registered backend: flat, float_flat, hamming,
cascade (the hamming -> ADC -> float funnel, budgets p1=1024, p2=64), or
the ANN routers ivf (n_list=64, n_probe=8) and hnsw (m=8, ef_search=64).
The deprecated ``--mode``/``--index`` pair is still accepted and resolved
through ``HPCConfig``'s table.

The counterpart of ``repro.launch.serve``. ``--device`` (default ``cuda``)
picks where the corpus, the index and the search live; ``--device cpu``
runs the plain PyTorch path. ``--rate-qps`` switches from closed-loop
(everything submitted at once) to open-loop Poisson arrivals;
``--single-shape`` pads every batch to ``--max-batch``.
``build_and_serve`` is the body, shared with ``chip_smoke.py``, which
also serves states it built itself through ``serve_state``.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.retrieval import (Corpus, HPCConfig, Query, Retriever,
                                   RetrieverState, available_backends)
from repro_torch.serving.client import drive
from repro_torch.serving.server import AsyncRetrievalServer, ServeConfig

RECALL_RELEVANCE = 2  # planted target + near-duplicates


@dataclasses.dataclass
class ServeRun:
    """What one build-and-serve run produced and measured."""

    retriever: Retriever
    state: RetrieverState
    queries: Tuple[np.ndarray, np.ndarray, np.ndarray]  # host (Q, Mq, ...)
    results: List[Tuple[np.ndarray, np.ndarray]]        # per request
    build_s: float
    warm_s: float                                       # warm_shapes
    ladder: Tuple[int, ...]                             # the warmed rungs
    serve_s: float
    storage: Dict[str, int]
    stats: Dict[str, Any]
    hit_rate: float                                     # hit@top_k
    recall: float                                       # recall@top_k
    relevance: Optional[np.ndarray] = None              # (Q, N) host


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_and_serve(spec: synthetic.CorpusSpec, cfg: HPCConfig, *,
                    n_requests: int, max_batch: int, top_k: int, device,
                    seed: int, rate_qps: float = 0.0,
                    ladder: Optional[Tuple[int, ...]] = None) -> ServeRun:
    """Make a corpus from ``seed`` on ``device``, build the index, and
    serve ``n_requests`` queries through `AsyncRetrievalServer`."""
    dev = resolve_device(device)
    data = synthetic.make_retrieval_corpus(spec, seed=seed, device=dev)
    retriever = Retriever(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.perf_counter()
    state = retriever.build(gen, Corpus(data.doc_patches, data.doc_mask,
                                        data.doc_salience))
    _sync(dev)
    build_s = time.perf_counter() - t0
    queries = tuple(a.cpu().numpy() for a in (
        data.query_patches, data.query_mask, data.query_salience))
    relevance = data.relevance.cpu().numpy()
    del data  # the float corpus is not needed to serve
    return serve_state(retriever, state, queries, relevance,
                       n_requests=n_requests, max_batch=max_batch,
                       top_k=top_k, device=dev, rate_qps=rate_qps,
                       ladder=ladder, build_s=build_s)


def serve_state(retriever: Retriever, state: RetrieverState,
                queries: Tuple[np.ndarray, np.ndarray, np.ndarray],
                relevance: np.ndarray, *, n_requests: int, max_batch: int,
                top_k: int, device, rate_qps: float = 0.0,
                ladder: Optional[Tuple[int, ...]] = None,
                build_s: float = 0.0) -> ServeRun:
    """Serve ``n_requests`` of the host ``queries`` over a built ``state``
    through `AsyncRetrievalServer` (every ladder rung warmed first, out of
    the window's stats), and score the results against ``relevance``."""
    dev = resolve_device(device)

    def search(q, qm, qs):
        return retriever.search(state, Query(q, qm, qs), k=top_k)

    server = AsyncRetrievalServer(
        search, ServeConfig(max_batch=max_batch, top_k=top_k, ladder=ladder),
        device=dev)
    # run every ladder rung once, out of the serving window's stats
    t0 = time.perf_counter()
    server.warm_shapes(*(a[0] for a in queries))
    warm_s = time.perf_counter() - t0

    async def _serve():
        t0 = time.perf_counter()
        results = await drive(server, *queries, n_requests=n_requests,
                              rate_qps=rate_qps, seed=1)
        wall = time.perf_counter() - t0
        await server.aclose()
        return results, wall

    results, serve_s = asyncio.run(_serve())
    hits, recall = 0, 0.0
    for i, (_, ids) in enumerate(results):
        rel = relevance[i % len(relevance)]
        found = rel[ids[ids >= 0]]
        hits += int((found > 0).any())
        # the reference's recall@k: its relevant docs are rel >= 2
        recall += (found >= RECALL_RELEVANCE).sum() / max(
            1, (rel >= RECALL_RELEVANCE).sum())
    n = max(1, len(results))
    return ServeRun(retriever, state, queries, results, build_s, warm_s,
                    server.ladder, serve_s, retriever.storage_bytes(state),
                    server.stats(), hits / n, float(recall / n), relevance)


def main(argv=None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--backend", default=None,
                    choices=list(available_backends()),
                    help="index backend (wins over --mode/--index)")
    ap.add_argument("--mode", default=None,
                    choices=["float", "quantized", "binary"],
                    help="deprecated: use --backend")
    ap.add_argument("--index", default=None, choices=["flat", "ivf"],
                    help="deprecated: use --backend")
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--p", type=float, default=60.0)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--rate-qps", type=float, default=0.0,
                    help="open-loop Poisson arrival rate (0 = closed loop)")
    ap.add_argument("--single-shape", action="store_true",
                    help="pad every batch to --max-batch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain path)")
    args = ap.parse_args(argv)

    spec = synthetic.CorpusSpec(n_docs=args.n_docs, n_queries=args.queries)
    backend = args.backend
    if backend is None and args.mode is None and args.index is None:
        backend = "flat"
    cfg = HPCConfig(k=args.k, p=args.p, backend=backend, mode=args.mode,
                    index=args.index, prune_side="doc", rerank=32)
    run = build_and_serve(
        spec, cfg, n_requests=args.queries, max_batch=args.max_batch,
        top_k=args.top_k, device=args.device, seed=0,
        rate_qps=args.rate_qps,
        ladder=(args.max_batch,) if args.single_shape else None)
    st = run.stats
    print(f"index[{cfg.backend}] built in {run.build_s:.2f}s | "
          f"storage {run.storage}")
    print(f"ladder {run.ladder} warmed in {run.warm_s:.2f}s")
    rungs = " ".join(f"B={b}:{v['batches']}x@{v['occupancy']:.2f}"
                     for b, v in st["rungs"].items())
    print(f"served {args.queries} queries in {run.serve_s:.2f}s "
          f"({st['qps']:.1f} QPS) | hit@{args.top_k} {run.hit_rate:.3f} "
          f"recall@{args.top_k} {run.recall:.3f} | "
          f"p50 {st['p50_ms']:.1f}ms p99 {st['p99_ms']:.1f}ms | "
          f"mean batch {st['mean_batch']:.1f}")
    print(f"ladder occupancy: {rungs}")
    return run


if __name__ == "__main__":
    main()

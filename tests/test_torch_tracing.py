"""The port's tracer (``repro_torch.tracing``) on the CPU.

Off, it records nothing and hands out one shared context; on, its spans
carry their name, parent, batch and thread. Through a tiny
`AsyncRetrievalServer` the serving spans nest as the server runs them and
agree with its ``stats()``; the flat and cascade searches answer
bit for bit alike with tracing on and off.
"""
import asyncio
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro_torch import tracing
from repro_torch.data import synthetic
from repro_torch.retrieval import (CascadeConfig, Corpus, HPCConfig, Query,
                                   Retriever)
from repro_torch.serving.server import AsyncRetrievalServer, ServeConfig

SPEC = synthetic.CorpusSpec(n_docs=96, n_queries=12, n_patches=12,
                            n_q_patches=4, dim=16, n_topics=6)
CONFIGS = {
    "flat": HPCConfig(k=32, rerank=8, kmeans_iters=5, kmeans_restarts=1,
                      scan_block_docs=32),
    "cascade": HPCConfig(k=32, backend="cascade", kmeans_iters=5,
                         kmeans_restarts=1, scan_block_docs=32,
                         cascade=CascadeConfig(p1=32, p2=12)),
}


@pytest.fixture
def traced():
    """The tracer on and empty; off and empty again afterwards."""
    tracing.reset()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.reset()


@pytest.fixture(scope="module")
def data():
    return synthetic.make_retrieval_corpus(SPEC, seed=3, device="cpu")


@pytest.fixture(scope="module")
def built(data):
    corpus = Corpus(data.doc_patches, data.doc_mask, data.doc_salience)
    out = {}
    for name, cfg in CONFIGS.items():
        r = Retriever(cfg)
        out[name] = (r, r.build(torch.Generator().manual_seed(0), corpus))
    return out


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing_and_shares_one_context():
    tracing.reset()
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", batch=3)
    assert a is b is tracing.OFF
    with a:
        tracing.record("r", 0.0, 1.0)
    assert tracing.spans() == []


def test_nested_and_threaded_spans_get_their_parents(traced):
    seen = {}

    def worker():
        with tracing.span("t.outer", batch=7):
            with tracing.span("t.inner"):
                seen["thread"] = threading.current_thread().name

    with tracing.span("m.outer", batch=1):
        with tracing.span("m.inner"):
            th = threading.Thread(target=worker, name="tracing-worker")
            th.start()
            th.join(timeout=10)
        tracing.record("m.rec", 1.0, 2.0, batch=4)
    assert not th.is_alive()
    s = {x.name: x for x in tracing.spans()}
    assert set(s) == {"m.outer", "m.inner", "t.outer", "t.inner", "m.rec"}
    assert s["m.outer"].parent_id is None and s["m.outer"].batch == 1
    assert s["m.inner"].parent_id == s["m.outer"].span_id
    assert s["m.inner"].batch == 1          # taken from the parent
    # a thread's spans start their own stack: no parent on another thread
    assert s["t.outer"].parent_id is None and s["t.outer"].batch == 7
    assert s["t.inner"].parent_id == s["t.outer"].span_id
    assert s["t.inner"].thread == seen["thread"] == "tracing-worker"
    assert s["m.outer"].thread == threading.current_thread().name
    # a record has the ends it was given and no parent
    assert s["m.rec"][3:] == (4, s["m.outer"].thread, 1.0, 2.0)
    assert s["m.rec"].parent_id is None
    for name in ("m.outer", "m.inner", "t.outer", "t.inner"):
        assert s[name].start <= s[name].end
    assert s["m.outer"].start <= s["m.inner"].start <= s["m.inner"].end \
        <= s["m.outer"].end
    assert len({x.span_id for x in s.values()}) == 5
    tracing.reset()
    assert tracing.spans() == []


def test_many_threads_lose_no_span_or_count(traced):
    """More threads than cores, switching as often as the interpreter
    allows: every span and record lands, ids stay unique and each inner
    span's parent is its own thread's outer span."""
    n_threads, n_iter = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n_iter):
                with tracing.span("s.outer", batch=i):
                    with tracing.span("s.inner"):
                        tracing.record("s.rec", 0.0, 1.0, batch=i)

        with ThreadPoolExecutor(n_threads) as pool:
            futures = [pool.submit(work, i) for i in range(n_threads)]
            for f in futures:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    spans = tracing.spans()
    assert len(spans) == 3 * n_threads * n_iter
    ids = {s.span_id: s for s in spans}
    assert len(ids) == len(spans)
    for s in spans:
        if s.name == "s.inner":
            parent = ids[s.parent_id]
            assert parent.name == "s.outer" and parent.thread == s.thread
            assert parent.batch == s.batch
    recs = [s for s in spans if s.name == "s.rec"]
    assert len(recs) == n_threads * n_iter
    for i in range(n_threads):
        assert sum(s.batch == i for s in recs) == n_iter


def test_span_closed_after_disable_is_kept(traced):
    with tracing.span("late"):
        tracing.disable()
        with tracing.span("never"):
            pass
    assert [s.name for s in tracing.spans()] == ["late"]


def _queries(data):
    return tuple(a.numpy() for a in (data.query_patches, data.query_mask,
                                     data.query_salience))


def _serve(server, q, qm, qs):
    async def go():
        out = await asyncio.gather(*(server.query(q[i], qm[i], qs[i])
                                     for i in range(len(q))))
        await server.aclose()
        return out
    return asyncio.run(go())


def test_server_records_its_spans_and_counters(data, built, traced):
    r, state = built["flat"]
    server = AsyncRetrievalServer(
        lambda q, qm, qs: r.search(state, Query(q, qm, qs), k=5),
        ServeConfig(max_batch=4, max_wait_ms=20.0, top_k=5), device="cpu")
    q, qm, qs = _queries(data)
    tracing.disable()
    server.warm_shapes(q[0], qm[0], qs[0])
    tracing.enable()
    results = _serve(server, q, qm, qs)
    assert len(results) == len(q)
    spans = tracing.spans()
    by = _by_name(spans)
    ids = {s.span_id: s for s in spans}
    st = server.stats()
    n_batches = len(server.batch_sizes)
    batches = {s.batch for s in by["serve.stage"]}
    assert len(batches) == n_batches and None not in batches
    # one queue wait per request, each ending where its batch was staged
    assert len(by["serve.queue"]) == len(q)
    stage_of = {s.batch: s for s in by["serve.stage"]}
    for w in by["serve.queue"]:
        assert w.start <= w.end <= stage_of[w.batch].start
    for name in ("serve.coalesce", "serve.inflight_wait", "serve.h2d",
                 "serve.search", "serve.d2h", "serve.fanout"):
        assert {s.batch for s in by[name]} == batches, name
    for h in by["serve.h2d"]:
        assert ids[h.parent_id].name == "serve.stage"
        assert h.batch == ids[h.parent_id].batch
    # the search runs on an executor thread, the fan-out on the loop's
    for s in by["serve.search"] + by["serve.d2h"]:
        assert s.thread.startswith("serve-compute") and s.parent_id is None
    loop_thread = threading.current_thread().name
    assert {s.thread for s in by["serve.stage"] + by["serve.fanout"]} == {
        loop_thread}
    for s in by["retrieval.search"]:
        parent = ids[s.parent_id]
        assert parent.name == "serve.search" and parent.batch == s.batch
        assert s.thread == parent.thread
        assert parent.start <= s.start <= s.end <= parent.end
    assert len(by["retrieval.search"]) == n_batches
    for name in ("retrieval.prune_query", "retrieval.backend",
                 "retrieval.rerank"):
        assert [ids[s.parent_id].name for s in by[name]] == \
            ["retrieval.search"] * n_batches, name
    # the spans agree with the server's own count
    assert n_batches == sum(v["batches"] for v in st["rungs"].values())
    assert len(by["serve.queue"]) == st["n"] == len(q)
    assert sorted(len([w for w in by["serve.queue"] if w.batch == b])
                  for b in batches) == sorted(server.batch_sizes)
    assert len(by["serve.h2d"]) == len(by["serve.fanout"]) == n_batches


def _search(r, state, data, traced_on):
    if traced_on:
        tracing.reset()
        tracing.enable()
    try:
        q = Query(data.query_patches, data.query_mask, data.query_salience)
        return r.search(state, q, k=5)
    finally:
        tracing.disable()


@pytest.mark.parametrize("backend", sorted(CONFIGS))
def test_answers_are_the_same_with_tracing_on(data, built, backend):
    r, state = built[backend]
    off = _search(r, state, data, False)
    try:
        on = _search(r, state, data, True)
        spans = tracing.spans()
    finally:
        tracing.reset()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    by = _by_name(spans)
    ids = {s.span_id: s for s in spans}

    def parent(s):
        return ids[s.parent_id].name

    assert len(by["retrieval.search"]) == 1
    if backend == "cascade":
        for stage in ("cascade.stage1", "cascade.stage2", "cascade.stage3"):
            (s,) = by[stage]
            assert parent(s) == "retrieval.backend"
            assert parent(ids[s.parent_id]) == "retrieval.search"
        under_stage1 = []
        for s in by["scan.merge"]:
            p = s
            while p.parent_id is not None:
                p = ids[p.parent_id]
                if p.name == "cascade.stage1":
                    under_stage1.append(s)
        assert under_stage1
        assert [parent(s) for s in by["hamming.query_codes"]] == [
            "cascade.stage1"]
        assert "retrieval.rerank" not in by
    else:
        assert [parent(s) for s in by["retrieval.rerank"]] == [
            "retrieval.search"]
    assert by["scan.merge"]
    assert all(s.batch is None for s in spans)

"""Live-index serving: mutations interleaved with queries.

The port's counterpart of tests/test_segments.py's
``test_live_session_mutations_keep_ladder_rung_set``, and queries served
while another thread adds, upserts, deletes and compacts: every response
equals `Retriever.search` on one published state, and no response carries
an id deleted before its batch began. The cascade's degradation ladder
runs on the segmented state at every level. Every test that waits on a
thread runs under a short time limit.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.serving import LiveIndexSession as JLiveIndexSession
from repro_torch.data import synthetic
from repro_torch.retrieval import (CascadeConfig, Corpus, HPCConfig, Query,
                                   Retriever)
from repro_torch.serving import (LiveIndexSession, ResilienceConfig,
                                 ServeConfig, Served)

SPEC = synthetic.CorpusSpec(n_docs=96, n_queries=16, n_patches=8,
                            n_q_patches=4, dim=16, n_topics=4,
                            patches_per_topic=8, noise=0.1)
LIMIT_S = 30.0


@pytest.fixture(scope="module")
def data():
    return synthetic.make_retrieval_corpus(SPEC, seed=7, device="cpu")


def _slice(data, lo, hi):
    return Corpus(data.doc_patches[lo:hi], data.doc_mask[lo:hi],
                  data.doc_salience[lo:hi])


def _q(data, i):
    return tuple(a[i].numpy() for a in (data.query_patches, data.query_mask,
                                         data.query_salience))


def test_live_session_api_matches_jax():
    for name in ("add", "delete", "compact", "query", "submit",
                 "warm_shapes", "stats", "recompile_report", "build_stats",
                 "close", "state_signatures", "segment_shapes"):
        assert hasattr(LiveIndexSession, name), name
        assert hasattr(JLiveIndexSession, name), name


def test_live_session_mutations_keep_ladder_rung_set(data):
    r = Retriever(HPCConfig(k=32, p=80.0, backend="flat", kmeans_iters=4,
                            kmeans_restarts=2, rerank=16))
    state = r.build(torch.Generator().manual_seed(0), _slice(data, 0, 60))
    sess = LiveIndexSession(r, state, ServeConfig(
        max_batch=4, top_k=5, guard_recompiles=True, max_wait_ms=1.0))
    qe, qm, qs = (a.numpy() for a in (data.query_patches, data.query_mask,
                                      data.query_salience))
    try:
        sess.warm_shapes(qe[0], qm[0], qs[0])
        sess.server.reset_stats()
        for i in range(6):
            sess.query(qe[i], qm[i], qs[i], timeout=LIMIT_S)
            if i == 1:
                sess.add(_slice(data, 60, 70))          # ids 60..69
            if i == 2:
                sess.delete(np.array([0, 5, 63]))
            if i == 3:
                sess.add(_slice(data, 70, 71),
                         doc_ids=np.array([7]))         # upsert doc 7
            if i == 4:
                sess.compact()
        out = sess.query(qe[6], qm[6], qs[6], timeout=LIMIT_S)
        assert isinstance(out, Served) and out.level == 0
        assert not ({0, 5, 63} & set(int(x) for x in out[1]))
        sentry = sess.server.recompile_sentry
        assert sentry.signatures, "sentry saw no traffic"
        for key in sentry.signatures:
            assert key[0] in sess.server.ladder, (key, sess.server.ladder)
        # pow2-bucketed and bounded; the 67 live docs compact into 128
        assert len(sess.state_signatures()) <= 6
        assert sess.segment_shapes() == ((128,),)
        assert sess.build_stats()["segments"] == 1.0
    finally:
        sess.close()


def test_queries_during_concurrent_mutations_match_one_published_state(data):
    r = Retriever(HPCConfig(k=32, p=80.0, backend="flat", kmeans_iters=4,
                            kmeans_restarts=1, rerank=16))
    state = r.build(torch.Generator().manual_seed(1), _slice(data, 0, 48))
    sess = LiveIndexSession(r, state, ServeConfig(
        max_batch=4, top_k=6, max_wait_ms=1.0))
    published = [sess.state]
    publish = sess._publish

    def recording_publish(new_state):
        published.append(new_state)
        publish(new_state)

    sess._publish = recording_publish
    deleted = {}                      # id -> time its delete was published

    def mutate():
        sess.add(_slice(data, 48, 64))
        sess.add(_slice(data, 64, 72), doc_ids=np.arange(20, 28))  # upserts
        sess.delete(np.array([1, 2, 50]))
        t = time.perf_counter()
        deleted.update({1: t, 2: t, 50: t})
        sess.add(_slice(data, 72, 80))
        sess.compact()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # interleave the threads finely
    try:
        sess.warm_shapes(*_q(data, 0))
        mutator = threading.Thread(target=mutate)
        reqs = []
        mutator.start()
        for i in range(48):
            reqs.append((i % 16, time.perf_counter(),
                         sess.submit(*_q(data, i % 16))))
            time.sleep(0.002)
        mutator.join(LIMIT_S)
        assert not mutator.is_alive()
        for qi, t_sub, req in reqs:
            assert req.event.wait(LIMIT_S) and req.error is None
            scores, ids = req.result
            q = Query(*(a[qi:qi + 1] for a in (
                data.query_patches, data.query_mask, data.query_salience)))
            matches = []
            for st in published:
                ws, wi = r.search(st, q, k=6)
                matches.append(np.array_equal(wi[0].numpy(), ids)
                               and np.allclose(ws[0].numpy(), scores,
                                               rtol=1e-5, atol=1e-5))
            assert any(matches), (qi, ids)
            for doc, t_del in deleted.items():
                if t_sub > t_del:
                    assert doc not in set(ids.tolist()), (qi, doc)
        assert len(published) == 6
    finally:
        sys.setswitchinterval(switch)
        sess.close()


def test_live_cascade_degraded_levels_on_a_segmented_state(data):
    """The degradation ladder's functions read the session's current
    (segmented) state; each level equals Retriever.search_degraded on it,
    and the guarded sentry holds exactly rungs x levels."""
    r = Retriever(HPCConfig(k=16, p=80.0, backend="cascade",
                            cascade=CascadeConfig(p1=32, p2=12),
                            kmeans_iters=4, kmeans_restarts=1))
    state = r.build(torch.Generator().manual_seed(2), _slice(data, 0, 64))
    sess = LiveIndexSession(r, state, ServeConfig(
        max_batch=4, top_k=5, max_wait_ms=1.0, guard_recompiles=True,
        resilience=ResilienceConfig()))
    try:
        rungs = sess.degrade_rungs
        assert rungs == r.degrade_rungs(state, k=5) and rungs[-1] is None
        sess.warm_shapes(*_q(data, 0))
        sess.add(_slice(data, 64, 80))
        sess.delete(np.array([3, 70]))
        sess.add(_slice(data, 80, 81), doc_ids=np.array([9]))
        st = sess.state
        assert [lv.shape[0] for lv in r.backend._segmented(st).live] == \
            [64, 16, 8]
        q = tuple(torch.from_numpy(np.stack([a] * 2))
                  for a in _q(data, 1))
        fns = sess.server._async.search_fns
        assert len(fns) == 1 + len(rungs)
        for level, fn in enumerate(fns):
            got = fn(*q)
            want = (r.search(st, Query(*q), k=5) if level == 0 else
                    r.search_degraded(st, Query(*q), k=5,
                                      rung=rungs[level - 1]))
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            assert got[0].dtype == torch.float32
            assert not ({3, 70} & set(got[1].flatten().tolist()))
        sigs = set(sess.server.recompile_sentry.signatures)
        assert sigs == {(b, 4, "torch.float32", "torch.bool",
                         "torch.float32", lv)
                        for b in sess.server.ladder
                        for lv in range(len(fns))}
        out = sess.query(*_q(data, 2), timeout=LIMIT_S)
        assert isinstance(out, Served) and out.level == 0
    finally:
        sess.close()

"""The `hnsw` backend: the port against the JAX package.

torch cannot replay the reference's level draws, so the graphs are
compared given the reference's levels: the port's construction (build,
insert and compact) must give the reference's adjacency, entry and levels.
On the reference's built graphs the port's walk must return the same
candidates, and its searches the same results (scores within 1e-5; a
differing pair is allowed only where the two walk distances tie within
1e-6 relative). Then the counterparts of tests/test_hnsw.py on the port's
own builds: determinism, graph invariants, build stats, recall against IVF
at an equal budget, recall monotone in ef, and sentinel rows.
"""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.ann_compare import tie_aware_recall_at_k
from repro.core import graph as jax_graph
from repro.core.graph import HNSWConfig as JHNSWConfig
from repro.data import synthetic as jax_synthetic
from repro.retrieval import Corpus as JCorpus
from repro.retrieval import HPCConfig as JConfig
from repro.retrieval import Query as JQuery
from repro.retrieval import Retriever as JRetriever
from repro_torch import state_from_numpy
from repro_torch.core import graph as graph_mod
from repro_torch.core import late_interaction as li
from repro_torch.data import synthetic
from repro_torch.retrieval import (Corpus, HNSWConfig, HPCConfig, IVFConfig,
                                   Query, Retriever)
from tests._torch_parity import state_arrays, to_torch

K = 10
SPEC = dict(n_docs=256, n_queries=32, n_patches=16, n_q_patches=4, dim=32,
            n_topics=8, dup_per_doc=3)              # tests/test_hnsw.py:29
HNSW = dict(m=8, ef_construction=48, ef_search=64, levels=4)
BASE = dict(k=64, p=60.0, prune_side="doc", kmeans_iters=10,
            kmeans_restarts=2)
TOL = 1e-5
TIE = 1e-6


@pytest.fixture(scope="module")
def reference():
    """(numpy corpus, JAX retriever, JAX-built hnsw state)."""
    data = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(0), jax_synthetic.CorpusSpec(**SPEC))
    data = data._replace(**{f: np.asarray(getattr(data, f))
                            for f in data._fields})
    jret = JRetriever(JConfig(backend="hnsw", hnsw=JHNSWConfig(**HNSW),
                              **BASE))
    return data, jret, jret.build(jax.random.PRNGKey(1), _jcorpus(data))


def _jcorpus(data, lo=0, hi=None):
    return JCorpus(*(jnp.asarray(a[lo:hi]) for a in (
        data.doc_patches, data.doc_mask, data.doc_salience)))


def _queries(data):
    return (JQuery(*map(jnp.asarray, (data.query_patches, data.query_mask,
                                      data.query_salience))),
            Query(*to_torch(data.query_patches, data.query_mask,
                            data.query_salience)))


def _port(jstate):
    return state_from_numpy(state_arrays(jstate, "hnsw"), device="cpu",
                            backend="hnsw")


def _same_graph(got, want):
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    np.testing.assert_array_equal(got.node_level.numpy(),
                                  np.asarray(want.node_level))
    assert got.entry == int(want.entry)
    np.testing.assert_array_equal(got.doc_vecs.numpy(),
                                  np.asarray(want.doc_vecs))
    for f in ("codes", "mask", "doc_ids"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def _candidates_match(got, want, doc_vecs, q_vec):
    """Equal candidate ids, distances within TOL; a differing position
    only where the two candidates' distances tie within TIE relative."""
    (g_d, g_i), (w_d, w_i) = got, want
    g_d, g_i = g_d.numpy(), g_i.numpy()
    w_d, w_i = np.asarray(w_d), np.asarray(w_i)
    fin = np.isfinite(w_d)
    np.testing.assert_array_equal(np.isfinite(g_d), fin)
    np.testing.assert_allclose(g_d[fin], w_d[fin], atol=TOL, rtol=TOL)
    x = np.asarray(doc_vecs, np.float64)
    q = np.asarray(q_vec, np.float64)
    for b, j in zip(*np.nonzero(g_i != w_i)):
        assert g_i[b, j] >= 0 and w_i[b, j] >= 0, (b, j)
        da = ((x[g_i[b, j]] - q[b]) ** 2).sum()
        db = ((x[w_i[b, j]] - q[b]) ** 2).sum()
        assert abs(da - db) <= TIE * max(abs(db), 1e-30), (b, j, da, db)


# ---------------------------------------------------------------------------
# Construction given the reference's levels
# ---------------------------------------------------------------------------

def test_build_given_levels_is_the_reference_graph(reference):
    _, _, jst = reference
    jix = jst.backend_state.index
    ix = _port(jst).backend_state.index
    got = graph_mod.build_hnsw(None, ix.codes, ix.mask, ix.codebook,
                               HNSWConfig(**HNSW),
                               levels=np.asarray(jix.node_level))
    _same_graph(got, jix)


def test_insert_given_levels_is_the_reference_graph(reference):
    data, _, jst = reference
    jix = jst.backend_state.index
    rng = np.random.default_rng(3)
    md = jix.codes.shape[1]
    codes = rng.integers(0, 64, (40, md)).astype(np.uint8)
    mask = rng.random((40, md)) < 0.9
    ids = np.arange(256, 296, dtype=np.int32)
    levels = np.minimum(rng.geometric(0.6, 40) - 1, 3)
    live = jnp.ones((256,), bool).at[7].set(False)
    want, want_live = jax_graph.hnsw_insert(
        jix, live, jnp.asarray(codes), jnp.asarray(mask), jnp.asarray(ids),
        JHNSWConfig(**HNSW), levels=levels)
    ix = _port(jst).backend_state.index
    got, got_live = graph_mod.hnsw_insert(
        ix, torch.from_numpy(np.asarray(live)), *to_torch(codes, mask, ids),
        HNSWConfig(**HNSW), levels=levels)
    _same_graph(got, want)
    np.testing.assert_array_equal(got_live.numpy(), np.asarray(want_live))
    assert got.neighbors.shape[1] == 512                  # pow2 growth
    # the input state is untouched
    assert ix.neighbors.shape[1] == 256 and ix.codes.shape[0] == 256


def test_compact_is_the_reference_graph(reference):
    _, _, jst = reference
    jix = jst.backend_state.index
    live = np.ones((256,), bool)
    live[[0, 5, 19, 100, 255]] = False                   # 19: the entry
    want, want_live = jax_graph.hnsw_compact(jix, jnp.asarray(live),
                                             JHNSWConfig(**HNSW))
    got, got_live = graph_mod.hnsw_compact(_port(jst).backend_state.index,
                                           torch.from_numpy(live),
                                           HNSWConfig(**HNSW))
    _same_graph(got, want)
    np.testing.assert_array_equal(got_live.numpy(), np.asarray(want_live))


def test_level_draws_are_deterministic():
    cfg = HNSWConfig(**HNSW)
    a = graph_mod.draw_levels(torch.Generator().manual_seed(4), 5000, cfg)
    b = graph_mod.draw_levels(torch.Generator().manual_seed(4), 5000, cfg)
    np.testing.assert_array_equal(a, b)
    assert a.min() == 0 and a.max() == cfg.levels - 1
    # P(level >= 1) = 1/m
    assert abs((a >= 1).mean() - 1 / cfg.m) < 0.02
    c = graph_mod.draw_levels(graph_mod.insert_generator(10), 64, cfg)
    np.testing.assert_array_equal(
        c, graph_mod.draw_levels(graph_mod.insert_generator(10), 64, cfg))


# ---------------------------------------------------------------------------
# Search over the reference's graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ef", [16, 64, 128])
def test_candidates_on_jax_graph_match_jax(reference, ef):
    data, _, jst = reference
    jix = jst.backend_state.index
    q_vec = jax_graph.mean_pool(jnp.asarray(data.query_patches),
                                jnp.asarray(data.query_mask))
    want = jax.vmap(lambda v: jax_graph.hnsw_candidates(
        jix, v, ef_search=ef))(q_vec)
    got = graph_mod.hnsw_candidates(_port(jst).backend_state.index,
                                    torch.from_numpy(np.asarray(q_vec)),
                                    ef_search=ef)
    _candidates_match(got, want, jix.doc_vecs, q_vec)


def test_beam_follows_the_reference_visited_update():
    """A row with empty slots rewrites node 0's visited bit with its old
    value in the reference's scatter, so node 0 can enter the beam twice;
    the port's beam gives the same candidates."""
    rng = np.random.default_rng(0)
    n, w = 12, 4
    x = rng.normal(size=(n, 3)).astype(np.float32)
    nb = np.full((n, w), -1, np.int32)
    for i in range(n):
        k = int(rng.integers(1, w + 1))
        nb[i, :k] = [j for j in rng.permutation(n) if j != i][:k]
    nb[1, :2], nb[2, :2], nb[3, :2] = [0, 2], [0, 3], [0, 1]
    q = rng.normal(size=(5, 3)).astype(np.float32)
    for entry in (1, 5):
        for ef in (4, 8):
            xj = jnp.asarray(x)
            want = jax.vmap(lambda v: jax_graph._beam_level0(
                xj, jnp.asarray(nb), v, jnp.int32(entry),
                jnp.sum((xj[entry] - v) ** 2), ef))(jnp.asarray(q))
            xt, qt = torch.from_numpy(x), torch.from_numpy(q)
            got = graph_mod._beam_level0(
                xt, torch.from_numpy(nb), qt, torch.full((5,), entry),
                ((xt[entry] - qt) ** 2).sum(-1), ef)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       atol=TOL, rtol=TOL)
            if ef == 8:
                assert ((np.asarray(want[1]) == 0).sum(axis=1) == 2).all()


def _search_match(got, want):
    got_s, got_i = (t.numpy() for t in got)
    want_s, want_i = map(np.asarray, want)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)


def test_search_hnsw_on_jax_graph_matches_jax(reference):
    data, _, jst = reference
    jq, tq = _queries(data)
    ix = _port(jst).backend_state.index
    for ef, k in ((64, 10), (16, 24)):
        want = jax_graph.search_hnsw(jst.backend_state.index, jq.embeddings,
                                     jq.mask, ef_search=ef, k=k)
        got = graph_mod.search_hnsw(ix, tq.embeddings, tq.mask, ef_search=ef,
                                    k=k)
        _search_match(got, want)


def test_search_hnsw_live_on_jax_churned_state_matches_jax(reference):
    data, jret, jst = reference
    jq, tq = _queries(data)
    st = jret.delete(jst, np.array([4, 40, 77, 130, 201]))
    seg = st.backend_state.index
    want = jax_graph.search_hnsw_live(seg.segments[0], seg.live[0],
                                      jq.embeddings, jq.mask, ef_search=64,
                                      k=12)
    pseg = _port(st).backend_state.index
    got = graph_mod.search_hnsw_live(pseg.segments[0], pseg.live[0],
                                     tq.embeddings, tq.mask, ef_search=64,
                                     k=12)
    _search_match(got, want)
    ret = Retriever(HPCConfig(backend="hnsw", hnsw=HNSWConfig(**HNSW),
                              rerank=16, **BASE))
    jret16 = JRetriever(JConfig(backend="hnsw", hnsw=JHNSWConfig(**HNSW),
                                rerank=16, **BASE))
    _search_match(ret.search(_port(st), tq, k=K), jret16.search(st, jq, k=K))


def test_build_stats_and_storage_match_jax(reference):
    data, jret, jst = reference
    ret = Retriever(HPCConfig(backend="hnsw", hnsw=HNSWConfig(**HNSW),
                              **BASE))
    assert ret.build_stats(_port(jst)) == jret.build_stats(jst)
    assert ret.storage_bytes(_port(jst)) == jret.storage_bytes(jst)
    st = jret.delete(jst, np.array([4, 40]))
    assert ret.build_stats(_port(st)) == jret.build_stats(st)
    assert ret.storage_bytes(_port(st)) == jret.storage_bytes(st)


def test_hnsw_declines_candidate_pools(reference):
    data, _, jst = reference
    _, tq = _queries(data)
    ret = Retriever(HPCConfig(backend="hnsw", **BASE))
    with pytest.raises(NotImplementedError, match="graph walk"):
        ret.backend.search_candidates(_port(jst), tq,
                                      torch.zeros((32, 4), dtype=torch.int32),
                                      k=3)


def test_descent_counts_its_syncs(reference):
    data, _, jst = reference
    _, tq = _queries(data)
    before = graph_mod.SYNCS
    graph_mod.search_hnsw(_port(jst).backend_state.index, tq.embeddings,
                          tq.mask, ef_search=16, k=5)
    # at least one step on each of the 3 upper levels
    assert graph_mod.SYNCS - before >= 3


# ---------------------------------------------------------------------------
# The port's own builds: the counterparts of tests/test_hnsw.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_build(reference):
    data, _, _ = reference
    corpus = Corpus(*to_torch(data.doc_patches, data.doc_mask,
                              data.doc_salience))
    r = Retriever(HPCConfig(backend="hnsw", hnsw=HNSWConfig(**HNSW), **BASE))
    flat = Retriever(HPCConfig(backend="flat", **BASE))
    oracle = flat.search(flat.build(torch.Generator().manual_seed(1), corpus),
                         _queries(data)[1], k=K)
    return corpus, r, r.build(torch.Generator().manual_seed(1), corpus), \
        oracle[0].numpy()


def test_graph_build_deterministic(port_build):
    _, _, st, _ = port_build
    ix = st.backend_state.index
    g1 = graph_mod.build_hnsw(torch.Generator().manual_seed(42), ix.codes,
                              ix.mask, ix.codebook, HNSWConfig(**HNSW))
    g2 = graph_mod.build_hnsw(torch.Generator().manual_seed(42), ix.codes,
                              ix.mask, ix.codebook, HNSWConfig(**HNSW))
    assert g1.entry == g2.entry
    for f in ("doc_vecs", "neighbors", "node_level"):
        assert torch.equal(getattr(g1, f), getattr(g2, f)), f


def test_graph_invariants(port_build):
    _, _, st, _ = port_build
    ix = st.backend_state.index
    nbrs = ix.neighbors.numpy()
    n = ix.doc_vecs.shape[0]
    assert nbrs.shape == (HNSW["levels"], n, 2 * HNSW["m"])
    assert nbrs.min() >= -1 and nbrs.max() < n
    for lev in range(HNSW["levels"]):
        rows = nbrs[lev]
        assert not np.any(rows == np.arange(n)[:, None])
        filled = rows >= 0
        assert np.all(filled[:, :-1] | ~filled[:, 1:])
        if lev >= 1:
            assert filled.sum(axis=1).max() <= HNSW["m"]
    adj = [set() for _ in range(n)]
    for i in range(n):
        for v in nbrs[0, i]:
            if v >= 0:
                adj[i].add(int(v))
                adj[int(v)].add(i)
    seen, dq = {0}, deque([0])
    while dq:
        u = dq.popleft()
        for v in adj[u] - seen:
            seen.add(v)
            dq.append(v)
    assert len(seen) == n


def test_build_stats(port_build):
    _, r, st, _ = port_build
    stats = r.build_stats(st)
    assert 0 < stats["mean_degree_l0"] <= 2 * HNSW["m"]
    assert stats["levels"] == HNSW["levels"]
    assert stats["entry_level"] == int(
        st.backend_state.index.node_level.max())


def test_recall_meets_ivf_at_equal_budget(reference, port_build):
    data, _, _ = reference
    corpus, r_h, st_h, oracle = port_build
    _, tq = _queries(data)
    r_i = Retriever(HPCConfig(backend="ivf", ivf=IVFConfig(
        n_list=16, n_probe=2, iters=8), **BASE))
    st_i = r_i.build(torch.Generator().manual_seed(1), corpus)
    cap = st_i.backend_state.index.bucket_codes.shape[1]
    assert 2 * cap == HNSW["ef_search"] < data.doc_patches.shape[0]
    s_h, i_h = r_h.search(st_h, tq, k=K)
    s_i, i_i = r_i.search(st_i, tq, k=K)
    rec_h = tie_aware_recall_at_k(s_h.numpy(), i_h.numpy(), oracle, K)
    rec_i = tie_aware_recall_at_k(s_i.numpy(), i_i.numpy(), oracle, K)
    assert rec_h >= rec_i, (rec_h, rec_i)
    assert rec_h >= 0.9, rec_h


def test_ef_search_monotonicity(reference, port_build):
    data, _, _ = reference
    _, _, st, oracle = port_build
    _, tq = _queries(data)
    ix = st.backend_state.index
    prev = -1.0
    for ef in (10, 16, 32, 64, 128):
        s, ids = graph_mod.search_hnsw(ix, tq.embeddings, tq.mask,
                                       ef_search=ef, k=K)
        rec = tie_aware_recall_at_k(s.numpy(), ids.numpy(), oracle, K)
        assert rec >= prev, (ef, rec, prev)
        prev = rec
    assert prev >= 0.95


def test_sentinel_rows_when_beam_exceeds_corpus():
    spec = synthetic.CorpusSpec(n_docs=12, n_queries=4, n_patches=8,
                                n_q_patches=4, dim=16, n_topics=2,
                                dup_per_doc=1)
    data = synthetic.make_retrieval_corpus(spec, seed=2, device="cpu")
    cfg = HPCConfig(k=8, p=100.0, prune_side="none", kmeans_iters=5,
                    backend="hnsw", hnsw=HNSWConfig(m=4, ef_construction=16,
                                                    ef_search=32, levels=2))
    r = Retriever(cfg)
    state = r.build(torch.Generator().manual_seed(3),
                    Corpus(data.doc_patches, data.doc_mask,
                           data.doc_salience))
    q = Query(data.query_patches, data.query_mask, data.query_salience)
    scores, ids = (t.numpy() for t in r.search(state, q, k=16))
    assert np.all(np.sum(ids >= 0, axis=1) == 12)
    assert np.all(ids[:, 12:] == -1)
    assert np.all(scores[ids < 0] <= li.NEG_INF / 2)
    s2, i2 = (t.numpy() for t in r.search(state, q, k=40))
    assert i2.shape == (4, 40)
    assert np.all(np.sum(i2 >= 0, axis=1) == 12)
    assert np.all(s2[i2 < 0] <= li.NEG_INF / 2)

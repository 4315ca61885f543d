"""The cascade funnel and its member backends: the port against the JAX
package.

The JAX `Retriever` builds `float_flat`, `hamming` and `cascade` states on
one corpus; ``state_from_numpy`` carries each across, and the port must
search exactly that index as the reference does: ids outside near-ties,
float scores within 1e-4 (caveat C1), Hamming scores exactly. The stage
boundaries' -1 sentinels, the degradation ladder and the port's own build
quality (cascade hit@10 >= 0.95 x flat's, the reference's gate) are
checked too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import HIT_RELEVANCE
from repro.data import synthetic as jax_synthetic
from repro.retrieval import CascadeConfig as JCascadeConfig
from repro.retrieval import Corpus as JCorpus
from repro.retrieval import HPCConfig as JConfig
from repro.retrieval import Query as JQuery
from repro.retrieval import Retriever as JRetriever
from repro.retrieval import get_backend as jax_get_backend
from repro_torch import state_from_numpy
from repro_torch.data import synthetic
from repro_torch.retrieval import (CascadeConfig, Corpus, HPCConfig, Query,
                                   Retriever, get_backend)
from tests._torch_parity import assert_topk_match, state_arrays, to_torch

SPEC = dict(n_docs=96, n_queries=12, n_patches=10, n_q_patches=4, dim=24,
            n_topics=6, dup_per_doc=2)          # tests/test_cascade.py:25-31
BUDGETS = dict(p1=32, p2=12)
TOL = 1e-4
BACKENDS = ("float_flat", "hamming", "cascade")


def _cfg(backend, **kw):
    kw.setdefault("k", 32)
    return dict(p=60.0, backend=backend, prune_side="doc", kmeans_iters=6,
                kmeans_restarts=2, **kw)


def _jcfg(backend, budgets=BUDGETS, **kw):
    return JConfig(cascade=JCascadeConfig(**budgets), **_cfg(backend, **kw))


def _tcfg(backend, budgets=BUDGETS, **kw):
    return HPCConfig(cascade=CascadeConfig(**budgets), **_cfg(backend, **kw))


@pytest.fixture(scope="module")
def reference():
    """(numpy corpus, {backend: JAX-built state})."""
    data = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(0), jax_synthetic.CorpusSpec(**SPEC))
    data = data._replace(**{f: np.asarray(getattr(data, f))
                            for f in data._fields})
    corpus = JCorpus(*map(jnp.asarray, (data.doc_patches, data.doc_mask,
                                        data.doc_salience)))
    states = {be: JRetriever(_jcfg(be)).build(jax.random.PRNGKey(1), corpus)
              for be in BACKENDS}
    return data, states


def _queries(data):
    return (JQuery(*map(jnp.asarray, (data.query_patches, data.query_mask,
                                      data.query_salience))),
            Query(*to_torch(data.query_patches, data.query_mask,
                            data.query_salience)))


def _check(got, want, backend):
    got_s, got_i = (t.numpy() for t in got)
    want_s, want_i = map(np.asarray, want)
    if backend == "hamming":                  # integer scores: exact
        assert got_s.dtype == np.int32
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_i, want_i)
    else:
        assert_topk_match(got_s, got_i, want_s, want_i, TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_search_over_jax_state_matches_jax(reference, backend):
    data, states = reference
    jq, tq = _queries(data)
    want = JRetriever(_jcfg(backend)).search(states[backend], jq, k=10)
    state = state_from_numpy(state_arrays(states[backend], backend),
                             device="cpu", backend=backend)
    got = Retriever(_tcfg(backend)).search(state, tq, k=10)
    assert tuple(got[1].shape) == (12, 10) and got[1].dtype == torch.int32
    _check(got, want, backend)


@pytest.mark.parametrize("backend", ["float_flat", "hamming"])
def test_search_candidates_over_jax_state_matches_jax(reference, backend):
    """A (B, P) pool with -1 slots, scored by the member backend alone."""
    data, states = reference
    jq, tq = _queries(data)
    rng = np.random.default_rng(2)
    pool = np.stack([rng.permutation(96)[:20] for _ in range(12)])
    pool[rng.random(pool.shape) < 0.2] = -1
    pool = pool.astype(np.int32)
    want = jax_get_backend(backend).search_candidates(
        states[backend], jq, jnp.asarray(pool), k=24)
    state = state_from_numpy(state_arrays(states[backend], backend),
                             device="cpu", backend=backend)
    got = get_backend(backend).search_candidates(state, tq,
                                                 torch.from_numpy(pool), k=24)
    _check(got, want, backend)
    assert np.all(got[1].numpy()[:, 20:] == -1)


def test_storage_bytes_and_build_stats_match_jax(reference):
    _, states = reference
    for backend in BACKENDS:
        state = state_from_numpy(state_arrays(states[backend], backend),
                                 device="cpu", backend=backend)
        jret = JRetriever(_jcfg(backend))
        ret = Retriever(_tcfg(backend))
        assert ret.storage_bytes(state) == jret.storage_bytes(states[backend])
        assert ret.build_stats(state) == jret.build_stats(states[backend])


@pytest.mark.parametrize("p1,p2,k", [(1024, 64, 10), (32, 12, 10),
                                     (8, 4, 10), (64, 64, 1), (3, 2, 2)])
def test_degrade_rungs_match_jax(reference, p1, p2, k):
    _, states = reference
    jb, tb = jax_get_backend("cascade"), get_backend("cascade")
    jstate = jb.with_budgets(states["cascade"], p1, p2)
    state = tb.with_budgets(state_from_numpy(
        state_arrays(states["cascade"], "cascade"), device="cpu",
        backend="cascade"), p1, p2)
    assert tb.degrade_rungs(state, k=k) == jb.degrade_rungs(jstate, k=k)
    assert tb.degrade_rungs(state, k=k, max_levels=1) == (None,)


def test_search_degraded_and_prefilter_match_jax(reference):
    """Every rung of the ladder on the carried state, and the Hamming
    floor's float32 scores."""
    data, states = reference
    jq, tq = _queries(data)
    jret, ret = JRetriever(_jcfg("cascade")), Retriever(_tcfg("cascade"))
    state = state_from_numpy(state_arrays(states["cascade"], "cascade"),
                             device="cpu", backend="cascade")
    rungs = ret.degrade_rungs(state, k=5)
    assert rungs == jret.degrade_rungs(states["cascade"], k=5)
    for rung in rungs:
        want = jret.search_degraded(states["cascade"], jq, k=5, rung=rung)
        got = ret.search_degraded(state, tq, k=5, rung=rung)
        assert got[0].dtype == torch.float32
        _check(got, want, "cascade")
    got = get_backend("cascade").search_prefilter(state, tq, k=7)
    want = jax_get_backend("cascade").search_prefilter(states["cascade"], jq,
                                                       k=7)
    assert got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_sentinel_padding_at_stage_boundaries(reference):
    """k > p2 > p1 (tests/test_cascade.py:192-211): every stage hands -1
    rows downstream untouched and the tail is sentinel-padded, on the
    carried state as in the reference."""
    data, states = reference
    jq, tq = _queries(data)
    budgets = dict(p1=4, p2=16)
    jstate = jax_get_backend("cascade").with_budgets(states["cascade"], 4, 16)
    state = get_backend("cascade").with_budgets(state_from_numpy(
        state_arrays(states["cascade"], "cascade"), device="cpu",
        backend="cascade"), 4, 16)
    k = 24
    want = JRetriever(_jcfg("cascade", budgets)).search(jstate, jq, k=k)
    scores, ids = Retriever(_tcfg("cascade", budgets)).search(state, tq, k=k)
    _check((scores, ids), want, "cascade")
    scores, ids = scores.numpy(), ids.numpy()
    assert ids.shape == (12, k)
    for qi in range(ids.shape[0]):
        valid = ids[qi] >= 0
        assert valid.sum() == 4
        assert not valid[4:].any()
        assert np.all(scores[qi][~valid] <= -1e30)
        assert len(set(ids[qi][valid])) == valid.sum()


def test_k_exceeds_corpus(reference):
    data, states = reference
    jq, tq = _queries(data)
    n = 96
    state = get_backend("cascade").with_budgets(state_from_numpy(
        state_arrays(states["cascade"], "cascade"), device="cpu",
        backend="cascade"), n, n)
    scores, ids = Retriever(_tcfg("cascade")).search(state, tq, k=n + 8)
    assert ids.shape[1] == n + 8
    assert np.all(ids.numpy()[:, n:] == -1)
    assert np.all(np.isneginf(scores.numpy()[:, n:]))


def _hit_rate(ids, relevance):
    hits = [int((rel[row[row >= 0]] >= HIT_RELEVANCE).any())
            for row, rel in zip(np.asarray(ids), np.asarray(relevance))]
    return float(np.mean(hits))


def test_port_cascade_build_reaches_the_flat_gate():
    """The reference's gate (benchmarks/retrieval_quality.py:60-75):
    cascade hit@10 >= 0.95 x flat's, over the port's own builds. With one
    generator seed both builds train the same codebook, so they differ
    only in the funnel."""
    data = synthetic.make_retrieval_corpus(synthetic.CorpusSpec(**SPEC),
                                           seed=0, device="cpu")
    corpus = Corpus(data.doc_patches, data.doc_mask, data.doc_salience)
    queries = Query(data.query_patches, data.query_mask, data.query_salience)
    rates = {}
    for backend in ("flat", "cascade"):
        r = Retriever(_tcfg(backend, rerank=16 if backend == "flat" else 0))
        hits = []
        for seed in range(3):
            state = r.build(torch.Generator().manual_seed(seed), corpus)
            hits.append(_hit_rate(r.search(state, queries, k=10)[1],
                                  data.relevance.numpy()))
        rates[backend] = np.mean(hits)
    assert rates["cascade"] >= 0.95 * rates["flat"], rates


def test_state_from_numpy_checks_its_arrays(reference):
    _, states = reference
    arrays = state_arrays(states["cascade"], "cascade")
    state = state_from_numpy(arrays, device="cpu", backend="cascade")
    ham, flat, ff = state.backend_state.members
    assert ham.index.codes.dtype == torch.uint16 and ham.bits == 5
    assert flat.codes.dtype == torch.uint8 and ff.embeddings.shape[1] == 6
    assert (state.backend_state.p1, state.backend_state.p2) == (32, 12)
    with pytest.raises(KeyError, match="float_flat/embeddings"):
        state_from_numpy({k: v for k, v in arrays.items()
                          if k != "float_flat/embeddings"}, device="cpu",
                         backend="cascade")
    with pytest.raises(ValueError, match="unknown backend"):
        state_from_numpy(arrays, device="cpu", backend="pq")
    with pytest.raises(KeyError, match="routing_centroids"):
        state_from_numpy(arrays, device="cpu", backend="ivf")


# ---------------------------------------------------------------------------
# Candidate positions past the corpus (ROADMAP fault F1): the reference's
# gather clamps, so a position >= N scores doc N-1 and returns id N-1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def past_corpus_states(reference):
    data, states = reference
    corpus = JCorpus(*map(jnp.asarray, (data.doc_patches, data.doc_mask,
                                        data.doc_salience)))
    out = dict(states)
    out["flat"] = JRetriever(_jcfg("flat")).build(jax.random.PRNGKey(1),
                                                  corpus)
    return data, out


@pytest.mark.parametrize("backend", ["flat", "float_flat", "hamming"])
def test_candidate_positions_past_the_corpus_match_jax(past_corpus_states,
                                                       backend):
    data, states = past_corpus_states
    n = data.doc_patches.shape[0]
    jq, tq = _queries(data)
    pool = np.tile(np.array([0, n - 1, n, n + 100, -1], np.int32),
                   (jq.embeddings.shape[0], 1))
    want = jax_get_backend(backend).search_candidates(
        states[backend], jq, jnp.asarray(pool), k=5)
    state = state_from_numpy(state_arrays(states[backend], backend),
                             device="cpu", backend=backend)
    got = get_backend(backend).search_candidates(state, tq,
                                                 torch.from_numpy(pool), k=5)
    _check(got, want, backend)
    ids = got[1].numpy()
    assert set(ids[ids >= 0].tolist()) == {0, n - 1}
    assert (ids == n - 1).sum(axis=1).min() == 3      # n - 1, n, n + 100
    assert (ids == -1).sum(axis=1).min() == 1

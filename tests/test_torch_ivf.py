"""The `ivf` backend: the port against the JAX package.

torch cannot replay the reference's ``jax.random`` routing fit, so its
built states are carried across (``state_from_numpy``) and the port's
searches over them are held to the reference's: ids equal and scores
within 1e-5, monolithic and segmented. The pieces under the search are
held too: the routing vectors, the bucket scatter (overflow included),
the append segment given the same centroids, the drop rate and the probe
clamp. The port's own builds are held on quality: the drop rate within
``max_drop_rate`` and tie-aware recall@10 against the flat sweep within
1/32 of the reference's mean over the same seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.ann_compare import tie_aware_recall_at_k
from repro.core import index as jax_index
from repro.core import quantization as jax_quant
from repro.data import synthetic as jax_synthetic
from repro.retrieval import Corpus as JCorpus
from repro.retrieval import HPCConfig as JConfig
from repro.retrieval import Query as JQuery
from repro.retrieval import Retriever as JRetriever
from repro_torch import state_from_numpy
from repro_torch.core import index as index_mod
from repro_torch.retrieval import (Corpus, HPCConfig, IVFConfig, Query,
                                   Retriever)
from tests._torch_parity import state_arrays, to_torch

SPEC = dict(n_docs=256, n_queries=32, n_patches=16, n_q_patches=4, dim=32,
            n_topics=8, dup_per_doc=3)              # tests/test_hnsw.py:29
IVF = dict(n_list=16, n_probe=2, iters=8)
BASE = dict(k=64, p=60.0, prune_side="doc", kmeans_iters=10,
            kmeans_restarts=2)
SEEDS = (1, 2, 3, 4)
TOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    """(numpy corpus, JAX retriever, JAX-built ivf state)."""
    data = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(0), jax_synthetic.CorpusSpec(**SPEC))
    data = data._replace(**{f: np.asarray(getattr(data, f))
                            for f in data._fields})
    jret = JRetriever(JConfig(backend="ivf", ivf=jax_index.IVFConfig(**IVF),
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
    return state_from_numpy(state_arrays(jstate, "ivf"), device="cpu",
                            backend="ivf")


def _equal(got, want, tol=TOL):
    got_s, got_i = (t.numpy() for t in got)
    want_s, want_i = map(np.asarray, want)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=tol, rtol=tol)


@pytest.mark.parametrize("n_probe", [1, 2, 5, 16])
def test_search_ivf_on_jax_state_matches_jax(reference, n_probe):
    data, _, jst = reference
    jq, tq = _queries(data)
    jix = jst.backend_state.index
    ix = _port(jst).backend_state.index
    want = jax_index.search_ivf(jix, jq.embeddings, jq.mask,
                                n_probe=n_probe, k=12)
    got = index_mod.search_ivf(ix, tq.embeddings, tq.mask, n_probe=n_probe,
                               k=12)
    _equal(got, want)


def test_facade_search_on_jax_state_matches_jax(reference):
    data, jret, jst = reference
    jq, tq = _queries(data)
    ret = Retriever(HPCConfig(backend="ivf", ivf=IVFConfig(**IVF),
                              rerank=16, **BASE))
    jret = JRetriever(JConfig(backend="ivf", ivf=jax_index.IVFConfig(**IVF),
                              rerank=16, **BASE))
    _equal(ret.search(_port(jst), tq, k=10), jret.search(jst, jq, k=10))


def test_n_probe_past_n_list_is_clamped(reference):
    data, _, jst = reference
    jq, tq = _queries(data)
    ix = _port(jst).backend_state.index
    got = index_mod.search_ivf(ix, tq.embeddings, tq.mask, n_probe=100, k=12)
    full = index_mod.search_ivf(ix, tq.embeddings, tq.mask, n_probe=16, k=12)
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    _equal(got, jax_index.search_ivf(jst.backend_state.index, jq.embeddings,
                                     jq.mask, n_probe=100, k=12))


def test_search_ivf_segmented_on_jax_churned_state_matches_jax(reference):
    data, jret, jst = reference
    jq, tq = _queries(data)
    st = jret.add(jst, _jcorpus(data, 200, 240))
    st = jret.delete(st, np.array([3, 17, 205, 230]))
    st = jret.add(st, _jcorpus(data, 250, 251), doc_ids=np.array([9]))
    seg = st.backend_state.index
    assert len(seg.segments) == 3
    for n_probe in (2, 16):
        want = jax_index.search_ivf_segmented(seg, jq.embeddings, jq.mask,
                                              n_probe=n_probe, k=12)
        got = index_mod.search_ivf_segmented(
            _port(st).backend_state.index, tq.embeddings, tq.mask,
            n_probe=n_probe, k=12)
        _equal(got, want)


def test_routing_vectors_match_jax(reference):
    _, _, jst = reference
    jix = jst.backend_state.index
    md = jix.bucket_codes.shape[-1]
    codes = jnp.asarray(np.asarray(jix.bucket_codes).reshape(-1, md))
    mask = jnp.asarray(np.asarray(jix.bucket_mask).reshape(-1, md))
    want = np.asarray(jax_index.doc_mean_vectors(codes, mask, jix.codebook))
    tc, tm, cb = to_torch(np.asarray(codes), np.asarray(mask),
                          np.asarray(jix.codebook))
    got = index_mod.doc_mean_vectors(tc, tm, cb).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # chunking does not change a document's mean
    old = index_mod.MEAN_CHUNK_DOCS
    try:
        index_mod.MEAN_CHUNK_DOCS = 7
        np.testing.assert_array_equal(
            index_mod.doc_mean_vectors(tc, tm, cb).numpy(), got)
    finally:
        index_mod.MEAN_CHUNK_DOCS = old
    q = np.random.default_rng(0).normal(size=(3, 5, 32)).astype(np.float32)
    qm = np.random.default_rng(1).random((3, 5)) < 0.7
    np.testing.assert_allclose(
        index_mod.mean_pool(*to_torch(q, qm)).numpy(),
        np.asarray(jax_index.mean_pool(jnp.asarray(q), jnp.asarray(qm))),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cap", [40, 8, 3])
def test_bucket_scatter_matches_jax(cap):
    """The same assignment scatters alike; past ``cap`` a bucket drops
    its later documents and keeps the ranks of the earlier ones."""
    rng = np.random.default_rng(cap)
    n, md, n_list = 60, 5, 6
    codes = rng.integers(0, 64, (n, md)).astype(np.uint8)
    mask = rng.random((n, md)) < 0.8
    ids = rng.permutation(1000)[:n].astype(np.int32)
    assign = rng.integers(0, n_list, n)
    assign[:20] = 2                                   # one crowded bucket
    want = jax_index._bucket_scatter(jnp.asarray(codes), jnp.asarray(mask),
                                     jnp.asarray(ids), jnp.asarray(assign),
                                     n_list, cap)
    got = index_mod._bucket_scatter(*to_torch(codes, mask, ids),
                                    torch.from_numpy(assign), n_list, cap)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ix = index_mod.IVFIndex(None, *got, None)
    jix = jax_index.IVFIndex(None, *want, None)
    assert index_mod.ivf_drop_rate(ix, n) == jax_index.ivf_drop_rate(jix, n)
    if cap == 3:
        assert index_mod.ivf_drop_rate(ix, n) > 0


def test_make_ivf_segment_matches_jax(reference):
    """An append delta bucketed through the reference's centroids: the
    same buckets, cap, live bits and ids (the assignments agree: no
    near-ties here)."""
    data, _, jst = reference
    jix = jst.backend_state.index
    rng = np.random.default_rng(5)
    md = jix.bucket_codes.shape[-1]
    codes = rng.integers(0, 64, (37, md)).astype(np.uint8)
    mask = rng.random((37, md)) < 0.9
    ids = np.arange(300, 337, dtype=np.int32)
    jseg, jlive = jax_index.make_ivf_segment(
        jnp.asarray(codes), jnp.asarray(mask), jix.codebook,
        jix.routing_centroids, jnp.asarray(ids))
    ix = _port(jst).backend_state.index
    seg, live = index_mod.make_ivf_segment(
        *to_torch(codes, mask), ix.codebook, ix.routing_centroids,
        torch.from_numpy(ids))
    doc_vec = index_mod.doc_mean_vectors(*to_torch(codes, mask), ix.codebook)
    np.testing.assert_array_equal(
        index_mod.route_assign(doc_vec, ix.routing_centroids).numpy(),
        np.asarray(jax_quant.assign(jnp.asarray(doc_vec.numpy()),
                                    jix.routing_centroids)))
    for f in ("bucket_codes", "bucket_mask", "bucket_valid",
              "bucket_doc_ids"):
        np.testing.assert_array_equal(getattr(seg, f).numpy(),
                                      np.asarray(getattr(jseg, f)), f)
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))


def test_build_stats_and_storage_match_jax(reference):
    data, jret, jst = reference
    ret = Retriever(HPCConfig(backend="ivf", ivf=IVFConfig(**IVF), **BASE))
    state = _port(jst)
    assert ret.build_stats(state) == jret.build_stats(jst)
    assert ret.storage_bytes(state) == jret.storage_bytes(jst)
    seg = jret.add(jst, _jcorpus(data, 200, 210))
    assert ret.build_stats(_port(seg)) == jret.build_stats(seg)
    assert ret.storage_bytes(_port(seg)) == jret.storage_bytes(seg)


def test_ivf_declines_candidate_pools(reference):
    data, _, jst = reference
    _, tq = _queries(data)
    ret = Retriever(HPCConfig(backend="ivf", ivf=IVFConfig(**IVF), **BASE))
    with pytest.raises(NotImplementedError, match="routes its own"):
        ret.backend.search_candidates(_port(jst), tq,
                                      torch.zeros((32, 4), dtype=torch.int32),
                                      k=3)


# ---------------------------------------------------------------------------
# The port's own builds
# ---------------------------------------------------------------------------

def _oracle_and_ivf(build, search, seed):
    """Tie-aware recall@10 of ivf against the flat sweep over the same
    codebook (one build seed for both)."""
    flat_st = build("flat", seed)
    ivf_st = build("ivf", seed)
    oracle = np.asarray(search("flat", flat_st, 10)[0])
    s, i = search("ivf", ivf_st, 10)
    return tie_aware_recall_at_k(np.asarray(s), np.asarray(i), oracle, 10), \
        ivf_st


def test_port_build_quality_matches_jax_on_the_jax_corpus(reference):
    data, _, _ = reference
    jq, tq = _queries(data)
    corpus = Corpus(*to_torch(data.doc_patches, data.doc_mask,
                              data.doc_salience))
    rets = {b: Retriever(HPCConfig(backend=b, ivf=IVFConfig(**IVF), **BASE))
            for b in ("flat", "ivf")}
    jrets = {b: JRetriever(JConfig(backend=b, ivf=jax_index.IVFConfig(**IVF),
                                   **BASE)) for b in ("flat", "ivf")}
    ours, ref = [], []
    for seed in SEEDS:
        rec, st = _oracle_and_ivf(
            lambda b, s: rets[b].build(torch.Generator().manual_seed(s),
                                       corpus),
            lambda b, st, k: rets[b].search(st, tq, k=k), seed)
        stats = rets["ivf"].build_stats(st)
        assert stats["ivf_drop_rate"] <= IVFConfig().max_drop_rate, stats
        assert stats["bucket_cap"] == 32
        ours.append(rec)
        ref.append(_oracle_and_ivf(
            lambda b, s: jrets[b].build(jax.random.PRNGKey(s),
                                        _jcorpus(data)),
            lambda b, st, k: jrets[b].search(st, jq, k=k), seed)[0])
    assert np.mean(ours) >= np.mean(ref) - 1 / 32, (ours, ref)


def test_build_fails_above_max_drop_rate(reference):
    data, _, _ = reference
    corpus = Corpus(*to_torch(data.doc_patches[:64], data.doc_mask[:64],
                              data.doc_salience[:64]))
    bad = HPCConfig(backend="ivf", ivf=IVFConfig(n_list=4, n_probe=2,
                                                 iters=5, bucket_cap=4),
                    **BASE)
    with pytest.raises(ValueError, match="bucket overflow dropped"):
        Retriever(bad).build(torch.Generator().manual_seed(0), corpus)


def test_full_probe_scores_equal_flat(reference):
    """Probing every bucket scores every stored doc: the scores are the
    flat sweep's (ids equal up to ties, which ivf orders by bucket)."""
    data, _, _ = reference
    _, tq = _queries(data)
    corpus = Corpus(*to_torch(data.doc_patches, data.doc_mask,
                              data.doc_salience))
    cfg = dict(ivf=IVFConfig(n_list=8, n_probe=8, iters=8, bucket_cap=256),
               **BASE)
    s_f, _ = Retriever(HPCConfig(backend="flat", **cfg)).search(
        Retriever(HPCConfig(backend="flat", **cfg)).build(
            torch.Generator().manual_seed(3), corpus), tq, k=10)
    r = Retriever(HPCConfig(backend="ivf", **cfg))
    s_i, _ = r.search(r.build(torch.Generator().manual_seed(3), corpus), tq,
                      k=10)
    np.testing.assert_array_equal(s_i.numpy(), s_f.numpy())


def test_k512_uint16_codes_add_and_search(reference):
    """A K=512 codebook stores uint16 codes: the buckets, an add's rerank
    rows (written through an int16 view) and the search all take them."""
    from repro_torch.core import quantization as quant
    data, _, _ = reference
    corpus = Corpus(*to_torch(data.doc_patches, data.doc_mask,
                              data.doc_salience))
    _, tq = _queries(data)
    r = Retriever(HPCConfig(backend="ivf", ivf=IVFConfig(**IVF,
                                                          bucket_cap=64),
                            **{**BASE, "k": 512, "kmeans_iters": 4,
                               "kmeans_restarts": 1}))
    st = r.build(torch.Generator().manual_seed(0),
                 Corpus(*(a[:200] for a in corpus)))
    assert st.backend_state.index.bucket_codes.dtype == torch.uint16
    st = r.add(st, Corpus(*(a[200:] for a in corpus)))
    want = quant.quantize(corpus.embeddings[200:], st.codebook,
                          code_dtype=torch.uint16)
    assert torch.equal(st.rerank_codes[200:256], want)
    s, i = r.search(st, tq, k=10)
    assert tuple(i.shape) == (32, 10) and bool((i >= 0).all())

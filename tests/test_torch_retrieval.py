"""The flat path as a whole: the port against the JAX package.

On the corpus of tests/test_index_pipeline.py:11-17, the JAX `Retriever`
builds the index and ``state_from_numpy`` carries it across; the port must
then search exactly that index like the reference does. The port's own
build is held to the reference's build quality on the reference corpus,
and to its floor (hit@10 >= 0.70, tests/test_index_pipeline.py:48) on the
port's own corpus at that spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import HIT_RELEVANCE
from repro.core import index as jax_index
from repro.data import synthetic as jax_synthetic
from repro.retrieval import Corpus as JCorpus
from repro.retrieval import HPCConfig as JConfig
from repro.retrieval import Query as JQuery
from repro.retrieval import Retriever as JRetriever
from repro.retrieval import RetrieverState as JState
from repro_torch import state_from_numpy
from repro_torch.data import synthetic
from repro_torch.retrieval import Corpus, HPCConfig, Query, Retriever, base
from tests._torch_parity import assert_topk_match, code_gaps, to_torch

SPEC = dict(n_docs=256, n_queries=32, n_patches=16, n_q_patches=4, dim=32,
            n_topics=8, dup_per_doc=3)
CFG = dict(k=64, p=60.0, prune_side="doc", rerank=16, kmeans_iters=10,
           kmeans_restarts=2)
TOL = 1e-4


@pytest.fixture(scope="module")
def reference():
    """(numpy corpus, JAX retriever, JAX-built state)."""
    data = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(0), jax_synthetic.CorpusSpec(**SPEC))
    data = data._replace(**{f: np.asarray(getattr(data, f))
                            for f in data._fields})
    retriever = JRetriever(JConfig(**CFG))
    state = retriever.build(jax.random.PRNGKey(1), JCorpus(
        *map(jnp.asarray, (data.doc_patches, data.doc_mask,
                           data.doc_salience))))
    return data, retriever, state


def _flat_arrays(state):
    bs = state.backend_state
    return {"codebook": np.asarray(state.codebook),
            "codes": np.asarray(bs.codes), "mask": np.asarray(bs.mask),
            "doc_ids": np.asarray(bs.doc_ids),
            "rerank_codes": np.asarray(state.rerank_codes),
            "rerank_mask": np.asarray(state.rerank_mask)}


def _hit_rate(ids, relevance):
    hits = 0
    for row, rel in zip(np.asarray(ids), np.asarray(relevance)):
        row = row[row >= 0]
        hits += int((rel[row] >= HIT_RELEVANCE).any())
    return hits / len(ids)


def test_search_over_jax_state_matches_jax(reference):
    data, jret, jstate = reference
    want = jret.search(jstate, JQuery(*map(jnp.asarray, (
        data.query_patches, data.query_mask, data.query_salience))), k=10)
    state = state_from_numpy(_flat_arrays(jstate), device="cpu")
    got = Retriever(HPCConfig(**CFG)).search(state, Query(*to_torch(
        data.query_patches, data.query_mask, data.query_salience)), k=10)
    assert got[1].dtype == torch.int32 and tuple(got[1].shape) == (32, 10)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *map(np.asarray, want),
                      TOL)


@pytest.mark.parametrize("prune_side", ["query", "both", "none"])
def test_query_pruning_matches_jax(reference, prune_side):
    """Query-side pruning (and no pruning) over the same carried state."""
    data, _, jstate = reference
    cfg = dict(CFG, prune_side=prune_side)
    jq = JQuery(*map(jnp.asarray, (data.query_patches, data.query_mask,
                                   data.query_salience)))
    want = JRetriever(JConfig(**cfg)).search(jstate, jq, k=10)
    state = state_from_numpy(_flat_arrays(jstate), device="cpu")
    got = Retriever(HPCConfig(**cfg)).search(state, Query(*to_torch(
        data.query_patches, data.query_mask, data.query_salience)), k=10)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *map(np.asarray, want),
                      TOL)


def test_encode_corpus_with_jax_codebook(reference, monkeypatch):
    """With the reference codebook injected, the port's encode stage gives
    the reference's mask exactly and its codes outside near-ties (the
    port quantizes with the kernel's c2 - 2 x.c, the reference's mesh-less
    build with the clamped full distance)."""
    data, _, jstate = reference
    codebook = torch.from_numpy(np.array(jstate.codebook))
    monkeypatch.setattr(base, "fit_codebook",
                        lambda gen, corpus, cfg, mesh=None: codebook)
    corpus = Corpus(*to_torch(data.doc_patches, data.doc_mask,
                              data.doc_salience))
    _, cb, codes_full, codes, mask = base.encode_corpus(
        torch.Generator(), corpus, HPCConfig(**CFG))
    ref = _flat_arrays(jstate)
    np.testing.assert_array_equal(mask.numpy(), ref["mask"])
    assert codes_full.dtype == torch.uint8
    gaps = code_gaps(data.doc_patches, ref["codebook"], codes_full.numpy(),
                     ref["rerank_codes"])
    assert np.all(gaps <= 1e-4)
    assert gaps.size <= 0.001 * codes_full.numel()
    # pruning keeps the same patches, so pruned codes differ only where
    # the full codes do
    kept = np.take_along_axis(
        (codes_full.numpy() != ref["rerank_codes"]),
        np.asarray(jax.lax.top_k(jnp.where(data.doc_mask, data.doc_salience,
                                           -1e30), 10)[1]), axis=1)
    np.testing.assert_array_equal(codes.numpy() != ref["codes"], kept)


def test_storage_bytes_equal(reference):
    _, jret, jstate = reference
    state = state_from_numpy(_flat_arrays(jstate), device="cpu")
    assert Retriever(HPCConfig(**CFG)).storage_bytes(state) == \
        jret.storage_bytes(jstate)


def test_storage_bytes_uint16_codes():
    """K > 256: codes are stored as uint16 and count 2 B each, as in the
    reference."""
    rng = np.random.default_rng(0)
    arrays = {"codebook": rng.standard_normal((512, 8)).astype(np.float32),
              "codes": rng.integers(0, 512, (10, 6)).astype(np.uint16),
              "mask": np.ones((10, 6), bool),
              "doc_ids": np.arange(10, dtype=np.int32),
              "rerank_codes": rng.integers(0, 512, (10, 9)).astype(np.uint16),
              "rerank_mask": np.ones((10, 9), bool)}
    state = state_from_numpy(arrays, device="cpu")
    assert state.backend_state.codes.dtype == torch.uint16
    jstate = JState(jnp.asarray(arrays["codebook"]), jax_index.build_flat(
        *map(jnp.asarray, (arrays["codes"], arrays["mask"],
                           arrays["codebook"]))),
        jnp.asarray(arrays["rerank_codes"]), jnp.asarray(arrays["rerank_mask"]))
    cfg = dict(k=512, rerank=4)
    assert Retriever(HPCConfig(**cfg)).storage_bytes(state) == \
        JRetriever(JConfig(**cfg)).storage_bytes(jstate)
    q = rng.standard_normal((2, 3, 8)).astype(np.float32)
    qm, qs = np.ones((2, 3), bool), np.ones((2, 3), np.float32)
    want = JRetriever(JConfig(**cfg)).search(jstate, JQuery(
        *map(jnp.asarray, (q, qm, qs))), k=5)
    got = Retriever(HPCConfig(**cfg)).search(state, Query(*to_torch(
        q, qm, qs)), k=5)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *map(np.asarray, want),
                      TOL)


SEEDS = range(8)


def _port_hit(corpus, queries, relevance, seed):
    r = Retriever(HPCConfig(**CFG))
    state = r.build(torch.Generator().manual_seed(seed), corpus)
    _, ids = r.search(state, queries, k=10)
    return _hit_rate(ids.numpy(), relevance)


def test_port_build_quality_matches_jax_on_the_jax_corpus(reference):
    """On this 32-query corpus one build's hit@10 moves by up to +-0.15
    with the k-means seed in both packages (the reference itself scores
    0.53-0.81 over build keys at this config, mean 0.69), so the port is
    held to the reference's mean over the same number of builds, within
    one query (1/32)."""
    data, _, _ = reference
    corpus = Corpus(*to_torch(data.doc_patches, data.doc_mask,
                              data.doc_salience))
    queries = Query(*to_torch(data.query_patches, data.query_mask,
                              data.query_salience))
    ours = [_port_hit(corpus, queries, data.relevance, s) for s in SEEDS]
    jret = JRetriever(JConfig(**CFG))
    jcorpus = JCorpus(*map(jnp.asarray, (data.doc_patches, data.doc_mask,
                                         data.doc_salience)))
    jq = JQuery(*map(jnp.asarray, (data.query_patches, data.query_mask,
                                   data.query_salience)))
    ref = [_hit_rate(np.asarray(jret.search(
        jret.build(jax.random.PRNGKey(s), jcorpus), jq, k=10)[1]),
        data.relevance) for s in SEEDS]
    assert np.mean(ours) >= np.mean(ref) - 1 / 32, (ours, ref)


def test_port_build_on_its_own_corpus_reaches_the_floor():
    """The floor of tests/test_index_pipeline.py:48, hit@10 >= 0.70, on
    the port's own corpus at that spec, as a mean over build seeds."""
    data = synthetic.make_retrieval_corpus(synthetic.CorpusSpec(**SPEC),
                                           seed=0, device="cpu")
    assert tuple(data.doc_patches.shape) == (256, 16, 32)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(data.doc_patches, dim=-1).numpy(), 1.0,
        rtol=1e-5)
    corpus = Corpus(data.doc_patches, data.doc_mask, data.doc_salience)
    queries = Query(data.query_patches, data.query_mask, data.query_salience)
    hits = [_port_hit(corpus, queries, data.relevance.numpy(), s)
            for s in SEEDS]
    assert np.mean(hits) >= 0.70, hits

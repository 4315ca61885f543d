"""The port's RAG path and the retrieval leftovers against the JAX package.

``rag_pipeline`` runs on a JAX-made fact corpus, over JAX-built index
states carried across by ``state_from_numpy`` and a JAX-drawn generator
carried across by ``convert``, and must give the reference's ids, tokens
and metrics. The port's own ``make_fact_corpus`` keeps the reference's
layout; the v0 ``core/pipeline`` shim equals the ``Retriever``; the
deprecated ``mode``/``index`` pair resolves as the reference's; PQ, the
pruning helpers and ``kernels.ref`` agree with theirs.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jax_pruning
from repro.core import quantization as jax_quant
from repro.core import rag as jax_rag
from repro.data import synthetic as jax_synthetic
from repro.kernels import ref as jax_ref
from repro.models import transformer as jax_transformer
from repro.retrieval import Corpus as JCorpus
from repro.retrieval import HPCConfig as JConfig
from repro.retrieval import Query as JQuery
from repro.retrieval import Retriever as JRetriever
from repro.retrieval import config as jax_config
from repro_torch import state_from_numpy
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import pipeline, pruning, quantization, rag
from repro_torch.data import synthetic
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.retrieval import Corpus, HPCConfig, Query, Retriever
from repro_torch.retrieval import config as port_config
from tests._torch_parity import code_gaps, state_arrays, to_torch

FACTS = dict(n_docs=48, n_facts_vocab=40, facts_per_doc=3, dim=16,
             n_patches=6, n_queries=12, seq_len=8)
# the reference's corpus, jitted (eager dispatch costs seconds on the CPU);
# its vocab's ints come back as arrays
_jax_make_fact_corpus = jax.jit(jax_synthetic.make_fact_corpus,
                                static_argnames=tuple(FACTS))


def jax_fact_corpus(seed, **kw):
    corpus, vocab = _jax_make_fact_corpus(jax.random.PRNGKey(seed), **kw)
    return corpus, {k: int(v) for k, v in vocab.items()}


RETRIEVERS = {
    "float_flat": dict(backend="float_flat", prune_side="none"),
    "flat": dict(k=32, p=60.0, backend="flat", prune_side="doc", rerank=8,
                 kmeans_iters=8, kmeans_restarts=2),
    "hamming": dict(k=64, p=60.0, backend="hamming", prune_side="doc",
                    kmeans_iters=8, kmeans_restarts=2),
}


# ---------------------------------------------------------------------------
# the pipeline as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fact_setup():
    """(JAX corpus, vocab, torch corpus, JAX LM cfg, host params, port LM)."""
    corpus, vocab = jax_fact_corpus(0, **FACTS)
    port_corpus = synthetic.FactCorpus(*to_torch(*corpus))
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=vocab["size"], q_chunk=8, qkv_bias=True)
    jcfg = jax_transformer.LMConfig(**kw)
    params = jax.tree.map(np.asarray, jax.jit(
        jax_transformer.init, static_argnames=("cfg",))(
            jax.random.PRNGKey(1), cfg=jcfg))
    rng = np.random.default_rng(2)
    for key in ("bq", "bk", "bv"):
        arr = params["blocks"]["attn"][key]
        params["blocks"]["attn"][key] = (
            0.5 * rng.standard_normal(arr.shape)).astype(np.float32)
    model = lm_params_from_numpy(params, transformer.LMConfig(**kw),
                                 device="cpu")
    return corpus, vocab, port_corpus, jcfg, params, model


@pytest.mark.parametrize("name", list(RETRIEVERS))
def test_rag_pipeline_matches_jax(fact_setup, name):
    corpus, vocab, port_corpus, jcfg, params, model = fact_setup
    jr = JRetriever(JConfig(**RETRIEVERS[name]))
    jstate = jr.build(jax.random.PRNGKey(3), JCorpus(
        corpus.doc_patches, corpus.doc_mask, corpus.doc_salience))
    state = state_from_numpy(state_arrays(jstate, name), device="cpu",
                             backend=name)
    jcfg_rag = jax_rag.RAGConfig(retriever=JConfig(**RETRIEVERS[name]),
                                 facts_per_doc=3, fact0=vocab["fact0"],
                                 max_answer=3)
    cfg_rag = rag.RAGConfig(retriever=HPCConfig(**RETRIEVERS[name]),
                            facts_per_doc=3, fact0=vocab["fact0"],
                            max_answer=3)
    n_facts = FACTS["n_facts_vocab"]

    want = jax_rag.rag_pipeline(jstate, params, corpus, jcfg_rag, jcfg,
                                n_facts_vocab=n_facts)
    got = rag.rag_pipeline(state, model, port_corpus, cfg_rag, n_facts,
                           device="cpu")
    for key in ("rouge_l", "hallucination", "answer_acc"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert set(got) == set(want)

    # the ids and prompts behind those metrics; the tokens on the paper's
    # main configuration (the reference's greedy decode is seconds of
    # eager dispatch here)
    _, jids = jr.search(jstate, JQuery(corpus.query_patches,
                                       corpus.query_mask,
                                       corpus.query_salience), k=2)
    jids = np.maximum(np.asarray(jids), 0)
    jprompt = jax_rag.build_prompt(corpus.doc_tokens[jids],
                                   corpus.query_tokens, jcfg_rag, 12)
    run = rag.retrieve_and_generate(state, model, port_corpus, cfg_rag,
                                    device="cpu")
    np.testing.assert_array_equal(run.ids.numpy(), jids)
    np.testing.assert_array_equal(run.prompt.numpy(), np.asarray(jprompt))
    assert run.tokens.dtype == np.int32 and run.tokens.shape == (12, 3)
    assert run.retrieve_s > 0 and run.generate_s > 0
    if name == "flat":
        jtok = jax_rag.greedy_generate(params, jprompt, jcfg, 3, 12)
        np.testing.assert_array_equal(run.tokens, np.asarray(jtok))


def test_rag_pipeline_on_a_query_slice(fact_setup):
    corpus, vocab, port_corpus, jcfg, params, model = fact_setup
    r = Retriever(HPCConfig(**RETRIEVERS["float_flat"]))
    state = r.build(torch.Generator().manual_seed(0), Corpus(
        port_corpus.doc_patches, port_corpus.doc_mask,
        port_corpus.doc_salience))
    cfg_rag = rag.RAGConfig(retriever=r.cfg, facts_per_doc=3, max_answer=3)
    part = slice(2, 7)
    run = rag.retrieve_and_generate(state, model, port_corpus, cfg_rag,
                                    part, device="cpu")
    whole = rag.retrieve_and_generate(state, model, port_corpus, cfg_rag,
                                      device="cpu")
    assert run.tokens.shape == (5, 3)
    np.testing.assert_array_equal(run.ids.numpy(), whole.ids[part].numpy())
    m = rag.rag_metrics(run, port_corpus, cfg_rag, FACTS["n_facts_vocab"],
                        part)
    assert 0.0 <= m["rouge_l"] <= 1.0 and m["latency_ms"] > 0


# ---------------------------------------------------------------------------
# prompt and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,ld,lq,pad", [(3, 2, 8, 4, 0), (2, 3, 6, 4, 5),
                                           (1, 1, 5, 2, 1)])
def test_build_prompt_matches_jax(b, k, ld, lq, pad):
    rng = np.random.default_rng(b * 10 + k)
    docs = rng.integers(0, 50, (b, k, ld), dtype=np.int32)
    q = rng.integers(0, 50, (b, lq), dtype=np.int32)
    plen = k * 4 + lq + pad
    want = jax_rag.build_prompt(jnp.asarray(docs), jnp.asarray(q),
                                jax_rag.RAGConfig(facts_per_doc=3), plen)
    got = rag.build_prompt(*to_torch(docs, q), rag.RAGConfig(facts_per_doc=3),
                           plen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        rag.build_prompt(*to_torch(docs, q), rag.RAGConfig(facts_per_doc=3),
                         plen - pad - 1)


@pytest.mark.parametrize("seed", range(4))
def test_fact_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 20, (6, 5))
    assert rag.extract_facts(toks, 3, 12) == jax_rag.extract_facts(toks, 3,
                                                                   12)
    gen = rag.extract_facts(toks, 3, 12)
    ctx = [set(rng.integers(0, 12, 4).tolist()) for _ in range(6)]
    assert rag.hallucination_rate(gen, ctx) == \
        jax_rag.hallucination_rate(gen, ctx)
    for g, r in zip(gen, ctx):
        assert rag.rouge_l(sorted(g), sorted(r)) == \
            jax_rag.rouge_l(sorted(g), sorted(r))
    a = rng.integers(0, 4, 7).tolist()
    b = rng.integers(0, 4, 5).tolist()
    assert rag.rouge_l(a, b) == jax_rag.rouge_l(a, b)
    assert rag.rouge_l([], b) == 0.0 == rag.hallucination_rate([], [])


# ---------------------------------------------------------------------------
# the fact corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [FACTS, dict(n_docs=20, n_facts_vocab=30,
                                            facts_per_doc=4, dim=8,
                                            n_patches=16, n_queries=5,
                                            seq_len=12)])
def test_make_fact_corpus_keeps_the_reference_layout(kw):
    want, want_vocab = jax_fact_corpus(4, **kw)
    got, vocab = synthetic.make_fact_corpus(seed=4, device="cpu", **kw)
    assert vocab == want_vocab
    assert got._fields == want._fields
    for field in got._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape, field
        assert g.numpy().dtype == w.dtype, field
    f, fact0 = kw["facts_per_doc"], vocab["fact0"]
    facts, toks = got.doc_facts.numpy(), got.doc_tokens.numpy()
    assert ((facts >= 0) & (facts < kw["n_facts_vocab"])).all()
    np.testing.assert_array_equal(toks[:, :f], facts + fact0)
    assert (toks[:, f] == vocab["sep"]).all() and not toks[:, f + 1:].any()
    gold = got.gold_doc.numpy()
    np.testing.assert_array_equal(got.gold_facts.numpy(), facts[gold])
    q = got.query_tokens.numpy()
    assert (q[:, 0] == vocab["query"]).all() and (q[:, 2] == vocab["sep"]).all()
    assert all(q[i, 1] - fact0 in facts[gold[i]] for i in range(len(q)))
    for t in (got.doc_patches, got.query_patches):
        np.testing.assert_allclose(torch.linalg.vector_norm(t, dim=-1), 1.0,
                                   rtol=1e-5)
    # each query patch sits nearest its probe fact's patches
    sims = torch.einsum("qd,nmd->qnm", got.query_patches[:, 0],
                        got.doc_patches).amax(-1)
    assert (sims[torch.arange(len(gold)), got.gold_doc.long()]
            >= sims.amax(-1) - 0.2).all()


# ---------------------------------------------------------------------------
# the v0 shim and the deprecated mode/index pair
# ---------------------------------------------------------------------------

def test_pipeline_shim_equals_the_retriever():
    data = synthetic.make_retrieval_corpus(
        synthetic.CorpusSpec(n_docs=64, n_queries=6, n_patches=8,
                             n_q_patches=4, dim=16, n_topics=4),
        seed=5, device="cpu")
    cfg = HPCConfig(k=16, rerank=8, kmeans_iters=5, kmeans_restarts=1)
    idx = pipeline.build_index(torch.Generator().manual_seed(6),
                               data.doc_patches, data.doc_mask,
                               data.doc_salience, cfg)
    state = Retriever(cfg).build(torch.Generator().manual_seed(6), Corpus(
        data.doc_patches, data.doc_mask, data.doc_salience))
    assert isinstance(idx, pipeline.HPCIndex)
    torch.testing.assert_close(idx.codebook, state.codebook, rtol=0, atol=0)
    got = pipeline.query(idx, data.query_patches, data.query_mask,
                         data.query_salience, cfg, k=5)
    want = Retriever(cfg).search(state, Query(
        data.query_patches, data.query_mask, data.query_salience), k=5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert pipeline.storage_bytes(idx, cfg) == \
        Retriever(cfg).storage_bytes(state)


@pytest.mark.parametrize("mode,index", sorted(
    jax_config._MODE_INDEX_TO_BACKEND))
def test_mode_index_resolves_to_the_reference_backend(monkeypatch, mode,
                                                      index):
    monkeypatch.setattr(jax_config, "_mode_index_warned", True)
    monkeypatch.setattr(port_config, "_mode_index_warned", True)
    want = JConfig(mode=mode, index=index)
    got = HPCConfig(mode=mode, index=index)
    assert got.backend == want.backend
    assert (got.mode, got.index) == (want.mode, want.index)


@pytest.mark.parametrize("backend", sorted(
    jax_config._BACKEND_TO_MODE_INDEX))
def test_backend_derives_the_reference_mode_index(backend):
    got, want = HPCConfig(backend=backend), JConfig(backend=backend)
    assert (got.mode, got.index) == (want.mode, want.index)


def test_mode_index_warns_once_per_process(monkeypatch):
    monkeypatch.setattr(port_config, "_mode_index_warned", False)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        HPCConfig(mode="binary")
        HPCConfig(index="ivf")
        HPCConfig(backend="flat")
    assert [w.category for w in seen] == [DeprecationWarning]
    assert "backend='hamming'" in str(seen[0].message)
    assert seen[0].filename == __file__
    assert HPCConfig().backend == "flat"
    assert HPCConfig(backend="mine").mode == "quantized"


@pytest.mark.parametrize("args,backend", [
    (["--mode", "binary"], "hamming"),
    (["--mode", "quantized", "--index", "flat"], "flat")])
def test_cli_accepts_mode_and_index(monkeypatch, args, backend):
    monkeypatch.setattr(port_config, "_mode_index_warned", True)
    run = serve.main(["--device", "cpu", "--n-docs", "16", "--queries", "4",
                      "--k", "16", "--top-k", "4", "--max-batch", "4",
                      *args])
    assert run.retriever.cfg.backend == backend
    assert len(run.results) == 4


# ---------------------------------------------------------------------------
# PQ, pruning helpers, the plain versions under the reference's names
# ---------------------------------------------------------------------------

def _pq_data(seed, n=384, d=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d))
    x = centers[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal((n, d))
    return x.astype(np.float32)


PQ_CFG = dict(k=16, n_sub=4, iters=6, seed_batch=0, n_restarts=2)


def test_pq_quantize_and_decode_match_jax_on_its_codebooks():
    x = _pq_data(0)
    cb = np.asarray(jax_quant.pq_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                                     jax_quant.PQConfig(**PQ_CFG)))
    want = np.asarray(jax_quant.pq_quantize(jnp.asarray(x), jnp.asarray(cb)))
    got = quantization.pq_quantize(*to_torch(x, cb)).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == (384, 4)
    for s in range(4):
        sl = slice(4 * s, 4 * s + 4)
        assert (code_gaps(x[:, sl], cb[s], got[:, s], want[:, s])
                <= 1e-4).all()
    np.testing.assert_array_equal(
        quantization.pq_decode(*to_torch(want, cb)).numpy(),
        np.asarray(jax_quant.pq_decode(jnp.asarray(want), jnp.asarray(cb))))
    codes3 = want.reshape(2, 192, 4)
    assert quantization.pq_decode(*to_torch(codes3, cb)).shape == (2, 192, 16)


def _pq_inertia(x, codes_of, decode):
    return float(np.mean(np.sum((x - decode(codes_of(x))) ** 2, -1)))


def test_pq_fit_quality_matches_jax():
    """Mean PQ reconstruction error over 4 seeds within 5% of the
    reference's: torch cannot replay jax.random, so the fits agree in
    quality, as the codebook fits do."""
    x = _pq_data(1)
    fit = jax.jit(jax_quant.pq_fit, static_argnames=("config",))
    jcfg, pcfg = jax_quant.PQConfig(**PQ_CFG), quantization.PQConfig(**PQ_CFG)
    want, got = [], []
    for seed in range(4):
        cb = fit(jax.random.PRNGKey(seed), jnp.asarray(x), config=jcfg)
        want.append(_pq_inertia(x, functools.partial(
            jax_quant.pq_quantize, codebooks=cb), lambda c, cb=cb: np.asarray(
                jax_quant.pq_decode(c, cb))))
        pcb = quantization.pq_fit(torch.Generator().manual_seed(seed),
                                  torch.from_numpy(x), pcfg)
        assert pcb.shape == (4, 16, 4)
        got.append(_pq_inertia(x, lambda a, cb=pcb: quantization.pq_quantize(
            torch.from_numpy(a), cb), lambda c, cb=pcb: quantization.pq_decode(
                c, cb).numpy()))
    assert abs(np.mean(got) - np.mean(want)) <= 0.05 * np.mean(want)
    with pytest.raises(ValueError):
        quantization.pq_fit(torch.Generator(), torch.zeros(8, 6), pcfg)


@pytest.mark.parametrize("m,p", [(1024, 60.0), (1024, 40.0), (50, 100.0),
                                 (7, 1.0), (32, 33.3)])
def test_compute_saved_fraction_matches_jax(m, p):
    assert pruning.compute_saved_fraction(m, p) == \
        jax_pruning.compute_saved_fraction(m, p)


@pytest.mark.parametrize("with_mask", [False, True])
def test_salience_from_attention_matches_jax(with_mask):
    rng = np.random.default_rng(7)
    attn = rng.random((2, 3, 5, 6)).astype(np.float32)
    mask = rng.random((2, 6)) < 0.7 if with_mask else None
    want = jax_pruning.salience_from_attention(
        jnp.asarray(attn), None if mask is None else jnp.asarray(mask))
    got = pruning.salience_from_attention(
        torch.from_numpy(attn), None if mask is None else torch.from_numpy(
            mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["maxsim", "quantized_maxsim",
                                  "hamming_maxsim", "kmeans_assign"])
def test_kernels_ref_names_resolve_to_the_reference_functions(name):
    rng = np.random.default_rng(8)
    b, mq, n, md, d, k = 2, 3, 5, 4, 8, 16
    q_mask = (rng.random((b, mq)) < 0.8).astype(np.float32)
    d_mask = (rng.random((n, md)) < 0.8).astype(np.float32)
    d_mask[:, 0] = 1.0                # every doc has a valid patch (C4)
    args = {
        "maxsim": (rng.standard_normal((b, mq, d)), q_mask,
                   rng.standard_normal((n, md, d)), d_mask),
        "quantized_maxsim": (rng.standard_normal((b, mq, k)), q_mask,
                             rng.integers(0, k, (n, md)), d_mask),
        "hamming_maxsim": (rng.integers(0, k, (b, mq)), q_mask,
                           rng.integers(0, k, (n, md)), d_mask),
        "kmeans_assign": (rng.standard_normal((20, d)),
                          rng.standard_normal((k, d))),
    }[name]
    args = tuple(a.astype(np.float32) if a.dtype == np.float64 else
                 a.astype(np.int32) if a.dtype == np.int64 else a
                 for a in args)
    extra = (4,) if name == "hamming_maxsim" else ()
    want = np.asarray(getattr(jax_ref, name)(*map(jnp.asarray, args), *extra))
    got = getattr(ref, name)(*to_torch(*args), *extra).numpy()
    np.testing.assert_allclose(got.astype(np.float64), want, rtol=1e-5,
                               atol=1e-5)
    assert ref.NEG_INF == jax_ref.NEG_INF

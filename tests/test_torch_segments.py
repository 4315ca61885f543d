"""The segmented LSM store (add / delete / compact): the port against the
JAX package.

The reference's own churned states (build, add, add, delete, upsert) for
flat, float_flat, hamming, cascade, ivf and hnsw are carried across by
``state_from_numpy``, and the port must search each as the reference does:
float scores within 1e-4 (caveat C1), ids outside near-ties. The port's own mutations on a carried-across monolithic state
must give the reference's segment layout, doc ids, live bits, ``pos_of_id``
and rerank-row growth, with codes equal outside near-ties. The port's
counterparts of tests/test_segments.py's lifecycle tests run on its own
builds, and a segmented search equals a monolithic search over the
concatenated corpus bit for bit on the plain path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import HNSWConfig as JHNSWConfig
from repro.core.index import IVFConfig as JIVFConfig
from repro.data import synthetic as jax_synthetic
from repro.retrieval import CascadeConfig as JCascadeConfig
from repro.retrieval import Corpus as JCorpus
from repro.retrieval import HPCConfig as JConfig
from repro.retrieval import Query as JQuery
from repro.retrieval import Retriever as JRetriever
from repro_torch import state_from_numpy
from repro_torch.core import index as index_mod
from repro_torch.data import synthetic
from repro_torch.retrieval import (CascadeConfig, Corpus, HNSWConfig,
                                   HPCConfig, IVFConfig, Query, Retriever)
from tests._torch_parity import (assert_topk_match, code_gaps, state_arrays,
                                 to_torch)

BACKENDS = ["flat", "float_flat", "hamming", "cascade"]
# the ANN routers: one growable graph segment (hnsw), and buckets that
# compaction re-buckets, so ids may permute within equal-score ties (ivf)
ANN = ["ivf", "hnsw"]
ALL = BACKENDS + ANN
IVF = dict(n_list=4, n_probe=3, bucket_cap=40, iters=5)
HNSW = dict(m=4, ef_construction=16, ef_search=64, levels=3)
SPEC = dict(n_docs=60, n_queries=12, n_patches=8, n_q_patches=4, dim=16,
            n_topics=4, patches_per_topic=8, noise=0.1)
N_BASE, N_D1, N_TOTAL = 40, 52, 60
DEAD = [3, 10, 41, 50, 55]
UPSERT_ID, UPSERT_SRC = 5, 53          # doc 5 := doc 53's content
TOL = 1e-4


def _knobs(backend):
    return dict(k=16, p=80.0, backend=backend, kmeans_iters=6,
                kmeans_restarts=1, rerank=8)


def _jcfg(backend):
    return JConfig(cascade=JCascadeConfig(p1=24, p2=10),
                   ivf=JIVFConfig(**IVF), hnsw=JHNSWConfig(**HNSW),
                   **_knobs(backend))


def _tcfg(backend):
    return HPCConfig(cascade=CascadeConfig(p1=24, p2=10),
                     ivf=IVFConfig(**IVF), hnsw=HNSWConfig(**HNSW),
                     **_knobs(backend))


@pytest.fixture(scope="module")
def data():
    """The reference corpus as numpy arrays."""
    d = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(7), jax_synthetic.CorpusSpec(**SPEC))
    return d._replace(**{f: np.asarray(getattr(d, f)) for f in d._fields})


def _jslice(d, lo, hi):
    return JCorpus(*(jnp.asarray(a[lo:hi]) for a in (
        d.doc_patches, d.doc_mask, d.doc_salience)))


def _tslice(d, lo, hi):
    return Corpus(*to_torch(d.doc_patches[lo:hi], d.doc_mask[lo:hi],
                            d.doc_salience[lo:hi]))


def _queries(d):
    return (JQuery(*map(jnp.asarray, (d.query_patches, d.query_mask,
                                      d.query_salience))),
            Query(*to_torch(d.query_patches, d.query_mask,
                            d.query_salience)))


def _check(got, want, backend):
    """Float scores within TOL and ids outside near-ties; integer
    (Hamming) scores and their ids exactly. The facade reranks the
    ``hamming`` backend's candidates, so its results are float."""
    got_s, got_i = (t.numpy() for t in got)
    want_s, want_i = map(np.asarray, want)
    if got_s.dtype == np.int32:               # Hamming scores: exact
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_i, want_i)
    else:
        assert_topk_match(got_s, got_i, want_s, want_i, TOL)


# the lifecycle both packages run: (op, args) steps after the build
def _steps(d, lib):
    sl = _jslice if lib == "jax" else _tslice
    return [("add", sl(d, N_BASE, N_D1), None),
            ("add", sl(d, N_D1, N_TOTAL), None),
            ("delete", np.array(DEAD), None),
            ("add", sl(d, UPSERT_SRC, UPSERT_SRC + 1),
             np.array([UPSERT_ID]))]


def _apply(r, st, step):
    op, arg, ids = step
    if op == "add":
        return r.add(st, arg, doc_ids=ids)
    return r.delete(st, arg)


@pytest.fixture(scope="module", params=ALL)
def lifecycle(request, data):
    """The reference's build and every state of its lifecycle, plus its
    compacted end state, per backend."""
    backend = request.param
    r = JRetriever(_jcfg(backend))
    st = r.build(jax.random.PRNGKey(0), _jslice(data, 0, N_BASE))
    states = [st]
    for step in _steps(data, "jax"):
        st = _apply(r, st, step)
        states.append(st)
    return backend, r, states, r.compact(st)


def _members(state, backend):
    """(stage name, structure) per member of a state of either package."""
    bs = state.backend_state
    if backend == "cascade":
        return list(zip(("hamming", "flat", "float_flat"), bs.members))
    return [(backend, bs)]


def _seg(member):
    return member.index if hasattr(member, "index") and not isinstance(
        member, tuple) else member


def _ids_mask(payload):
    """A segment payload's (doc ids, patch mask), whatever its layout."""
    if hasattr(payload, "bucket_doc_ids"):
        return payload.bucket_doc_ids, payload.bucket_mask
    return payload.doc_ids, payload.mask


def test_search_over_jax_churned_states_matches_jax(data, lifecycle):
    backend, jret, states, jcompact = lifecycle
    jq, tq = _queries(data)
    ret = Retriever(_tcfg(backend))
    for st in states[1:] + [jcompact]:
        state = state_from_numpy(state_arrays(st, backend), device="cpu",
                                 backend=backend)
        assert ret.backend._segmented(state) is not None
        want = jret.search(st, jq, k=10)
        _check(ret.search(state, tq, k=10), want, backend)
        # the backend alone (no facade rerank): int32 scores for hamming
        want = jret.backend.search(st, jq, k=10)
        _check(ret.backend.search(state, tq, k=10), want, backend)


def test_port_mutations_give_the_reference_layout(data, lifecycle):
    """The port's own add/delete/compact from the carried-across build:
    segment capacities, doc ids, live bits, pos_of_id and the rerank rows
    as the reference's, codes equal outside near-ties, and search equal
    after every step."""
    backend, jret, states, jcompact = lifecycle
    jq, tq = _queries(data)
    ret = Retriever(_tcfg(backend))
    st = state_from_numpy(state_arrays(states[0], backend), device="cpu",
                          backend=backend)
    ported = [st]
    for step in _steps(data, "torch"):
        st = _apply(ret, st, step)
        ported.append(st)
    ported.append(ret.compact(st))
    for jst, tst in zip(states[1:] + [jcompact], ported[1:]):
        assert tuple(tst.rerank_codes.shape) == jst.rerank_codes.shape
        for (stage, jm), (_, tm) in zip(_members(jst, backend),
                                        _members(tst, backend)):
            jseg, tseg = _seg(jm), _seg(tm)
            assert [tuple(lv.shape) for lv in tseg.live] == \
                [lv.shape for lv in jseg.live], stage
            for jp, tp, jl, tl in zip(jseg.segments, tseg.segments,
                                      jseg.live, tseg.live):
                (t_ids, t_mask), (j_ids, j_mask) = _ids_mask(tp), \
                    _ids_mask(jp)
                np.testing.assert_array_equal(t_ids.numpy(),
                                              np.asarray(j_ids))
                np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
                if stage == "float_flat":
                    np.testing.assert_array_equal(
                        tp.embeddings.numpy(), np.asarray(jp.embeddings))
                else:
                    np.testing.assert_array_equal(t_mask.numpy(),
                                                  np.asarray(j_mask))
            np.testing.assert_array_equal(tseg.pos_of_id.numpy(),
                                          np.asarray(jseg.pos_of_id))
        np.testing.assert_array_equal(tst.rerank_mask.numpy(),
                                      np.asarray(jst.rerank_mask))
        if backend != "float_flat":
            # the appended docs' full codes, from the build's codebook
            ids = np.arange(N_BASE, N_TOTAL)
            src = data.doc_patches[N_BASE:N_TOTAL].copy()
            ids = np.append(ids, UPSERT_ID)
            src = np.concatenate([src, data.doc_patches[UPSERT_SRC][None]])
            got = tst.rerank_codes.numpy()[ids]
            want = np.asarray(jst.rerank_codes)[ids]
            gaps = code_gaps(src, np.asarray(jst.codebook), got, want)
            assert np.all(gaps <= 1e-4), gaps
        _check(ret.search(tst, tq, k=10), jret.search(jst, jq, k=10),
               backend)


# ---------------------------------------------------------------------------
# The port's counterparts of tests/test_segments.py, on its own builds
# ---------------------------------------------------------------------------

def _recall_vs(ids, gt, k=10):
    hits, tot = 0, 0
    for a, b in zip(np.asarray(ids)[:, :k], gt):
        hits += len(set(int(x) for x in a if x >= 0) & set(b[:k].tolist()))
        tot += k
    return hits / tot


def _gt_topk(q_emb, q_mask, d_emb, d_mask, ids, k=10):
    out = []
    for b in range(q_emb.shape[0]):
        sims = np.einsum("md,npd->mnp", q_emb[b], d_emb)
        sims = np.where(d_mask[None, :, :], sims, -np.inf)
        score = (sims.max(-1) * q_mask[b][:, None]).sum(0)
        out.append(ids[np.argsort(-score, kind="stable")[:k]])
    return out


@pytest.fixture(scope="module")
def tdata():
    """The port's own corpus at the reference test's spec shape."""
    d = synthetic.make_retrieval_corpus(synthetic.CorpusSpec(**SPEC), seed=7,
                                        device="cpu")
    return d._replace(**{f: getattr(d, f).numpy() for f in d._fields})


@pytest.fixture(scope="module", params=ALL)
def churned(request, tdata):
    """One mutation lifecycle on the port's own build, a rebuild of the
    same live corpus, the exact float MaxSim ground truth over it, and the
    compacted state."""
    backend = request.param
    _, tq = _queries(tdata)
    r = Retriever(_tcfg(backend))
    gen = torch.Generator().manual_seed(0)
    st = r.build(gen, _tslice(tdata, 0, N_BASE))
    for step in _steps(tdata, "torch"):
        st = _apply(r, st, step)
    s_seg, i_seg = r.search(st, tq, k=10)

    emb, msk, sal = (a.copy() for a in (tdata.doc_patches, tdata.doc_mask,
                                        tdata.doc_salience))
    emb[UPSERT_ID], msk[UPSERT_ID], sal[UPSERT_ID] = (
        emb[UPSERT_SRC], msk[UPSERT_SRC], sal[UPSERT_SRC])
    live_ids = np.array([i for i in range(N_TOTAL) if i not in DEAD])
    rb = r.build(torch.Generator().manual_seed(0), Corpus(*to_torch(
        emb[live_ids], msk[live_ids], sal[live_ids])))
    i_rb = r.search(rb, tq, k=10)[1].numpy()
    i_rb = np.where(i_rb >= 0, live_ids[np.maximum(i_rb, 0)], -1)
    gt = _gt_topk(tdata.query_patches, tdata.query_mask, emb[live_ids],
                  msk[live_ids], live_ids)
    st_c = r.compact(st)
    s_c, i_c = r.search(st_c, tq, k=10)
    return {"backend": backend, "retriever": r, "query": tq, "state": st,
            "state_compact": st_c, "live_ids": live_ids,
            "scores": s_seg.numpy(), "ids": i_seg.numpy(),
            "scores_compact": s_c.numpy(), "ids_compact": i_c.numpy(),
            "ids_rebuild": i_rb, "gt": gt}


def test_churn_recall_within_1pct_of_rebuild(churned):
    rec_seg = _recall_vs(churned["ids"], churned["gt"])
    rec_rb = _recall_vs(churned["ids_rebuild"], churned["gt"])
    assert rec_seg >= rec_rb - 0.01, (churned["backend"], rec_seg, rec_rb)


def test_compact_preserves_recall(churned):
    rec_seg = _recall_vs(churned["ids"], churned["gt"])
    rec_c = _recall_vs(churned["ids_compact"], churned["gt"])
    assert rec_c >= rec_seg - 0.01, (churned["backend"], rec_c, rec_seg)


def test_compact_keeps_scores_and_ids(churned):
    """Compaction keeps slot order, so the plain path's results are the
    same bits before and after. The ANN routers reorder their candidates
    in a compaction (ivf re-buckets, hnsw re-inserts into a new graph
    whose beam hands its pool over in another order): their scores stay
    the same bits, and an id may move only within a group of equal
    scores."""
    np.testing.assert_array_equal(churned["scores_compact"],
                                  churned["scores"])
    if churned["backend"] not in ANN:
        np.testing.assert_array_equal(churned["ids_compact"], churned["ids"])
        return
    s0, i0, i1 = churned["scores"], churned["ids"], churned["ids_compact"]
    for b, j in np.argwhere(i0 != i1):
        assert np.sum(s0[b] == s0[b, j]) >= 2, (b, j, s0[b])


def test_deleted_ids_never_surface(churned):
    surfaced = set(churned["ids"].ravel().tolist())
    surfaced |= set(churned["ids_compact"].ravel().tolist())
    assert not (surfaced & set(DEAD)), (churned["backend"],
                                        surfaced & set(DEAD))


def test_k_exceeding_live_docs_pads_sentinels(churned, tdata):
    r = Retriever(_tcfg(churned["backend"]))
    st = r.build(torch.Generator().manual_seed(0), _tslice(tdata, 0, 5))
    st = r.delete(st, np.arange(3))
    _, ids = r.search(st, churned["query"], k=10)
    ids = ids.numpy()
    assert set(ids[ids >= 0].tolist()) <= {3, 4}, (churned["backend"], ids)
    assert (ids >= 0).sum(axis=1).max() <= 2, (churned["backend"], ids)


def test_delete_then_add_newest_wins(churned):
    backend = churned["backend"]
    rng = np.random.default_rng(11)
    dim, n, m = 16, 10, 8

    def unit(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    emb = unit((n, m, dim))
    new = unit((1, m, dim))
    mask = np.ones((n, m), bool)
    sal = np.ones((n, m), np.float32)
    r = Retriever(_tcfg(backend))
    st = r.build(torch.Generator().manual_seed(0),
                 Corpus(*to_torch(emb, mask, sal)))
    st = r.delete(st, np.array([2]))
    st = r.add(st, Corpus(*to_torch(new, mask[:1], sal[:1])),
               doc_ids=np.array([2]))

    def top1(patches):
        q = Query(*to_torch(patches[None], mask[:1], sal[:1]))
        return int(r.search(st, q, k=3)[1][0, 0])

    assert top1(new[0]) == 2, backend
    assert top1(emb[2]) != 2, backend


def test_build_stats_live_and_tombstones(churned):
    r = churned["retriever"]
    stats = r.build_stats(churned["state"])
    n_live = len(churned["live_ids"])
    assert stats["live_docs"] == n_live, (churned["backend"], stats)
    assert stats["tombstoned_docs"] >= len(DEAD), (churned["backend"], stats)
    total = stats["live_docs"] + stats["tombstoned_docs"]
    assert stats["tombstone_frac"] == pytest.approx(
        stats["tombstoned_docs"] / total)
    # hnsw grows its one graph segment in place
    assert stats["segments"] >= (1 if churned["backend"] == "hnsw" else 2)
    stats_c = r.build_stats(churned["state_compact"])
    assert stats_c["live_docs"] == n_live
    assert stats_c["tombstoned_docs"] == 0
    assert stats_c["segments"] == 1


def test_storage_reports_per_segment_live_payload(churned, tdata):
    r = churned["retriever"]
    stor = r.storage_bytes(churned["state"])
    if churned["backend"] == "cascade":
        assert any(k.startswith("stage_") for k in stor), stor
    else:
        seg_keys = [k for k in stor if k.startswith("segment_")]
        assert seg_keys, stor
        assert stor["payload"] == sum(stor[k] for k in seg_keys)
    r2 = Retriever(_tcfg(churned["backend"]))
    st = r2.build(torch.Generator().manual_seed(0), _tslice(tdata, 0, 30))
    st = r2.add(st, _tslice(tdata, 30, 40))
    before = r2.storage_bytes(st)["payload"]
    st = r2.delete(st, np.arange(12))
    after = r2.storage_bytes(st)["payload"]
    assert after < before, (churned["backend"], before, after)


def test_storage_and_build_stats_match_jax(lifecycle):
    """On the reference's own churned state, the accounting is the
    reference's."""
    backend, jret, states, _ = lifecycle
    state = state_from_numpy(state_arrays(states[-1], backend), device="cpu",
                             backend=backend)
    ret = Retriever(_tcfg(backend))
    assert ret.storage_bytes(state) == jret.storage_bytes(states[-1])
    assert ret.build_stats(state) == jret.build_stats(states[-1])


# ---------------------------------------------------------------------------
# Segmented == monolithic over the concatenation, bit for bit (plain path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_segmented_search_equals_monolithic_bit_for_bit(tdata, backend):
    """Three segments (capacities 32, 16, 8, with padding) against one
    monolithic index over the same rows: the carried merge buffer ranks
    earlier segments first on ties, as one sweep does by position."""
    _, tq = _queries(tdata)
    r = Retriever(_tcfg(backend))
    st = r.build(torch.Generator().manual_seed(0), _tslice(tdata, 0, 30))
    st = r.add(st, _tslice(tdata, 30, 45))
    st = r.add(st, _tslice(tdata, 45, 50))
    seg = r.backend._segmented(st)
    assert [lv.shape[0] for lv in seg.live] == [30, 16, 8]
    got = r.search(st, tq, k=12)
    mono = r.compact(st)                       # the live rows, in order
    members = _members(mono, backend)
    flat = []
    for stage, m in members:
        payload = _seg(m).segments[0]
        n = 50
        payload = payload._replace(**{f: getattr(payload, f)[:n]
                                      for f in payload._fields
                                      if f not in ("codebook", "bits")})
        flat.append(type(m)(payload, m.bits) if hasattr(m, "bits")
                    else payload)
    bs = mono.backend_state
    mono = mono._replace(backend_state=(
        type(bs)(tuple(flat), bs.p1, bs.p2) if backend == "cascade"
        else flat[0]))
    assert r.backend._segmented(mono) is None
    want = r.search(mono, tq, k=12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_segment_capacity_matches_jax():
    from repro.core import index as jax_index
    for n in (0, 1, 5, 8, 9, 100, 2048, 2049):
        assert index_mod.segment_capacity(n) == jax_index.segment_capacity(n)
        assert index_mod.next_pow2(n) == jax_index.next_pow2(n)

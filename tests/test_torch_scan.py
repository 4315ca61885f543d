"""The port's streaming ADC scan against ``repro.core.scan`` (impl="jnp").

Mirrors the reference's own streaming suite (tests/test_kernels.py:131-341):
block sweep with ragged tails, planted exact ties resolved lowest index
first, carry= seeding, k > N sentinels, valid=False slots and the
per-query (B, P, Md) layout. Scores agree within atol = rtol = 1e-4 (f32
sums in another order); ids agree exactly here, since the only exact ties
are planted and must resolve as ``lax.top_k`` resolves them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jax_scan
from repro_torch.core import late_interaction as li
from repro_torch.core import scan
from repro_torch.core.index import build_flat, search_flat, search_flat_candidates
from tests._torch_parity import assert_topk_match, to_torch

TOL = 1e-4
N_STREAM = 50  # not a multiple of any swept block size


def _adc_case(seed, n=N_STREAM, b=3, mq=5, d=16, md=7, k_cb=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    cb = rng.standard_normal((k_cb, d)).astype(np.float32)
    codes = rng.integers(0, k_cb, (n, md)).astype(np.uint8)
    qm = rng.random((b, mq)) > 0.2
    dm = rng.random((n, md)) > 0.2
    dm[:, 0] = True                       # no accidental all-masked docs
    # planted exact ties: copies of doc 3 at higher positions
    for dup in (10, 20, 41):
        if dup < n:
            codes[dup], dm[dup] = codes[3], dm[3]
    return q, qm, codes, dm, cb


def _both(case, *, k, block, **kw):
    jkw = {key: (None if v is None else jnp.asarray(v)) for key, v in kw.items()}
    want = jax_scan.quantized_maxsim_topk(
        *map(jnp.asarray, case), k=k,
        scan=jax_scan.ScanConfig(block_docs=block, impl="jnp"), **jkw)
    tkw = {key: (None if v is None else to_torch(v)[0]) for key, v in kw.items()}
    got = scan.quantized_maxsim_topk(
        *to_torch(*case), k=k,
        scan=scan.ScanConfig(block_docs=block, impl="plain"), **tkw)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("block", [1, 3, 7, 16, 50, 256])
def test_blocked_scan_matches_jax(block):
    (got_s, got_i), (want_s, want_i) = _both(_adc_case(0), k=12, block=block)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)
    assert got_i.dtype == np.int32 and got_s.dtype == np.float32


@pytest.mark.parametrize("block", [1, 4, 9, 50])
def test_planted_ties_resolve_lowest_index_first(block):
    """Docs 3, 10, 20, 41 are identical: they tie exactly, and the merge
    must return them in ascending position, as one global lax.top_k."""
    q, qm, codes, dm, cb = _adc_case(1)
    q[:] = cb[codes[3, 0]]                # every query patch favours doc 3
    (got_s, got_i), (want_s, want_i) = _both((q, qm, codes, dm, cb), k=6,
                                             block=block)
    np.testing.assert_array_equal(got_i, want_i)
    for row in got_i:
        dup = [i for i in row if i in (3, 10, 20, 41)]
        assert dup == sorted(dup) and len(dup) >= 2
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)


def test_carry_continues_a_sweep():
    """Sweeping docs [30, 50) seeded with the result over [0, 30) equals
    one sweep over all 50 docs, and JAX's carried sweep."""
    q, qm, codes, dm, cb = _adc_case(2)
    ids = np.arange(N_STREAM, dtype=np.int32)
    first = scan.quantized_maxsim_topk(
        *to_torch(q, qm, codes[:30], dm[:30], cb), k=8,
        scan=scan.ScanConfig(7, "plain"))
    got = scan.quantized_maxsim_topk(
        *to_torch(q, qm, codes[30:], dm[30:], cb), k=8,
        doc_ids=torch.from_numpy(ids[30:]), carry=first,
        scan=scan.ScanConfig(7, "plain"))
    whole = scan.quantized_maxsim_topk(*to_torch(q, qm, codes, dm, cb), k=8,
                                       scan=scan.ScanConfig(7, "plain"))
    np.testing.assert_array_equal(got[1].numpy(), whole[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), whole[0].numpy(), rtol=1e-6)
    jcfg = jax_scan.ScanConfig(7, "jnp")
    jfirst = jax_scan.quantized_maxsim_topk(
        *map(jnp.asarray, (q, qm, codes[:30], dm[:30], cb)), k=8, scan=jcfg)
    want = jax_scan.quantized_maxsim_topk(
        *map(jnp.asarray, (q, qm, codes[30:], dm[30:], cb)), k=8,
        doc_ids=jnp.asarray(ids[30:]), carry=jfirst, scan=jcfg)
    assert_topk_match(got[0].numpy(), got[1].numpy(), want[0], want[1], TOL)


def test_k_exceeds_corpus_pads_sentinels():
    case = _adc_case(3, n=8)
    (got_s, got_i), (want_s, want_i) = _both(case, k=12, block=3)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_i[:, 8:], -1)
    assert np.all(np.isneginf(got_s[:, 8:]))
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)


def test_invalid_slots_score_neg_inf():
    case = _adc_case(4, n=8)
    valid = np.array([True, False] * 4)
    (got_s, got_i), (want_s, want_i) = _both(case, k=8, block=3, valid=valid)
    np.testing.assert_array_equal(got_i, want_i)
    assert set(got_i[0, :4]) == {0, 2, 4, 6}
    np.testing.assert_array_equal(got_i[:, 4:], -1)
    np.testing.assert_array_equal(got_s[:, 4:], np.float32(li.NEG_INF))
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)


def test_all_masked_docs_still_rank_above_sentinels():
    q, qm, codes, dm, cb = _adc_case(5, n=12)
    dm[3] = False
    dm[11] = False
    (got_s, got_i), (want_s, want_i) = _both((q, qm, codes, dm, cb), k=14,
                                             block=5)
    np.testing.assert_array_equal(got_i, want_i)
    assert set(got_i[0, :12]) == set(range(12))
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("block", [2, 4, 11])
def test_per_query_layout_matches_jax(block):
    rng = np.random.default_rng(6)
    b, p, md, k_cb, mq, d = 3, 11, 6, 16, 4, 8
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    cb = rng.standard_normal((k_cb, d)).astype(np.float32)
    codes = rng.integers(0, k_cb, (b, p, md)).astype(np.uint8)
    qm = np.ones((b, mq), bool)
    dm = rng.random((b, p, md)) > 0.2
    dm[..., 0] = True
    ids = rng.permutation(100)[:b * p].reshape(b, p).astype(np.int32)
    valid = rng.random((b, p)) > 0.2
    (got_s, got_i), (want_s, want_i) = _both(
        (q, qm, codes, dm, cb), k=5, block=block, doc_ids=ids, valid=valid)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)


def test_search_flat_and_candidates_match_jax():
    from repro.core import index as jax_index
    q, qm, codes, dm, cb = _adc_case(7)
    rng = np.random.default_rng(7)
    cand = rng.integers(-1, N_STREAM, (3, 9)).astype(np.int32)
    jix = jax_index.build_flat(*map(jnp.asarray, (codes, dm, cb)))
    tix = build_flat(*to_torch(codes, dm, cb))
    cfg_j, cfg_t = jax_scan.ScanConfig(16, "jnp"), scan.ScanConfig(16, "plain")
    want = jax_index.search_flat(jix, jnp.asarray(q), jnp.asarray(qm), k=7,
                                 scan=cfg_j)
    got = search_flat(tix, *to_torch(q, qm), k=7, scan=cfg_t)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *want, TOL)
    want = jax_index.search_flat_candidates(
        jix, jnp.asarray(q), jnp.asarray(qm), jnp.asarray(cand), k=12,
        scan=cfg_j)
    got = search_flat_candidates(tix, *to_torch(q, qm, cand), k=12,
                                 scan=cfg_t)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *want, TOL)


# -- float and Hamming scans --------------------------------------------------

def _float_case(seed, n=N_STREAM, b=3, mq=5, d=16, md=7, per_query=False):
    rng = np.random.default_rng(seed)
    lead = (b, n) if per_query else (n,)
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    docs = rng.standard_normal(lead + (md, d)).astype(np.float32)
    qm = rng.random((b, mq)) > 0.2
    dm = rng.random(lead + (md,)) > 0.2
    dm[..., 0] = True
    return q, qm, docs, dm


def _hamming_case(seed, n=N_STREAM, b=3, mq=6, md=9, bits=5, per_query=False):
    rng = np.random.default_rng(seed)
    lead = (b, n) if per_query else (n,)
    qc = rng.integers(0, 2 ** bits, (b, mq)).astype(np.uint8)
    dc = rng.integers(0, 2 ** bits, lead + (md,)).astype(np.uint16)
    qm = rng.random((b, mq)) > 0.3
    dm = rng.random(lead + (md,)) > 0.3
    dm[..., 0] = True
    return qc, qm, dc, dm


def _run(fn_name, case, *, k, block, carry=None, **kw):
    """(port result, JAX result) of one topk function on the same inputs;
    ``carry`` is a numpy (scores, ids) pair handed to both."""
    extra = {"bits": 5} if fn_name == "hamming_maxsim_topk" else {}
    jkw = {key: jnp.asarray(v) for key, v in kw.items()}
    tkw = {key: to_torch(v)[0] for key, v in kw.items()}
    if carry is not None:
        jkw["carry"] = tuple(map(jnp.asarray, carry))
        tkw["carry"] = to_torch(*carry)
    want = getattr(jax_scan, fn_name)(
        *map(jnp.asarray, case), k=k,
        scan=jax_scan.ScanConfig(block_docs=block, impl="jnp"), **extra,
        **jkw)
    got = getattr(scan, fn_name)(
        *to_torch(*case), k=k,
        scan=scan.ScanConfig(block_docs=block, impl="plain"), **extra, **tkw)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("block", [3, 16, 256])
def test_maxsim_topk_matches_jax(block, per_query):
    """Float scores within 1e-4 (caveat C1: the reference's own float
    scores drift by ULPs with block shape), ids outside near-ties."""
    n = 11 if per_query else N_STREAM
    case = _float_case(8, n=n, per_query=per_query)
    kw = {}
    if per_query:
        rng = np.random.default_rng(8)
        kw = {"doc_ids": rng.permutation(100)[:3 * n].reshape(3, n)
              .astype(np.int32), "valid": rng.random((3, n)) > 0.2}
    (got_s, got_i), (want_s, want_i) = _run("maxsim_topk", case, k=5,
                                            block=block, **kw)
    assert got_s.dtype == np.float32 and got_i.dtype == np.int32
    assert_topk_match(got_s, got_i, want_s, want_i, TOL)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("block", [1, 4, 16, 256])
def test_hamming_maxsim_topk_matches_jax(block, per_query):
    """Integer scores: bit-equal, ids equal (ties resolve lowest first)."""
    n = 11 if per_query else N_STREAM
    case = _hamming_case(9, n=n, per_query=per_query)
    kw = {}
    if per_query:
        rng = np.random.default_rng(9)
        kw = {"doc_ids": rng.permutation(100)[:3 * n].reshape(3, n)
              .astype(np.int32), "valid": rng.random((3, n)) > 0.2}
    (got_s, got_i), (want_s, want_i) = _run("hamming_maxsim_topk", case,
                                            k=8, block=block, **kw)
    assert got_s.dtype == np.int32 and want_s.dtype == np.int32
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("fn_name", ["maxsim_topk", "hamming_maxsim_topk"])
def test_float_and_hamming_carry_continues_a_sweep(fn_name):
    """A sweep over docs [30, 50) seeded with the result over [0, 30)
    equals the JAX carried sweep and one sweep over all 50."""
    make = _float_case if fn_name == "maxsim_topk" else _hamming_case
    a, am, docs, dm = make(10)
    first, _ = _run(fn_name, (a, am, docs[:30], dm[:30]), k=8, block=7)
    ids = np.arange(30, N_STREAM, dtype=np.int32)
    got, want = _run(fn_name, (a, am, docs[30:], dm[30:]), k=8, block=7,
                     carry=tuple(first), doc_ids=ids)
    whole, _ = _run(fn_name, (a, am, docs, dm), k=8, block=7)
    np.testing.assert_array_equal(got[1], whole[1])
    assert_topk_match(*got, *want, TOL)


@pytest.mark.parametrize("fn_name", ["maxsim_topk", "hamming_maxsim_topk"])
def test_float_and_hamming_sentinels(fn_name):
    """k > N pads id -1 with the merge-buffer init score (-inf, or the
    int32 minimum for Hamming); valid=False slots score NEG_INF (float) or
    the int32 minimum (Hamming) with id -1."""
    make = _float_case if fn_name == "maxsim_topk" else _hamming_case
    case = make(11, n=8)
    valid = np.array([True, False] * 4)
    (got_s, got_i), (want_s, want_i) = _run(fn_name, case, k=12, block=3,
                                            valid=valid)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_i[:, 4:], -1)
    assert set(got_i[0, :4]) == {0, 2, 4, 6}
    if fn_name == "maxsim_topk":
        np.testing.assert_array_equal(got_s[:, 4:8], np.float32(li.NEG_INF))
        assert np.all(np.isneginf(got_s[:, 8:]))
        np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)
    else:
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_s[:, 4:],
                                      np.iinfo(np.int32).min)


def test_hamming_topk_all_masked_docs_rank_above_sentinels():
    """Caveat C4 on the jnp path: an all-masked doc scores
    sum_i qm_i * -(2**20), above the int32-min sentinel."""
    qc, qm, dc, dm = _hamming_case(12, n=10)
    dm[3] = False
    (got_s, got_i), (want_s, want_i) = _run("hamming_maxsim_topk",
                                            (qc, qm, dc, dm), k=12, block=4)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    row = list(got_i[0])
    assert row.index(3) == 9 and got_s[0, 9] == -(2 ** 20) * qm[0].sum()


def test_search_float_flat_and_hamming_match_jax():
    from repro.core import index as jax_index
    from repro_torch.core import index as index_mod
    rng = np.random.default_rng(13)
    cand = rng.integers(-1, N_STREAM, (3, 9)).astype(np.int32)
    cfg_j, cfg_t = jax_scan.ScanConfig(16, "jnp"), scan.ScanConfig(16, "plain")
    q, qm, docs, dm = _float_case(13)
    jix = jax_index.build_float_flat(jnp.asarray(docs), jnp.asarray(dm))
    tix = index_mod.build_float_flat(*to_torch(docs, dm))
    want = jax_index.search_float_flat(jix, jnp.asarray(q), jnp.asarray(qm),
                                       k=7, scan=cfg_j)
    got = index_mod.search_float_flat(tix, *to_torch(q, qm), k=7, scan=cfg_t)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *want, TOL)
    want = jax_index.search_float_flat_candidates(
        jix, jnp.asarray(q), jnp.asarray(qm), jnp.asarray(cand), k=12,
        scan=cfg_j)
    got = index_mod.search_float_flat_candidates(
        tix, *to_torch(q, qm, cand), k=12, scan=cfg_t)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *want, TOL)

    qc, qmh, dc, dmh = _hamming_case(13)
    jh = jax_index.build_hamming(jnp.asarray(dc), jnp.asarray(dmh), 5)
    th = index_mod.build_hamming(*to_torch(dc, dmh), 5)
    assert th.codes.dtype == torch.uint16 and th.bits == 5
    for search, extra in (("search_hamming", ()),
                          ("search_hamming_candidates", (cand,)),
                          ("search_hamming_floor", ())):
        want = getattr(jax_index, search)(
            jh, jnp.asarray(qc), jnp.asarray(qmh),
            *map(jnp.asarray, extra), bits=5, k=12, scan=cfg_j)
        got = getattr(index_mod, search)(th, *to_torch(qc, qmh, *extra),
                                         bits=5, k=12, scan=cfg_t)
        assert got[0].dtype == (torch.float32 if search.endswith("floor")
                                else torch.int32)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

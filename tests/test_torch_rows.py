"""The cascade's stage 3 through candidate rows, and the 3xTF32 arithmetic
of the tensor-core kernels, on the CPU.

* ``core.index.search_float_flat_candidates`` hands its candidate
  positions to the float scan as ``rows`` (the CUDA kernel reads each
  candidate through its id); on the CPU the plain version gathers. Both
  are held to the JAX package's search on the same numpy inputs.
* ``maxsim_plain(rows=...)`` equals ``maxsim_plain`` on the gathered
  tensors, bit for bit.
* ``kmeans_assign`` and ``maxsim`` compute their products on the card in
  3xTF32; an emulation of its rounding shows that their results stay
  within the tolerances the card tests hold them to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jax_index
from repro.core import scan as jax_scan
from repro_torch.core import index as index_mod
from repro_torch.core import late_interaction as li
from repro_torch.core import scan
from repro_torch.kernels import kmeans_assign as km
from repro_torch.kernels import maxsim as ms
from tests._torch_parity import assert_topk_match, code_gaps, to_torch

TOL = 1e-5


def _corpus(seed, n=40, b=3, mq=5, d=16, md=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    docs = rng.standard_normal((n, md, d)).astype(np.float32)
    qm = rng.random((b, mq)) > 0.2
    dm = rng.random((n, md)) > 0.2
    dm[:, 0] = True
    dm[5] = False                                      # an all-masked doc
    doc_ids = (rng.permutation(10 * n)[:n]).astype(np.int32)
    return q, qm, docs, dm, doc_ids


def _candidates(seed, b, p, n):
    """(B, P) positions with -1 slots and repeated ids."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, n, (b, p)).astype(np.int32)
    cand[:, 1::4] = cand[:, :1]
    cand[:, 2::5] = -1
    cand[0, 3] = 5                                     # the all-masked doc
    return cand


@pytest.mark.parametrize("block", [7, 256])
@pytest.mark.parametrize("p,k", [(9, 4), (9, 12), (30, 30)])
def test_search_float_flat_candidates_by_rows_matches_jax(block, p, k):
    """-1 slots, repeated ids, an all-masked doc, k <= P and k > P: scores
    within 1e-5, ids equal outside near-ties."""
    q, qm, docs, dm, doc_ids = _corpus(block + p + k)
    cand = _candidates(p + k, q.shape[0], p, docs.shape[0])
    jix = jax_index.build_float_flat(jnp.asarray(docs), jnp.asarray(dm),
                                     jnp.asarray(doc_ids))
    want = jax_index.search_float_flat_candidates(
        jix, jnp.asarray(q), jnp.asarray(qm), jnp.asarray(cand), k=k,
        scan=jax_scan.ScanConfig(block, "jnp"))
    tix = index_mod.build_float_flat(*to_torch(docs, dm, doc_ids))
    got = index_mod.search_float_flat_candidates(
        tix, *to_torch(q, qm, cand), k=k,
        scan=scan.ScanConfig(block, "plain"))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_match(got[0].numpy(), got[1].numpy(), *want, TOL)
    if k > p:
        np.testing.assert_array_equal(got[1].numpy()[:, p:], -1)


def test_stage3_scan_takes_rows_not_a_gathered_pool(monkeypatch):
    """search_float_flat_candidates hands the corpus and the positions to
    the scan kernel: no (B, P, Md, D) tensor reaches it."""
    q, qm, docs, dm, doc_ids = _corpus(3)
    cand = _candidates(3, q.shape[0], 9, docs.shape[0])
    seen, depth = [], [0]
    plain = ms.maxsim_plain

    def spy(qf, qmf, d, m, rows=None):
        if depth[0] == 0:           # the scan's call, not the plain gather's
            seen.append((tuple(d.shape), None if rows is None
                         else tuple(rows.shape)))
        depth[0] += 1
        try:
            return plain(qf, qmf, d, m, rows=rows)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(ms, "maxsim_plain", spy)
    tix = index_mod.build_float_flat(*to_torch(docs, dm, doc_ids))
    index_mod.search_float_flat_candidates(
        tix, *to_torch(q, qm, cand), k=4, scan=scan.ScanConfig(4, "plain"))
    assert seen == [(docs.shape, (3, 4)), (docs.shape, (3, 4)),
                    (docs.shape, (3, 1))]


def test_maxsim_plain_rows_equals_the_gathered_pools_bit_for_bit():
    q, qm, docs, dm, _ = _corpus(4, n=30, b=4, mq=6, md=9)
    cand = _candidates(4, 4, 11, 30)
    cand[1, 4] = 30                                    # past the corpus
    cand[2, 6] = 10 ** 6
    tq, tqm, tdocs, tdm, tcand = to_torch(q, qm.astype(np.float32), docs, dm,
                                          cand)
    got = ms.maxsim_plain(tq, tqm, tdocs, tdm, rows=tcand)
    live = (tcand >= 0) & (tcand < 30)
    safe = torch.where(live, tcand, 0).long()
    want = ms.maxsim_plain(tq, tqm, tdocs[safe], tdm[safe])
    assert got.shape == (4, 11) and got.dtype == torch.float32
    assert torch.equal(got[live], want[live])
    assert torch.all(got[tcand < 0] == np.float32(li.NEG_INF))
    assert torch.isnan(got[tcand >= 30]).all()
    # a strided slice of rows along P, as the scan hands blocks over
    sl, ss = tcand[:, 2:8], safe[:, 2:8]
    got = ms.maxsim_plain(tq, tqm, tdocs, tdm, rows=sl)
    want = ms.maxsim_plain(tq, tqm, tdocs[ss], tdm[ss])
    assert torch.equal(got[live[:, 2:8]], want[live[:, 2:8]])


# -- 3xTF32 ------------------------------------------------------------------

def _tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits) on the bit
    pattern: nearest, ties away from zero (cvt.rna.tf32.f32; the kernels'
    integer add and mask)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_trunc(x):
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _dot_3xtf32(a, b):
    """a (M, D) @ b (N, D)^T with each operand split as the kernels split
    it (hi = v rounded to TF32, lo = v - hi as the tensor core reads it),
    summed as a_lo b_hi + a_hi b_lo + a_hi b_hi in f32.

    This emulates the rounding of the kernels' split-precision product,
    not the tensor core's order of accumulation (numpy sums each product
    in its own order)."""
    a_hi = _tf32(a)
    a_lo = _tf32_trunc(a - a_hi)
    b_hi = _tf32(b)
    b_lo = _tf32_trunc(b - b_hi)
    return (a_lo @ b_hi.T + a_hi @ b_lo.T) + a_hi @ b_hi.T


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                      # TF32 ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4, one + ulp + ulp / 2], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([one + ulp, -(one + ulp), one, one + ulp,
                            one + 2 * ulp], np.float32))
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = _tf32(v)
    lo = _tf32_trunc(v - hi)
    assert np.all(np.abs(v - hi) <= np.abs(v) * 2.0 ** -11)
    assert np.all(np.abs(v - hi - lo) <= np.abs(v) * 2.0 ** -21)


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("n,d,k,unit", [(4096, 128, 256, True),
                                        (1000, 128, 256, False),
                                        (777, 128, 1000, False),
                                        (64, 300, 70, False)])
def test_kmeans_assign_in_3xtf32_agrees_outside_near_ties(n, d, k, unit):
    """Codes from 3xTF32 distances (c2 in f32, one FMA-like c2 - 2 x.c)
    equal ``kmeans_assign_plain``'s except where the two distances are
    within 1e-4 (in float64)."""
    rng = np.random.default_rng(n + d + k)
    if unit:
        x, c = _unit(rng, n, d), _unit(rng, k, d)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        c = rng.standard_normal((k, d)).astype(np.float32)
    c2 = (c * c).sum(-1, dtype=np.float32)
    got = np.argmin(c2[None] - np.float32(2) * _dot_3xtf32(x, c), axis=1)
    want = km.kmeans_assign_plain(*to_torch(x, c)).numpy()
    diff = got != want
    assert diff.mean() <= 1e-4 + 1.0 / n
    assert np.all(code_gaps(x, c, got, want) <= 1e-4)


@pytest.mark.parametrize("b,mq,d,n,md,unit", [(8, 32, 128, 16, 615, True),
                                              (3, 5, 30, 33, 17, False),
                                              (2, 40, 64, 20, 130, False),
                                              (2, 16, 300, 12, 32, False)])
def test_maxsim_in_3xtf32_stays_within_the_card_tolerance(b, mq, d, n, md,
                                                          unit):
    """Scores from 3xTF32 dot products (masked max, qm-weighted sum) stay
    within atol = rtol = 1e-4 of ``maxsim_plain``, all-masked docs
    included."""
    rng = np.random.default_rng(b + mq + d + n + md)
    if unit:
        q, docs = _unit(rng, b, mq, d), _unit(rng, n, md, d)
    else:
        q = rng.standard_normal((b, mq, d)).astype(np.float32)
        docs = rng.standard_normal((n, md, d)).astype(np.float32)
    qm = (rng.random((b, mq)) < 0.9).astype(np.float32)
    dm = rng.random((n, md)) < 0.8
    dm[::5] = False
    sim = _dot_3xtf32(q.reshape(-1, d), docs.reshape(-1, d)).reshape(
        b, mq, n, md)
    per_q = np.where(dm[None, None], sim, np.float32(li.NEG_INF)).max(-1)
    got = (per_q * qm[:, :, None]).sum(1, dtype=np.float32)
    want = ms.maxsim_plain(*to_torch(q, qm, docs, dm)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

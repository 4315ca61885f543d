"""The port's ADC sweep, per-range top-k lists merged once, against
``repro.core.scan.quantized_maxsim_topk`` (impl="jnp").

On the CPU the port's sweep runs ``quantized_maxsim_topk_plain`` (ranges of
``block_docs``) and then the same single merge the card runs after its one
launch, so these tests reach that merge. Scores agree within atol = rtol =
1e-4 (f32 sums in another order); ids agree exactly, since the only exact
ties are planted and must resolve as ``lax.top_k`` resolves them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jax_scan
from repro_torch.core import late_interaction as li
from repro_torch.core import scan
from repro_torch.kernels import quantized_maxsim as qm
from tests._torch_parity import to_torch

TOL = 1e-4


def _case(seed, *, n=50, b=3, mq=5, d=16, md=7, k_cb=32, lead=None,
          code_dtype=np.uint8):
    """Queries, codes and masks from a numpy seed; ``lead`` is the codes'
    leading shape ((n,) shared by default, (b, p) for per-query pools)."""
    rng = np.random.default_rng(seed)
    lead = (n,) if lead is None else lead
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    cb = rng.standard_normal((k_cb, d)).astype(np.float32)
    codes = rng.integers(0, k_cb, lead + (md,)).astype(code_dtype)
    qm_ = rng.random((b, mq)) > 0.2
    qm_[:, 0] = True
    dm = rng.random(lead + (md,)) > 0.2
    dm[..., 0] = True                     # no accidental all-masked docs
    return q, qm_, codes, dm, cb


def _both(case, *, k, block, torch_codes=None, carry=None, **kw):
    """(port result, JAX result) as numpy; ``carry`` is a numpy (scores,
    ids) pair handed to both; ``torch_codes`` optionally hands the port
    (codes, d_mask) tensors of its own layout (a strided slice)."""
    jkw = {key: jnp.asarray(v) for key, v in kw.items()}
    tkw = {key: to_torch(v)[0] for key, v in kw.items()}
    if carry is not None:
        jkw["carry"] = tuple(map(jnp.asarray, carry))
        tkw["carry"] = to_torch(*carry)
    want = jax_scan.quantized_maxsim_topk(
        *map(jnp.asarray, case), k=k,
        scan=jax_scan.ScanConfig(block_docs=block, impl="jnp"), **jkw)
    args = list(to_torch(*case))
    if torch_codes is not None:
        args[2], args[3] = torch_codes
    got = scan.quantized_maxsim_topk(
        *args, k=k, scan=scan.ScanConfig(block_docs=block, impl="plain"),
        **tkw)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


def _assert_same(got, want):
    (got_s, got_i), (want_s, want_i) = got, want
    assert got_s.dtype == np.float32 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("block", [1, 3, 8, 64])
def test_planted_ties_across_and_inside_ranges(block):
    """Docs 3, 4, 5, 10, 20 and 41 are identical and every query favours
    them: they tie exactly inside one range and across ranges, and come
    back in ascending position, as from one global lax.top_k."""
    q, qm_, codes, dm, cb = _case(0)
    for dup in (4, 5, 10, 20, 41):
        codes[dup], dm[dup] = codes[3], dm[3]
    q[:] = cb[codes[3, 0]]
    got, want = _both((q, qm_, codes, dm, cb), k=8, block=block)
    _assert_same(got, want)
    for row in got[1]:
        dup = [i for i in row if i in (3, 4, 5, 10, 20, 41)]
        assert dup == sorted(dup) and len(dup) >= 4


@pytest.mark.parametrize("per_query", [False, True])
def test_carry_continues_a_sweep(per_query):
    """Sweeping positions [30, 50) seeded with the result over [0, 30)
    equals JAX's carried sweep and one sweep over all 50."""
    lead = (3, 50) if per_query else None
    q, qm_, codes, dm, cb = _case(1, lead=lead)
    axis = 1 if per_query else 0
    ids = np.arange(50, dtype=np.int32)
    if per_query:
        ids = np.random.default_rng(1).permutation(200)[:150].reshape(
            3, 50).astype(np.int32)

    def part(lo, hi):
        sl = [slice(None)] * codes.ndim
        sl[axis] = slice(lo, hi)
        return codes[tuple(sl)], dm[tuple(sl)], ids[..., lo:hi]

    c0, m0, i0 = part(0, 30)
    c1, m1, i1 = part(30, 50)
    first, jfirst = _both((q, qm_, c0, m0, cb), k=8, block=7, doc_ids=i0)
    got, want = _both((q, qm_, c1, m1, cb), k=8, block=7, doc_ids=i1,
                      carry=tuple(first))
    _assert_same(got, want)
    jwant = jax_scan.quantized_maxsim_topk(
        *map(jnp.asarray, (q, qm_, c1, m1, cb)), k=8,
        doc_ids=jnp.asarray(i1), carry=tuple(map(jnp.asarray, jfirst)),
        scan=jax_scan.ScanConfig(7, "jnp"))
    _assert_same(got, [np.asarray(a) for a in jwant])
    whole, _ = _both((q, qm_, codes, dm, cb), k=8, block=7, doc_ids=ids)
    np.testing.assert_array_equal(got[1], whole[1])


@pytest.mark.parametrize("k,block,n", [(12, 5, 50), (60, 16, 50),
                                       (9, 8, 37), (3, 256, 37)])
def test_k_against_range_and_corpus(k, block, n):
    """k > R, k > N (rows past N carry id -1 and -inf) and a ragged last
    range."""
    got, want = _both(_case(2, n=n), k=k, block=block)
    _assert_same(got, want)
    if k > n:
        np.testing.assert_array_equal(got[1][:, n:], -1)
        assert np.all(np.isneginf(got[0][:, n:]))


@pytest.mark.parametrize("per_query", [False, True])
def test_invalid_slots_rank_above_all_masked_docs(per_query):
    """valid=False slots score exactly NEG_INF with id -1; an all-masked
    doc scores sum_i qm_i * -1e30, below NEG_INF, so it ranks after them
    and before the -inf sentinels of k > N."""
    lead = (3, 12) if per_query else (12,)
    q, qm_, codes, dm, cb = _case(3, n=12, lead=lead)
    qm_[:, :2] = True                     # sum qm >= 2: below NEG_INF
    dm[..., 4, :] = False
    dm[..., 9, :] = False
    valid = np.ones(lead, bool)
    valid[..., 2] = valid[..., 7] = False
    got, want = _both((q, qm_, codes, dm, cb), k=14, block=5, valid=valid)
    _assert_same(got, want)
    s, i = got
    np.testing.assert_array_equal(i[:, 8:10], -1)
    np.testing.assert_array_equal(s[:, 8:10], np.float32(li.NEG_INF))
    assert all(set(row[10:12]) == {4, 9} for row in i)
    assert np.all(s[:, 10:12] < np.float32(li.NEG_INF))
    np.testing.assert_array_equal(i[:, 12:], -1)
    assert np.all(np.isneginf(s[:, 12:]))


@pytest.mark.parametrize("layout", ["shared", "per_query", "strided_pool"])
def test_layouts(layout):
    """The shared corpus, per-query pools with doc_ids and valid, and a
    strided slice of a pool (handed to the port as a view)."""
    rng = np.random.default_rng(4)
    if layout == "shared":
        got, want = _both(_case(4, n=40), k=6, block=8)
        _assert_same(got, want)
        return
    p = 20 if layout == "strided_pool" else 11
    q, qm_, codes, dm, cb = _case(4, lead=(3, p), k_cb=16)
    ids = rng.permutation(100)[:3 * p].reshape(3, p).astype(np.int32)
    valid = rng.random((3, p)) > 0.2
    kw = {"doc_ids": ids, "valid": valid}
    if layout == "per_query":
        got, want = _both((q, qm_, codes, dm, cb), k=5, block=4, **kw)
    else:
        sl = (slice(None), slice(3, 14))
        view = (torch.from_numpy(codes)[sl], torch.from_numpy(dm)[sl])
        assert not view[0].is_contiguous()
        got, want = _both((q, qm_, codes[sl], dm[sl], cb), k=5, block=4,
                          torch_codes=view, doc_ids=ids[sl],
                          valid=valid[sl])
    _assert_same(got, want)


@pytest.mark.parametrize("mq", [5, 32, 40])
def test_query_widths(mq):
    """Fewer query patches than a warp's 32 lanes, exactly 32, and more
    (the kernel's two chunks)."""
    got, want = _both(_case(5, mq=mq, n=33, md=11), k=7, block=8)
    _assert_same(got, want)


@pytest.mark.parametrize("per_query", [False, True])
def test_k512_uint16_codes(per_query):
    lead = (2, 30) if per_query else (45,)
    case = _case(6, b=2, lead=lead, md=9, k_cb=512, code_dtype=np.uint16)
    assert case[2].max() > 255
    got, want = _both(case, k=10, block=8)
    _assert_same(got, want)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k,r", [(4, 8), (8, 8), (12, 5)])
def test_topk_plain_lists_equal_a_sort_of_the_scores(k, r, per_query):
    """Each range's list is its slice of quantized_maxsim_plain's scores,
    NEG_INF and -1 at invalid slots, stably sorted descending, cut to
    min(k, R), padded with (-inf, -1) when the range is shorter."""
    n, b = 29, 3
    lead = (b, n) if per_query else (n,)
    q, qm_, codes, dm, cb = _case(7, n=n, b=b, lead=lead)
    codes[..., 6, :], dm[..., 6, :] = codes[..., 2, :], dm[..., 2, :]
    table = li.adc_table(*to_torch(q, cb)).contiguous()
    qmf = torch.from_numpy(qm_).float()
    c, m = to_torch(codes, dm)
    valid = torch.from_numpy(np.random.default_rng(7).random(lead) > 0.25)
    s, pos = qm.quantized_maxsim_topk_plain(table, qmf, c, m, valid, k=k,
                                            range_len=r)
    kk = min(k, r)
    n_ranges = -(-n // r)
    assert s.shape == pos.shape == (b, n_ranges, kk)
    assert pos.dtype == torch.int32
    v = valid.expand(b, n)
    at = torch.where(v, torch.arange(n, dtype=torch.int32), -1)
    axis = 1 if per_query else 0
    for g in range(n_ranges):
        lo, hi = g * r, min(n, g * r + r)
        scores = qm.quantized_maxsim_plain(table, qmf,
                                           c.narrow(axis, lo, hi - lo),
                                           m.narrow(axis, lo, hi - lo))
        scores = torch.where(v[:, lo:hi], scores, li.NEG_INF)
        srt, sel = torch.sort(scores, dim=1, descending=True, stable=True)
        m_ = min(kk, hi - lo)
        assert torch.equal(s[:, g, :m_], srt[:, :m_])
        assert torch.equal(pos[:, g, :m_], torch.gather(at[:, lo:hi], 1,
                                                        sel[:, :m_]))
        assert torch.all(torch.isneginf(s[:, g, m_:]))
        assert torch.all(pos[:, g, m_:] == -1)

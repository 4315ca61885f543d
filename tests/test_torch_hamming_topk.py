"""The Hamming sweep's per-range top-k lists against the reference.

``scan.hamming_maxsim_topk`` keeps each range's top min(k, R) and merges
the lists once (on the card one ``hamming_maxsim_topk`` launch a sweep).
Here its plain path is held, ids and scores exactly equal ties included,
to two references on the same numpy inputs: the JAX
``repro.core.scan.hamming_maxsim_topk`` (impl="jnp") and the per-block
stream the port ran before (``scan._streaming_topk`` over
``hamming_maxsim_plain``). The corpora tie heavily: each document's codes
come from a window of 4 codebook entries, so many documents share a
score. Covered: k below, at and above the range length and above N, a
ragged N, all-masked pages, valid masks of both shapes, carry, per-query
pools, bits 8, 9 and 12, uint8 and uint16 codes, and a sweep cut into
several merges (MAX_CANDIDATES lowered).

The CUDA kernel's own arithmetic is rehearsed here in numpy: its table
body (each page's code set, the distance transform over the lane and
register bits, one lookup per query patch) and its exact rank count for
the lists, each against the plain version, bit for bit. The card holds
the kernel to the plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 6). Under a ``FakeTensorMode`` the stage-1 sweep
of 16,384 documents is one launch.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import scan as jax_scan
from repro_torch.analysis import pallas_check as pc
from repro_torch.core import scan
from repro_torch.kernels import hamming as hm
from repro_torch.kernels import vmem
from tests._torch_parity import to_torch

INT_MIN = np.iinfo(np.int32).min


def _case(seed, *, n=37, b=3, mq=6, md=9, bits=8, dtype=np.uint16,
          per_query=False, window=4, masked=()):
    """Query and document codes from windows of ``window`` codebook
    entries: documents share codes, and so scores. Pages in ``masked``
    have no valid patch."""
    rng = np.random.default_rng(seed)
    lead = (b, n) if per_query else (n,)
    top = 2 ** bits - window
    base = rng.integers(0, top + 1, lead + (1,))
    dc = (base + rng.integers(0, window, lead + (md,))).astype(dtype)
    qbase = rng.integers(0, top + 1, (b, 1))
    qc = (qbase + rng.integers(0, window, (b, mq))).astype(np.int32)
    qm = rng.random((b, mq)) > 0.2
    qm[:, 0] = True
    dm = rng.random(lead + (md,)) > 0.3
    dm[..., 0] = True
    for i in masked:
        dm[..., i, :] = False
    return qc, qm, dc, dm


def _jax(case, *, bits, k, block, **kw):
    jkw = {key: (tuple(map(jnp.asarray, v)) if key == "carry"
                 else jnp.asarray(v)) for key, v in kw.items()}
    out = jax_scan.hamming_maxsim_topk(
        *map(jnp.asarray, case), bits=bits, k=k,
        scan=jax_scan.ScanConfig(block_docs=block, impl="jnp"), **jkw)
    return [np.asarray(a) for a in out]


def _torch_kw(kw):
    return {key: (to_torch(*v) if key == "carry" else to_torch(v)[0])
            for key, v in kw.items()}


def _ranges(case, *, bits, k, range_len, **kw):
    """The port's sweep: per-range lists merged once."""
    out = scan.hamming_maxsim_topk(
        *to_torch(*case), bits=bits, k=k,
        scan=scan.ScanConfig(block_docs=range_len, impl="plain"),
        **_torch_kw(kw))
    return [t.numpy() for t in out]


def _stream(case, *, bits, k, block, doc_ids=None, valid=None, carry=None):
    """The per-block stream the Hamming sweep ran before its range lists:
    each block scored, then merged into the running (B, k) buffer."""
    qc, qm, dc, dm = to_torch(*case)
    per_query = dc.dim() == 3
    b = qc.shape[0]
    n = dc.shape[1] if per_query else dc.shape[0]
    ids, v = scan._prep(n, None if doc_ids is None else to_torch(doc_ids)[0],
                        None if valid is None else to_torch(valid)[0],
                        per_query, b, "cpu")
    qc, qm = qc.to(torch.int32), qm.to(torch.int32)
    out = scan._streaming_topk(
        lambda c, m: hm.hamming_maxsim_plain(qc, qm, c, m, bits), (dc, dm),
        ids, v, b=b, n=n, k=k, block_docs=block, per_query=per_query,
        score_dtype=torch.int32,
        carry=None if carry is None else to_torch(*carry))
    return [t.numpy() for t in out]


def _equal_all(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32


# name -> (the case's kwargs, k, range length)
_CASES = {
    "k_below_R": (dict(), 4, 8),
    "k_equals_R": (dict(), 8, 8),
    "k_above_R": (dict(), 20, 8),
    "k_above_N": (dict(n=11), 16, 4),
    "ragged_N_R_16": (dict(n=53), 5, 16),
    "one_range": (dict(n=29), 6, 256),
    "all_masked_pages": (dict(masked=(0, 5, 6, 30)), 12, 8),
    "bits9_uint16": (dict(bits=9), 7, 8),
    "bits12_uint16": (dict(bits=12, window=3), 7, 8),
    "bits8_uint8": (dict(dtype=np.uint8), 7, 8),
    "bits5_uint8": (dict(bits=5, dtype=np.uint8, window=2), 7, 8),
    "wide_window": (dict(window=64, md=20), 9, 8),
    "mq_above_32": (dict(mq=40, md=5), 6, 8),
    "per_query": (dict(per_query=True, n=23), 6, 4),
    "per_query_k_above_R": (dict(per_query=True, n=23), 9, 4),
    "per_query_bits12": (dict(per_query=True, n=17, bits=12), 5, 4),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_range_lists_equal_jax_and_the_block_stream(name):
    """Ids and scores equal, exactly, to the JAX sweep and to the old
    per-block stream; the JAX sweep and the stream run at another block
    length than the port's ranges."""
    ckw, k, r = _CASES[name]
    bits = ckw.get("bits", 8)
    case = _case(zlib.crc32(name.encode()) % 1000, **ckw)
    got = _ranges(case, bits=bits, k=k, range_len=r)
    _equal_all(got, _jax(case, bits=bits, k=k, block=7),
               _stream(case, bits=bits, k=k, block=5))


@pytest.mark.parametrize("shape", ["n", "bn"])
@pytest.mark.parametrize("k", [3, 8, 40])
def test_valid_masks_and_doc_ids(shape, k):
    """Invalid slots score the int32 minimum with id -1, as in the
    reference and the stream; ids map positions to global ids."""
    case = _case(21, n=31, masked=(4,))
    rng = np.random.default_rng(21)
    valid = rng.random((31,) if shape == "n" else (3, 31)) > 0.3
    ids = rng.permutation(1000)[:31].astype(np.int32)
    kw = dict(valid=valid, doc_ids=ids)
    got = _ranges(case, bits=8, k=k, range_len=8, **kw)
    _equal_all(got, _jax(case, bits=8, k=k, block=6, **kw),
               _stream(case, bits=8, k=k, block=9, **kw))
    if k == 40:   # more than the valid docs: sentinels fill the tail
        assert (got[1][:, -1] == -1).all() and (got[0][:, -1] == INT_MIN).all()


@pytest.mark.parametrize("per_query", [False, True])
def test_per_query_pools_with_ids_and_valid(per_query):
    n = 19
    case = _case(31, n=n, per_query=per_query, masked=(2,))
    rng = np.random.default_rng(31)
    kw = dict(valid=rng.random((3, n)) > 0.25,
              doc_ids=rng.permutation(100)[:3 * n].reshape(3, n)
              .astype(np.int32))
    if not per_query:
        kw["doc_ids"] = kw["doc_ids"][0]
    for k, r in ((4, 4), (12, 4), (25, 8)):
        got = _ranges(case, bits=8, k=k, range_len=r, **kw)
        _equal_all(got, _jax(case, bits=8, k=k, block=5, **kw),
                   _stream(case, bits=8, k=k, block=3, **kw))


@pytest.mark.parametrize("k", [5, 24])
def test_carry_continues_a_sweep(k):
    """A sweep over docs [20, 45) seeded with the result over [0, 20)
    equals the reference's carried sweep, the carried stream and one
    sweep over all 45."""
    qc, qm, dc, dm = _case(41, n=45, masked=(22,))
    first = _ranges((qc, qm, dc[:20], dm[:20]), bits=8, k=k, range_len=8)
    ids = np.arange(20, 45, dtype=np.int32)
    kw = dict(carry=tuple(first), doc_ids=ids)
    rest = (qc, qm, dc[20:], dm[20:])
    got = _ranges(rest, bits=8, k=k, range_len=8, **kw)
    _equal_all(got, _jax(rest, bits=8, k=k, block=6, **kw),
               _stream(rest, bits=8, k=k, block=4, **kw),
               _ranges((qc, qm, dc, dm), bits=8, k=k, range_len=16))


@pytest.mark.parametrize("k", [3, 16])
def test_a_sweep_cut_into_several_merges(monkeypatch, k):
    """With MAX_CANDIDATES lowered the sweep takes several chunks, each
    one call and one merge, and gives the same lists."""
    case = _case(51, n=61, masked=(9,))
    want = _ranges(case, bits=8, k=k, range_len=4)
    monkeypatch.setattr(scan, "MAX_CANDIDATES", 3 * 4 * 2)
    calls = []
    real = hm.hamming_maxsim_topk_plain
    monkeypatch.setattr(hm, "hamming_maxsim_topk_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = _ranges(case, bits=8, k=k, range_len=4)
    assert len(calls) == -(-61 // (4 * max(1, 24 // (3 * min(k, 4)))))
    _equal_all(got, want, _jax(case, bits=8, k=k, block=7))


# --- the CUDA kernel's arithmetic, rehearsed in numpy -------------------------

def _table_body(qc, qm, codes, mask, bits):
    """The table body of csrc/hamming_maxsim.cu for one page at a time:
    flags of the valid codes, lane l holding codes r * 32 + l as
    distances, one transform pass per code bit (bits 0-4 across lanes,
    the rest across registers), one lookup per query patch."""
    regs = 1 if bits <= 5 else 1 << (bits - 5)
    far = 1 << 10
    cmask = (1 << bits) - 1
    b = qc.shape[0]
    per_query = codes.ndim == 3
    n = codes.shape[-2]
    out = np.zeros((b, n), np.int64)
    for q in range(b):
        for d in range(n):
            c = codes[q, d] if per_query else codes[d]
            m = mask[q, d] if per_query else mask[d]
            present = np.zeros(32 * regs, bool)
            present[c[m != 0].astype(np.int64) & cmask] = True
            dd = np.where(present.reshape(regs, 32), 0, far)  # [reg, lane]
            any_ = present.any()
            lane = np.arange(32)
            for i in range(min(bits, 5)):
                dd = np.minimum(dd, dd[:, lane ^ (1 << i)] + 1)
            s = 1
            while s < regs:
                r = np.arange(regs)
                dd = np.minimum(dd, dd[r ^ s] + 1)
                s <<= 1
            dist = np.minimum(dd.reshape(-1), 255)
            qq = qc[q].astype(np.int64) & cmask
            sim = bits - dist[qq] if any_ else np.full(len(qq), -(1 << 20))
            out[q, d] = (qm[q].astype(np.int64) * sim).sum()
    return out.astype(np.int32)


@pytest.mark.parametrize("bits", [1, 3, 5, 6, 8, 9, 10])
@pytest.mark.parametrize("window", [2, 64])
def test_table_body_equals_the_plain_version(bits, window):
    window = min(window, 2 ** bits)
    qc, qm, dc, dm = _case(61 + bits, n=12, md=13, bits=bits, window=window,
                           masked=(3,))
    want = hm.hamming_maxsim_plain(*to_torch(qc.astype(np.int32),
                                             qm.astype(np.int32), dc, dm),
                                   bits).numpy()
    np.testing.assert_array_equal(_table_body(qc, qm, dc, dm, bits), want)


def test_table_body_per_query_pools():
    qc, qm, dc, dm = _case(71, n=9, per_query=True, bits=9, masked=(1,))
    want = hm.hamming_maxsim_plain(*to_torch(qc, qm.astype(np.int32), dc,
                                             dm), 9).numpy()
    np.testing.assert_array_equal(_table_body(qc, qm, dc, dm, 9), want)


def _rank_lists(scores, valid, r, kk):
    """The kernel's lists: each slot ranked by count, #(greater) +
    #(equal and earlier), invalid slots at the int32 minimum with
    position -1, short ranges padded."""
    b, n = scores.shape
    ranges = -(-n // r)
    out_s = np.full((b, ranges, kk), INT_MIN, np.int32)
    out_p = np.full((b, ranges, kk), -1, np.int32)
    for q in range(b):
        for g in range(ranges):
            sc = scores[q, g * r:(g + 1) * r].astype(np.int64)
            ok = valid[q, g * r:(g + 1) * r]
            sc = np.where(ok, sc, INT_MIN)
            for i in range(len(sc)):
                rank = int((sc > sc[i]).sum() + (sc[:i] == sc[i]).sum())
                if rank < kk:
                    out_s[q, g, rank] = sc[i]
                    out_p[q, g, rank] = g * r + i if ok[i] else -1
    return out_s, out_p


@pytest.mark.parametrize("k,r", [(3, 8), (8, 8), (20, 8), (5, 32)])
def test_rank_count_lists_equal_the_plain_lists(k, r):
    qc, qm, dc, dm = _case(81, n=45, masked=(7, 8))
    valid = np.random.default_rng(81).random((3, 45)) > 0.2
    t = to_torch(qc, qm.astype(np.int32), dc, dm, valid)
    got = hm.hamming_maxsim_topk_plain(*t[:4], t[4], bits=8, k=k,
                                       range_len=r)
    scores = hm.hamming_maxsim_plain(*t[:4], 8).numpy()
    want = _rank_lists(scores, valid, r, min(k, r))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


# --- launch geometry and the one-launch sweep ---------------------------------

@pytest.mark.parametrize("b,n,per_query,r,top_k", [
    (8, 16384, 0, 32, 32), (8, 256, 0, 256, 0), (3, 37, 1, 8, 5),
    (40, 100, 0, 16, 16), (1, 1, 0, 2, 1)])
def test_geometry_covers_every_output_once(b, n, per_query, r, top_k):
    g = vmem.hamming_geometry(b, 32, n, 615, 8, per_query, r, top_k)
    qpb = 1 if per_query else min(b, 32)
    assert g.grid == (-(-n // r), -(-b // qpb)) and g.threads == 256
    assert g.config == (qpb, 8, 0, 0)
    c = pc.coverage_counts(g)
    assert c.min() == 1 and c.max() == 1
    assert not pc.check_geometry(
        g, "t", (torch.int32, torch.int32) if top_k else (torch.int32,),
        registers=pc.register_table())


def test_geometry_refusals_and_the_popcount_body():
    assert vmem.hamming_geometry(0, 32, 5, 615, 8, 0, 8, 0) is None
    for bad in [(8, 32, 5, 615, 17, 0, 8, 0), (8, 32, 5, 615, 8, 0, 257, 0),
                (8, 32, 5, 615, 8, 0, 8, 9), (70000, 32, 5, 615, 8, 0, 8, 0)]:
        with pytest.raises(ValueError):
            vmem.hamming_geometry(*bad)
    assert vmem.hamming_geometry(8, 32, 5, 615, 12, 0, 8, 0).config[1] == 0
    assert vmem.hamming_geometry(8, 32, 5, 615, 10, 0, 8, 0).config[1] == 32
    # too many query patches for even one query's staging
    with pytest.raises(ValueError):
        vmem.hamming_geometry(1, 40000, 5, 615, 8, 1, 8, 0)


def test_stage1_range_length():
    """At the stage-1 sweep (8 queries, 16,384 pages, 132 SMs) a block
    takes all 8 queries and 32 pages: 512 blocks."""
    assert hm.launch_range_len(8, 32, 16384, 8, "cpu") == 32
    assert hm.launch_range_len(8, 32, 256, 8, "cpu") == 2
    assert hm.launch_range_len(8, 32, 1 << 22, 8, "cpu") == 256
    assert hm.launch_range_len(8, 32, 1024, 8, "cpu", per_query=True) == 16


@pytest.mark.parametrize("per_query", [False, True])
def test_the_stage1_sweep_is_one_launch(monkeypatch, per_query):
    """The CUDA path's sweep over 16,384 pages (8 queries, k = p1 = 1024)
    is one ``hamming_maxsim_topk_cuda`` call at ``launch_range_len``, and
    one merge; here the plain lists stand in for the kernel's and the
    result equals the plain sweep's."""
    n, md = 16384, 3
    case = _case(91, n=n, b=8, mq=4, md=md, per_query=per_query,
                 masked=(17,))
    want = _ranges(case, bits=8, k=1024, range_len=256)
    calls, merges = [], []

    def stand_in(qc, qm, c, m, v, *, bits, k, range_len):
        calls.append(range_len)
        return hm.hamming_maxsim_topk_plain(qc, qm, c, m, v, bits=bits, k=k,
                                            range_len=range_len)

    real_merge = scan._merge
    monkeypatch.setattr(scan, "resolve_impl", lambda impl, device: "cuda")
    monkeypatch.setattr(hm, "hamming_maxsim_topk_cuda", stand_in)
    monkeypatch.setattr(scan, "_merge", lambda *a: merges.append(1) or
                        real_merge(*a))
    got = scan.hamming_maxsim_topk(*to_torch(*case), bits=8, k=1024)
    assert calls == [hm.launch_range_len(8, 4, n, 8, "cpu", per_query)]
    assert len(merges) == 1
    _equal_all([t.numpy() for t in got], want)


def test_wrapper_records_one_fake_launch():
    """On fake CUDA tensors the wrapper launches nothing and records one
    launch whose geometry declares its outputs."""
    seen = []
    before = hm.launches
    vmem._recorders.append(lambda g, shapes, fl, nb: seen.append(g))
    try:
        with FakeTensorMode():
            dev = "cuda"
            qc = torch.empty(8, 32, dtype=torch.int32, device=dev)
            dc = torch.empty(16384, 615, dtype=torch.uint16, device=dev)
            dm = torch.empty(16384, 615, dtype=torch.bool, device=dev)
            s, p = hm.hamming_maxsim_topk_cuda(qc, qc, dc, dm, None, bits=8,
                                               k=1024)
    finally:
        vmem._recorders.pop()
    assert hm.launches == before
    assert [g.kernel for g in seen] == ["hamming_maxsim_topk"]
    assert tuple(s.shape) == tuple(p.shape) == (8, 512, 32)
    assert (tuple(s.shape), s.dtype) == seen[0].outputs[0]

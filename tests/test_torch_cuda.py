"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips, inside its body, on a host without a
CUDA device. This file imports no JAX (the card's host has none), so it
runs there on its own:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import scan
from repro_torch.kernels import hamming as hm
from repro_torch.kernels import kmeans_assign as km
from repro_torch.kernels import maxsim as ms
from repro_torch.kernels import ops
from repro_torch.kernels import quantized_maxsim as qm
from repro_torch.parity import topk_mismatches

pytestmark = pytest.mark.gpu
TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _adc(seed, b, mq, k, lead, md, code_dtype=torch.uint8, p_valid=0.8):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((b, mq, k), generator=g)
    q_mask = (torch.rand((b, mq), generator=g) < 0.9).float()
    codes = torch.randint(0, k, lead + (md,), generator=g).to(code_dtype)
    d_mask = torch.rand(lead + (md,), generator=g) < p_valid
    return table, q_mask, codes, d_mask


@pytest.mark.parametrize("b,mq,k,n,md", [(1, 4, 16, 16, 8), (3, 5, 64, 33, 17),
                                         (8, 32, 256, 100, 615),
                                         (2, 16, 512, 40, 32)])
@pytest.mark.parametrize("per_query", [False, True])
def test_quantized_maxsim_kernel_matches_plain(b, mq, k, n, md, per_query):
    dev = _card()
    dtype = torch.uint8 if k <= 256 else torch.uint16
    lead = (b, n) if per_query else (n,)
    args = _adc(b + n + md, b, mq, k, lead, md, dtype)
    args[3][..., ::5, :] = False                       # all-masked docs
    want = qm.quantized_maxsim_plain(*args)
    got = qm.quantized_maxsim_cuda(*(a.to(dev) for a in args))
    torch.testing.assert_close(got.cpu(), want, atol=TOL, rtol=TOL)


def test_quantized_maxsim_kernel_takes_strided_pools():
    dev = _card()
    table, q_mask, codes, d_mask = (a.to(dev) for a in _adc(
        1, 4, 8, 64, (4, 30), 20))
    sl = (slice(None), slice(7, 19))
    got = qm.quantized_maxsim_cuda(table, q_mask, codes[sl], d_mask[sl])
    want = qm.quantized_maxsim_plain(table, q_mask, codes[sl], d_mask[sl])
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_quantized_maxsim_kernel_counts_launches_and_refuses_bad_input():
    dev = _card()
    table, q_mask, codes, d_mask = (a.to(dev) for a in _adc(
        2, 2, 4, 16, (10,), 6))
    before = qm.launches
    qm.quantized_maxsim_cuda(table, q_mask, codes, d_mask)
    assert qm.launches == before + 1
    with pytest.raises(ValueError):
        qm.quantized_maxsim_cuda(table, q_mask, codes.int(), d_mask)
    with pytest.raises(ValueError):
        qm.quantized_maxsim_cuda(table, q_mask, codes, d_mask.float())
    with pytest.raises(ValueError):
        qm.quantized_maxsim_cuda(table, q_mask, codes.t(), d_mask.t())
    assert qm.launches == before + 1


@pytest.mark.parametrize("n,d,k", [(1000, 128, 256), (130, 8, 4),
                                   (777, 128, 1000), (64, 300, 70)])
def test_kmeans_assign_kernel_matches_plain(n, d, k):
    dev = _card()
    g = torch.Generator().manual_seed(n + d + k)
    x = torch.randn((n, d), generator=g).to(dev)
    c = torch.randn((k, d), generator=g).to(dev)
    before = km.launches
    got = km.kmeans_assign_cuda(x, c).long()
    assert km.launches == before + 1
    want = km.kmeans_assign_plain(x, c).long()
    rows = torch.nonzero(got != want)[:, 0]
    assert rows.numel() <= max(1, n // 1000)
    xd, cd = x[rows].double(), c.double()
    c2 = (cd * cd).sum(-1)

    def dist(kk):
        return c2[kk] - 2.0 * (xd * cd[kk]).sum(-1)

    assert torch.all((dist(got[rows]) - dist(want[rows])).abs() <= 1e-4)


def test_kmeans_assign_ties_go_to_the_first_index():
    dev = _card()
    c = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    x = torch.tensor([[2.0, 0.0], [0.0, 3.0], [1.0, 1.0]])
    got = km.kmeans_assign_cuda(x.to(dev), c.to(dev)).cpu()
    np.testing.assert_array_equal(got.numpy(), [0, 1, 0])
    np.testing.assert_array_equal(km.kmeans_assign_plain(x, c).numpy(),
                                  [0, 1, 0])


@pytest.mark.parametrize("block", [7, 256])
def test_scan_on_the_card_matches_the_cpu(block):
    dev = _card()
    g = torch.Generator().manual_seed(block)
    q = torch.randn((3, 6, 16), generator=g)
    cb = torch.randn((32, 16), generator=g)
    codes = torch.randint(0, 32, (300, 9), generator=g).to(torch.uint8)
    q_mask = torch.rand((3, 6), generator=g) < 0.9
    d_mask = torch.rand((300, 9), generator=g) < 0.8
    cfg = scan.ScanConfig(block_docs=block)
    want = scan.quantized_maxsim_topk(q, q_mask, codes, d_mask, cb, k=10,
                                      scan=cfg)
    got = scan.quantized_maxsim_topk(*(a.to(dev) for a in (
        q, q_mask, codes, d_mask, cb)), k=10, scan=cfg)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    x = torch.randn((500, 16), generator=g)
    np.testing.assert_array_equal(
        ops.kmeans_assign(x.to(dev), cb.to(dev)).cpu().numpy(),
        ops.kmeans_assign(x, cb).numpy())


# -- quantized_maxsim's per-range top-k and the one-launch sweep -------------

def _assert_lists_match(got, want):
    """Per-range lists: scores within TOL, positions equal outside
    near-ties, (-inf, -1) padding equal."""
    (got_s, got_p), (want_s, want_p) = ((a.cpu() for a in pair)
                                        for pair in (got, want))
    assert got_s.shape == want_s.shape and got_p.dtype == torch.int32
    torch.testing.assert_close(got_s, want_s, atol=TOL, rtol=TOL)
    kk = got_s.shape[-1]
    bad = topk_mismatches(got_p.reshape(-1, kk).numpy(),
                          got_s.reshape(-1, kk).numpy(),
                          want_p.reshape(-1, kk).numpy(),
                          want_s.reshape(-1, kk).numpy(), TOL)
    assert not bad, f"positions differ outside near-ties at {bad[:10]}"


# (b, mq, K, codes' leading shape, md, k, range_len; None = the launch's)
_TOPK_CASES = {
    "flat scan": (8, 32, 256, (16384,), 615, 32, None),
    "rerank pools": (8, 32, 256, (8, 32), 1024, 32, None),
    "stage-2 pools": (8, 32, 256, (8, 1024), 615, 64, None),
    "ragged, k > R": (3, 32, 256, (100,), 615, 20, 16),
    "k > N": (2, 8, 64, (5,), 40, 12, 8),
    "mq 5": (3, 5, 64, (3, 70), 17, 7, 32),
    "mq 40": (2, 40, 128, (90,), 33, 9, 16),
    "K 512 uint16": (2, 16, 512, (2, 60), 32, 10, 16),
    # the ANN routers' pools: ivf's n_probe x cap = 8 x 512 probed slots,
    # hnsw's ef_search = 64 beam survivors, each at the facade's rerank
    # over-fetch (k = 32)
    "ivf pools": (8, 32, 256, (8, 4096), 615, 32, None),
    "hnsw pools": (8, 32, 256, (8, 64), 615, 32, None),
}


@pytest.mark.parametrize("case", list(_TOPK_CASES))
def test_quantized_maxsim_topk_kernel_matches_plain(case):
    """The kernel's range lists against the plain version's, with invalid
    slots (NEG_INF, -1) and all-masked docs (sum qm * -1e30) in every
    case."""
    dev = _card()
    b, mq, k_cb, lead, md, k, r = _TOPK_CASES[case]
    dtype = torch.uint8 if k_cb <= 256 else torch.uint16
    args = [a.to(dev) for a in _adc(len(case) + md, b, mq, k_cb, lead, md,
                                    dtype, p_valid=0.97)]
    args[3][..., 1::7, :] = False                      # all-masked docs
    g = torch.Generator().manual_seed(md)
    valid = (torch.rand(lead if len(lead) == 2 else (b,) + lead, generator=g)
             > 0.1).to(dev)
    if len(lead) == 1 and case != "flat scan":
        valid = valid[0]                               # (N,) valid
    n = lead[-1]
    r = r if r is not None else qm.launch_range_len(b, n, dev)
    before = qm.launches
    got = qm.quantized_maxsim_topk_cuda(*args, valid, k=k, range_len=r)
    assert qm.launches == before + 1
    want = qm.quantized_maxsim_topk_plain(*args, valid, k=k, range_len=r)
    torch.cuda.synchronize()
    assert got[0].shape == (b, -(-n // r), min(k, r))
    _assert_lists_match(got, want)
    if len(lead) == 1:                       # one query per block, as well
        _assert_lists_match(qm.quantized_maxsim_topk_cuda(
            *args, valid, k=k, range_len=r, max_queries_per_block=1), want)


def test_quantized_maxsim_topk_kernel_takes_strided_pools_and_no_valid():
    dev = _card()
    table, q_mask, codes, d_mask = (a.to(dev) for a in _adc(
        3, 4, 8, 64, (4, 30), 20))
    sl = (slice(None), slice(7, 19))
    for valid in (None, torch.arange(30, device=dev).repeat(4, 1)[sl] % 3 > 0):
        got = qm.quantized_maxsim_topk_cuda(table, q_mask, codes[sl],
                                            d_mask[sl], valid, k=5,
                                            range_len=8)
        want = qm.quantized_maxsim_topk_plain(table, q_mask, codes[sl],
                                              d_mask[sl], valid, k=5,
                                              range_len=8)
        _assert_lists_match(got, want)


def test_quantized_maxsim_topk_kernel_refuses_bad_input():
    dev = _card()
    table, q_mask, codes, d_mask = (a.to(dev) for a in _adc(
        4, 2, 4, 16, (10,), 6))
    valid = torch.ones(10, dtype=torch.bool, device=dev)
    before = qm.launches
    for bad in (dict(codes=codes.int()), dict(d_mask=d_mask.float()),
                dict(valid=valid.float()), dict(valid=valid[None, :5]),
                dict(k=0), dict(range_len=512), dict(table=table.cpu()),
                dict(max_queries_per_block=3)):
        kw = dict(table=table, q_mask=q_mask, codes=codes, d_mask=d_mask,
                  valid=valid, k=3, range_len=8)
        kw.update(bad)
        with pytest.raises(ValueError):
            qm.quantized_maxsim_topk_cuda(
                kw.pop("table"), kw.pop("q_mask"), kw.pop("codes"),
                kw.pop("d_mask"), kw.pop("valid"), **kw)
    assert qm.launches == before


@pytest.mark.parametrize("per_query", [False, True])
def test_quantized_maxsim_sweep_is_one_launch_and_matches_the_cpu(per_query):
    """core.scan.quantized_maxsim_topk on the card (one launch, one merge)
    against the CPU's plain sweep, with doc_ids, valid and a carry."""
    dev = _card()
    g = torch.Generator().manual_seed(11 + per_query)
    b, n, md = 4, 700, 23
    lead = (b, n) if per_query else (n,)
    q = torch.randn((b, 6, 16), generator=g)
    cb = torch.randn((64, 16), generator=g)
    codes = torch.randint(0, 64, lead + (md,), generator=g).to(torch.uint8)
    q_mask = torch.rand((b, 6), generator=g) < 0.9
    d_mask = torch.rand(lead + (md,), generator=g) < 0.8
    d_mask[..., ::50, :] = False
    valid = torch.rand(lead, generator=g) > 0.1
    doc_ids = torch.randperm(5 * n, generator=g)[:valid.numel()].reshape(
        lead).to(torch.int32)
    carry = (torch.sort(torch.randn((b, 40), generator=g) + 3.0, dim=1,
                        descending=True)[0],
             torch.arange(40, dtype=torch.int32).repeat(b, 1) + 10 ** 6)
    kw = dict(k=40, doc_ids=doc_ids, valid=valid, carry=carry)
    want = scan.quantized_maxsim_topk(q, q_mask, codes, d_mask, cb,
                                      scan=scan.ScanConfig(block_docs=64),
                                      **kw)
    before = qm.launches
    got = scan.quantized_maxsim_topk(
        *(t.to(dev) for t in (q, q_mask, codes, d_mask, cb)), k=40,
        doc_ids=doc_ids.to(dev), valid=valid.to(dev),
        carry=tuple(t.to(dev) for t in carry))
    assert qm.launches == before + 1
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    bad = topk_mismatches(got[1].cpu().numpy(), got[0].cpu().numpy(),
                          want[1].numpy(), want[0].numpy(), TOL)
    assert not bad, f"ids differ outside near-ties at {bad}"


# -- hamming_maxsim and maxsim ------------------------------------------------

def _ham(seed, b, mq, lead, md, bits, dtype=torch.uint16, p_valid=0.8):
    g = torch.Generator().manual_seed(seed)
    q_codes = torch.randint(0, 2 ** bits, (b, mq), generator=g,
                            dtype=torch.int32)
    q_mask = (torch.rand((b, mq), generator=g) < 0.9).to(torch.int32)
    codes = torch.randint(0, 2 ** bits, lead + (md,), generator=g,
                          dtype=torch.int32).to(dtype)
    d_mask = torch.rand(lead + (md,), generator=g) < p_valid
    return q_codes, q_mask, codes, d_mask


@pytest.mark.parametrize("b,mq,n,md,bits", [
    (1, 4, 16, 8, 4), (3, 5, 33, 17, 8), (8, 32, 256, 615, 8),
    (2, 40, 50, 64, 9), (8, 32, 100, 615, 16), (64, 4, 40, 615, 9)])
@pytest.mark.parametrize("per_query", [False, True])
def test_hamming_maxsim_kernel_equals_plain(b, mq, n, md, bits, per_query):
    """Bit for bit, all-masked docs included (caveat C4's int32 form)."""
    dev = _card()
    lead = (b, n) if per_query else (n,)
    dtype = torch.uint8 if bits <= 8 else torch.uint16
    args = _ham(b + n + md + bits, b, mq, lead, md, bits, dtype)
    args[3][..., ::5, :] = False                       # all-masked docs
    want = hm.hamming_maxsim_plain(*args, bits)
    before = hm.launches
    got = hm.hamming_maxsim_cuda(*(a.to(dev) for a in args), bits)
    assert hm.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def test_hamming_maxsim_kernel_masks_codes_and_takes_strided_pools():
    dev = _card()
    q_codes, q_mask, codes, d_mask = (a.to(dev) for a in _ham(
        4, 4, 8, (4, 30), 20, 4, torch.uint16))
    wide = (codes.to(torch.int32) | (0x3A << 4)).to(torch.uint16)
    sl = (slice(None), slice(7, 19))
    got = hm.hamming_maxsim_cuda(q_codes, q_mask, wide[sl], d_mask[sl], 4)
    want = hm.hamming_maxsim_plain(q_codes, q_mask, codes[sl], d_mask[sl], 4)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        hm.hamming_maxsim_cuda(q_codes, q_mask, codes.int(), d_mask, 4)
    with pytest.raises(ValueError):
        hm.hamming_maxsim_cuda(q_codes, q_mask, codes, d_mask, 17)


def _flt(seed, b, mq, d, lead, md, p_valid=0.8):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, mq, d), generator=g)
    q_mask = (torch.rand((b, mq), generator=g) < 0.9).float()
    docs = torch.randn(lead + (md, d), generator=g)
    d_mask = torch.rand(lead + (md,), generator=g) < p_valid
    return q, q_mask, docs, d_mask


@pytest.mark.parametrize("b,mq,d,n,md", [(1, 4, 16, 16, 8), (3, 5, 30, 33, 17),
                                         (8, 32, 128, 64, 615),
                                         (2, 40, 64, 20, 130),
                                         (2, 16, 300, 12, 32),
                                         (64, 4, 128, 16, 1024)])
@pytest.mark.parametrize("per_query", [False, True])
def test_maxsim_kernel_matches_plain(b, mq, d, n, md, per_query):
    dev = _card()
    lead = (b, n) if per_query else (n,)
    args = _flt(b + n + md + d, b, mq, d, lead, md)
    args[3][..., ::5, :] = False                       # all-masked docs
    want = ms.maxsim_plain(*args)
    before = ms.launches
    got = ms.maxsim_cuda(*(a.to(dev) for a in args))
    assert ms.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=TOL, rtol=TOL)
    dead = got.cpu()[:, ::5]
    expect = (-1e30 * args[1].double().sum(dim=1))[:, None].expand_as(dead)
    assert torch.isfinite(dead).all()
    assert torch.allclose(dead.double(), expect, rtol=1e-5, atol=0)


def test_maxsim_kernel_takes_strided_pools_and_refuses_bad_input():
    dev = _card()
    q, q_mask, docs, d_mask = (a.to(dev) for a in _flt(
        5, 4, 8, 32, (4, 30), 20))
    sl = (slice(None), slice(7, 19))
    got = ms.maxsim_cuda(q, q_mask, docs[sl], d_mask[sl])
    want = ms.maxsim_plain(q, q_mask, docs[sl], d_mask[sl])
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    before = ms.launches
    with pytest.raises(ValueError):
        ms.maxsim_cuda(q, q_mask, docs.double(), d_mask)
    with pytest.raises(ValueError):
        ms.maxsim_cuda(q, q_mask, docs.transpose(2, 3), d_mask)
    with pytest.raises(ValueError):
        ms.maxsim_cuda(q.cpu(), q_mask.cpu(), docs.cpu(), d_mask.cpu())
    assert ms.launches == before


@pytest.mark.parametrize("block", [7, 256])
def test_float_and_hamming_scans_on_the_card_match_the_cpu(block):
    dev = _card()
    g = torch.Generator().manual_seed(block)
    q = torch.randn((3, 6, 16), generator=g)
    docs = torch.randn((300, 9, 16), generator=g)
    q_mask = torch.rand((3, 6), generator=g) < 0.9
    d_mask = torch.rand((300, 9), generator=g) < 0.8
    cfg = scan.ScanConfig(block_docs=block)
    want = scan.maxsim_topk(q, q_mask, docs, d_mask, k=10, scan=cfg)
    got = scan.maxsim_topk(*(a.to(dev) for a in (q, q_mask, docs, d_mask)),
                           k=10, scan=cfg)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    codes = torch.randint(0, 512, (300, 9), generator=g).to(torch.uint16)
    q_codes = torch.randint(0, 512, (3, 6), generator=g)
    want = scan.hamming_maxsim_topk(q_codes, q_mask, codes, d_mask, bits=9,
                                    k=10, scan=cfg)
    got = scan.hamming_maxsim_topk(*(a.to(dev) for a in (
        q_codes, q_mask, codes, d_mask)), bits=9, k=10, scan=cfg)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


# -- 3xTF32 kmeans_assign at small and edge shapes; maxsim over candidate rows

def _assert_codes_match(x, c, got, want, max_ties):
    """Codes equal except at most ``max_ties`` near-ties whose distances
    c2 - 2 x.c differ by <= 1e-4 in float64."""
    got, want = got.long(), want.long()
    rows = torch.nonzero(got != want)[:, 0]
    assert rows.numel() <= max_ties
    xd, cd = x[rows].double(), c.double()
    c2 = (cd * cd).sum(-1)

    def dist(kk):
        return c2[kk] - 2.0 * (xd * cd[kk]).sum(-1)

    assert torch.all((dist(got[rows]) - dist(want[rows])).abs() <= 1e-4)


@pytest.mark.parametrize("n,d,k,unit", [
    (256, 128, 256, True),      # a cascade batch's query codes
    (4096, 128, 512, True),     # K = 512: two 256-centroid chunks
    (3001, 128, 256, False),    # N not a multiple of the 64-row tile
    (200, 300, 1000, False),    # wide D, K in 32-centroid chunks
    (16384, 128, 64, True),     # ivf's routing assignment at ColPali width
    (512, 128, 64, True),       # ... and of an append of 512 docs
    (300, 32, 16, True)])       # the tests' K = 16
def test_kmeans_assign_kernel_at_cascade_and_edge_shapes(n, d, k, unit):
    dev = _card()
    g = torch.Generator().manual_seed(n + d + k)
    x = torch.randn((n, d), generator=g)
    c = torch.randn((k, d), generator=g)
    if unit:
        x = x / x.norm(dim=-1, keepdim=True)
        c = c / c.norm(dim=-1, keepdim=True)
    x, c = x.to(dev), c.to(dev)
    before = km.launches
    got = km.kmeans_assign_cuda(x, c)
    assert km.launches == before + 1 and got.dtype == torch.int32
    _assert_codes_match(x, c, got, km.kmeans_assign_plain(x, c),
                        max(1, n // 1000))


def _rows(seed, b, p, n_corpus, *, holes=True):
    """(B, P) int32 corpus positions with repeated ids and, with
    ``holes``, -1 slots."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, n_corpus, (b, p), generator=g, dtype=torch.int32)
    rows[:, 1::5] = rows[:, 0:1]                       # repeated ids
    if holes:
        rows[:, 2::7] = -1
    return rows


# (b, mq, d, corpus docs, md, candidates per query)
_ROWS_CASES = {
    "stage-3 shape": (8, 32, 128, 600, 615, 64),
    "ragged md": (3, 32, 128, 50, 77, 20),
    "mq 5": (3, 5, 128, 40, 33, 9),
    "mq 40": (2, 40, 64, 30, 130, 12),
    "d 30": (2, 16, 30, 25, 17, 11),
    "d 300": (2, 16, 300, 12, 32, 7),
}


@pytest.mark.parametrize("case", list(_ROWS_CASES))
def test_maxsim_rows_kernel_matches_plain(case):
    """Candidate rows read through their ids against the plain version's
    gather: live scores within TOL, all-masked docs sum_i qm_i * -1e30, -1
    slots NEG_INF."""
    dev = _card()
    b, mq, d, n, md, p = _ROWS_CASES[case]
    q, q_mask, docs, d_mask = _flt(len(case) + md, b, mq, d, (n,), md, 0.97)
    d_mask[::6] = False                                # all-masked docs
    rows = _rows(md, b, p, n)
    want = ms.maxsim_plain(q, q_mask, docs, d_mask, rows=rows)
    before = ms.launches
    got = ms.maxsim_cuda(*(a.to(dev) for a in (q, q_mask, docs, d_mask)),
                         rows=rows.to(dev)).cpu()
    assert ms.launches == before + 1
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert torch.all(got[rows < 0] == np.float32(-1e30))
    dead = (rows >= 0) & ~d_mask.any(dim=1)[rows.clamp(min=0).long()]
    expect = (-1e30 * q_mask.double().sum(dim=1))[:, None].expand_as(got)
    assert torch.allclose(got[dead].double(), expect[dead], rtol=1e-5, atol=0)
    # the same pools gathered, through the per-query layout
    safe = rows.clamp(min=0).long()
    pooled = ms.maxsim_cuda(*(a.to(dev) for a in (
        q, q_mask, docs[safe], d_mask[safe]))).cpu()
    live = rows >= 0
    torch.testing.assert_close(got[live], pooled[live], atol=TOL, rtol=TOL)


def test_maxsim_rows_kernel_never_reads_ids_past_the_corpus():
    dev = _card()
    q, q_mask, docs, d_mask = (a.to(dev) for a in _flt(
        6, 2, 8, 32, (10,), 20))
    rows = torch.tensor([[0, 10, 3, -1, 2 ** 30], [9, 9, 11, 1, -5]],
                        dtype=torch.int32, device=dev)
    got = ms.maxsim_cuda(q, q_mask, docs, d_mask, rows=rows).cpu()
    past = (rows >= 10).cpu()
    assert torch.isnan(got[past]).all() and not torch.isnan(got[~past]).any()
    want = ms.maxsim_plain(q, q_mask, docs, d_mask, rows=rows).cpu()
    assert torch.isnan(want[past]).all()
    torch.testing.assert_close(got[~past], want[~past], atol=TOL, rtol=TOL)
    # a strided slice of rows along P
    sl = rows[:, 1:4]
    torch.testing.assert_close(
        ms.maxsim_cuda(q, q_mask, docs, d_mask, rows=sl).cpu(),
        ms.maxsim_plain(q, q_mask, docs, d_mask, rows=sl).cpu(),
        atol=TOL, rtol=TOL, equal_nan=True)


def test_maxsim_rows_kernel_refuses_bad_rows():
    dev = _card()
    q, q_mask, docs, d_mask = (a.to(dev) for a in _flt(
        7, 2, 8, 32, (10,), 20))
    rows = _rows(7, 2, 6, 10).to(dev)
    before = ms.launches
    for bad in (rows.long(), rows.float(), rows[:1], rows[0], rows.cpu(),
                rows.t().contiguous().t()):            # inner stride 2
        with pytest.raises(ValueError):
            ms.maxsim_cuda(q, q_mask, docs, d_mask, rows=bad)
    with pytest.raises(ValueError):                    # rows need a corpus
        ms.maxsim_cuda(q, q_mask, docs[None].expand(2, -1, -1, -1),
                       d_mask[None].expand(2, -1, -1), rows=rows)
    assert ms.launches == before


def test_stage3_reads_candidates_by_id_on_the_card():
    """core.index.search_float_flat_candidates on the card: one maxsim
    launch over the rows (no gathered pool), equal to the CPU's plain
    gather path."""
    from repro_torch.core import index as index_mod
    dev = _card()
    q, q_mask, docs, d_mask = _flt(8, 4, 32, 64, (300,), 41, 0.97)
    cand = _rows(8, 4, 40, 300)
    ix = index_mod.build_float_flat(docs, d_mask)
    want = index_mod.search_float_flat_candidates(ix, q, q_mask > 0, cand,
                                                  k=16)
    ix_dev = index_mod.build_float_flat(docs.to(dev), d_mask.to(dev))
    before = ms.launches
    got = index_mod.search_float_flat_candidates(
        ix_dev, q.to(dev), (q_mask > 0).to(dev), cand.to(dev), k=16)
    assert ms.launches == before + 1
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    bad = topk_mismatches(got[1].cpu().numpy(), got[0].cpu().numpy(),
                          want[1].numpy(), want[0].numpy(), TOL)
    assert not bad, f"ids differ outside near-ties at {bad}"


# -- the segmented live index: maxsim's segment table, segmented sweeps,
# -- encode_delta

_SEG_CASES = {
    "1 segment": (40,),
    "2 segments": (30, 16),
    "5 segments, capacity-8": (16, 8, 8, 21, 8),
    "40 segments (two launches)": (8,) * 40,
}


@pytest.mark.parametrize("case", list(_SEG_CASES))
def test_maxsim_segment_table_matches_plain(case):
    """Stage 3's rows layout over a segmented corpus, read in place
    through the segment table: -1 slots (ids resolved to tombstones) score
    NEG_INF, positions in capacity-8 segments and in the last segment are
    read from their own segment, and the result equals the plain version
    (whose segment-by-segment gather equals the monolithic gather bit for
    bit). A corpus of more than MAX_SEGMENTS segments takes one launch per
    group of them."""
    dev = _card()
    caps = _SEG_CASES[case]
    n = sum(caps)
    q, q_mask, docs, d_mask = _flt(n, 8, 32, 128, (n,), 61, 0.97)
    d_mask[::9] = False                                # all-masked docs
    rows = _rows(n, 8, 24, n)
    rows[:, 3] = n - 1                                 # the last segment
    rows[:, 5] = caps[0] % n                           # the second's first
    cut = np.cumsum((0,) + caps)
    segs = tuple(docs[a:b].to(dev) for a, b in zip(cut[:-1], cut[1:]))
    masks = tuple(d_mask[a:b].to(dev) for a, b in zip(cut[:-1], cut[1:]))
    want = ms.maxsim_plain(q, q_mask, docs, d_mask, rows=rows)
    assert torch.equal(want, ms.maxsim_plain(
        q, q_mask, tuple(s.cpu() for s in segs),
        tuple(m.cpu() for m in masks), rows=rows))
    before = ms.launches
    got = ms.maxsim_cuda(q.to(dev), q_mask.to(dev), segs, masks,
                         rows=rows.to(dev)).cpu()
    assert ms.launches == before + -(-len(caps) // ms.MAX_SEGMENTS)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert torch.all(got[rows < 0] == np.float32(-1e30))
    # ids past every segment are never read
    past = rows.clone()
    past[:, 0] = n + 3
    got = ms.maxsim_cuda(q.to(dev), q_mask.to(dev), segs, masks,
                         rows=past.to(dev)).cpu()
    assert torch.isnan(got[:, 0]).all() and not torch.isnan(got[:, 1:]).any()


def test_segmented_cascade_stage3_reads_in_place_on_the_card():
    """search_float_flat_segmented_candidates on the card: one maxsim
    launch through the segment table (no pool gathered), dead ids never
    scored, equal to the CPU."""
    from repro_torch.core import index as index_mod
    dev = _card()
    q, q_mask, docs, d_mask = _flt(9, 4, 32, 64, (70,), 41, 0.97)
    ids = torch.arange(70, dtype=torch.int32)
    segs = [index_mod.make_float_flat_segment(docs[a:b], d_mask[a:b],
                                              ids[a:b])
            for a, b in ((0, 50), (50, 65), (65, 70))]
    live = [lv.clone() for _, lv in segs]
    live[0][7] = False                                 # a tombstone
    payloads = tuple(p for p, _ in segs)
    seg = index_mod.SegmentedState(
        payloads, tuple(live),
        index_mod.rebuild_pos_of_id(payloads, tuple(live), 128))
    cand = _rows(9, 4, 30, 72)                         # ids 70, 71 unknown
    cand[:, 4] = 7
    want = index_mod.search_float_flat_segmented_candidates(
        seg, q, q_mask > 0, cand, k=12)
    seg_dev = index_mod.SegmentedState(
        tuple(p._replace(embeddings=p.embeddings.to(dev),
                         mask=p.mask.to(dev), doc_ids=p.doc_ids.to(dev))
              for p in payloads), tuple(lv.to(dev) for lv in live),
        seg.pos_of_id.to(dev))
    before = ms.launches
    got = index_mod.search_float_flat_segmented_candidates(
        seg_dev, q.to(dev), (q_mask > 0).to(dev), cand.to(dev), k=12)
    assert ms.launches == before + 1
    assert 7 not in set(got[1].cpu().flatten().tolist())
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    bad = topk_mismatches(got[1].cpu().numpy(), got[0].cpu().numpy(),
                          want[1].numpy(), want[0].numpy(), TOL)
    assert not bad, f"ids differ outside near-ties at {bad}"


def test_segmented_flat_and_hamming_sweeps_match_the_cpu():
    """The segmented sweeps (capacity-8 segment with one ragged block,
    tombstones) on the card against the CPU's plain path: one ADC launch
    per segment, ceil(cap / block) Hamming launches per segment."""
    from repro_torch.core import index as index_mod
    dev = _card()
    g = torch.Generator().manual_seed(5)
    k_cb, md, mq = 64, 20, 8
    codebook = torch.randn((k_cb, 16), generator=g)
    q = torch.randn((3, mq, 16), generator=g)
    q_mask = torch.rand((3, mq), generator=g) < 0.9
    caps_n = ((300, None), (5, None), (40, None))
    flat_segs, ham_segs, lives = [], [], []
    start = 0
    for n, _ in caps_n:
        codes = torch.randint(0, k_cb, (n, md), generator=g).to(torch.uint8)
        mask = torch.rand((n, md), generator=g) < 0.8
        ids = torch.arange(start, start + n, dtype=torch.int32)
        fp, lv = index_mod.make_flat_segment(codes, mask, codebook, ids,
                                             cap=None if n != 300 else 300)
        hp, _ = index_mod.make_hamming_segment(codes, mask, 6, ids,
                                               cap=fp.codes.shape[0])
        lv = lv.clone()
        lv[1] = False                                  # a tombstone
        flat_segs.append(fp)
        ham_segs.append(hp)
        lives.append(lv)
        start += n
    assert [lv.shape[0] for lv in lives] == [300, 8, 64]

    def seg_state(payloads, device):
        moved = tuple(p._replace(**{f: getattr(p, f).to(device)
                                    for f in p._fields
                                    if isinstance(getattr(p, f),
                                                  torch.Tensor)})
                      for p in payloads)
        lv = tuple(x.to(device) for x in lives)
        return index_mod.SegmentedState(
            moved, lv, index_mod.rebuild_pos_of_id(moved, lv, 512))

    want = index_mod.search_flat_segmented(seg_state(flat_segs, "cpu"), q,
                                           q_mask, k=20)
    before = qm.launches
    got = index_mod.search_flat_segmented(seg_state(flat_segs, dev),
                                          q.to(dev), q_mask.to(dev), k=20)
    assert qm.launches == before + 3
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    bad = topk_mismatches(got[1].cpu().numpy(), got[0].cpu().numpy(),
                          want[1].numpy(), want[0].numpy(), TOL)
    assert not bad, f"ids differ outside near-ties at {bad}"

    q_codes = torch.randint(0, 64, (3, mq), generator=g)
    cfg = scan.ScanConfig(block_docs=256)
    want = index_mod.search_hamming_segmented(
        seg_state(ham_segs, "cpu"), q_codes, q_mask, bits=6, k=20, scan=cfg)
    before = hm.launches
    got = index_mod.search_hamming_segmented(
        seg_state(ham_segs, dev), q_codes.to(dev), q_mask.to(dev), bits=6,
        k=20, scan=cfg)
    assert hm.launches == before + 2 + 1 + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    dead = {1, 301, 306}
    assert not dead & set(got[1].cpu().flatten().tolist())


def test_encode_delta_through_the_kernel_matches_plain():
    from repro_torch.retrieval import Corpus, HPCConfig
    from repro_torch.retrieval.base import encode_delta
    dev = _card()
    g = torch.Generator().manual_seed(6)
    emb = torch.randn((37, 64, 128), generator=g)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    mask = torch.rand((37, 64), generator=g) < 0.95
    sal = torch.rand((37, 64), generator=g)
    codebook = torch.randn((256, 128), generator=g)
    codebook = codebook / codebook.norm(dim=-1, keepdim=True)
    cfg = HPCConfig(k=256, p=60.0, prune_side="doc")
    want = encode_delta(codebook, Corpus(emb, mask, sal), cfg)
    before = km.launches
    got = encode_delta(codebook.to(dev), Corpus(emb.to(dev), mask.to(dev),
                                                sal.to(dev)), cfg)
    assert km.launches == before + 1
    _assert_codes_match(emb.reshape(-1, 128), codebook,
                        got[0].cpu().reshape(-1), want[0].reshape(-1),
                        max_ties=3)
    # the same patches kept, so pruned codes differ only where full ones do
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].numpy())
    assert int((got[1].cpu() != want[1]).sum()) <= int(
        (got[0].cpu() != want[0]).sum())


# ---------------------------------------------------------------------------
# Slice 6: candidate positions past the corpus, the ANN routers, index files
# ---------------------------------------------------------------------------

def _small_corpus(seed, n=96, md=12, d=32):
    from repro_torch.data import synthetic
    spec = synthetic.CorpusSpec(n_docs=n, n_queries=8, n_patches=md,
                                n_q_patches=4, dim=d, n_topics=6)
    return synthetic.make_retrieval_corpus(spec, seed=seed, device="cpu")


def _cfg(backend, **kw):
    from repro_torch.retrieval import HNSWConfig, HPCConfig, IVFConfig
    return HPCConfig(k=32, p=60.0, backend=backend, kmeans_iters=6,
                     kmeans_restarts=2, rerank=16,
                     ivf=IVFConfig(n_list=8, n_probe=3, iters=5,
                                   bucket_cap=48),
                     hnsw=HNSWConfig(m=4, ef_construction=16, ef_search=32,
                                     levels=3), **kw)


def _built(backend, seed=0):
    """(retriever, CPU state, card state, CPU query, card query)."""
    from repro_torch import state_to
    from repro_torch.retrieval import Corpus, Query, Retriever
    dev = _card()
    d = _small_corpus(seed)
    r = Retriever(_cfg(backend))
    st = r.build(torch.Generator().manual_seed(seed),
                 Corpus(d.doc_patches, d.doc_mask, d.doc_salience))
    q = Query(d.query_patches, d.query_mask, d.query_salience)
    return r, st, state_to(st, dev), q, Query(*(a.to(dev) for a in q))


def _assert_search_match(got, want):
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    bad = topk_mismatches(got[1].cpu().numpy(), got[0].cpu().numpy(),
                          want[1].numpy(), want[0].numpy(), TOL)
    assert not bad, f"ids differ outside near-ties at {bad}"


def test_candidate_positions_past_the_corpus_on_the_card():
    """Positions N and N + 100 read doc N - 1, as the reference's clamped
    gather does, and leave the CUDA context usable: a second search in
    the same process succeeds."""
    for backend in ("flat", "float_flat", "hamming"):
        r, st, st_dev, q, q_dev = _built(backend)
        n = 96
        pool = torch.tensor([0, n - 1, n, n + 100, -1],
                            dtype=torch.int32).repeat(8, 1)
        want = r.backend.search_candidates(st, q, pool, k=5)
        got = r.backend.search_candidates(
            st_dev, q_dev, pool.to(q_dev.embeddings.device), k=5)
        torch.cuda.synchronize()
        assert torch.equal(got[1].cpu(), want[1]), backend
        if got[0].dtype == torch.int32:
            assert torch.equal(got[0].cpu(), want[0]), backend
        else:
            torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL,
                                       rtol=TOL)
        ids = got[1].cpu()
        assert int((ids == n - 1).sum(dim=1).min()) == 3, backend
        again = r.search(st_dev, q_dev, k=5)
        torch.cuda.synchronize()
        _assert_search_match(again, r.search(st, q, k=5))


@pytest.mark.parametrize("backend", ["ivf", "hnsw"])
def test_ann_search_on_the_card_matches_the_cpu(backend):
    """One search of the router on the card: one quantized_maxsim launch
    for its pool and one for the facade's rerank, results equal to the
    plain path; then the same after an add and a delete, and compacted."""
    from repro_torch import state_to
    from repro_torch.retrieval import Corpus
    r, st, st_dev, q, q_dev = _built(backend, seed=1)
    before = qm.launches
    got = r.search(st_dev, q_dev, k=10)
    assert qm.launches == before + 2
    _assert_search_match(got, r.search(st, q, k=10))
    d = _small_corpus(2, n=40)
    delta = Corpus(d.doc_patches, d.doc_mask, d.doc_salience)
    dev = q_dev.embeddings.device
    before = km.launches
    mut = r.delete(r.add(st_dev, Corpus(*(a.to(dev) for a in delta))),
                   np.array([3, 50, 101]))
    # the delta's codes, and for ivf its routing assignment
    assert km.launches == before + (2 if backend == "ivf" else 1)
    mut_cpu = state_to(mut, "cpu")
    _assert_search_match(r.search(mut, q_dev, k=10),
                         r.search(mut_cpu, q, k=10))
    comp = r.compact(mut)
    got = r.search(comp, q_dev, k=10)
    assert not {3, 50, 101} & set(got[1].cpu().flatten().tolist())
    _assert_search_match(got, r.search(state_to(comp, "cpu"), q, k=10))


def test_hnsw_walk_on_the_card_matches_the_cpu():
    """The batched walk (descent + beam) on the card gives the CPU's
    candidates (distances within 1e-5)."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.core.index import mean_pool
    r, st, st_dev, q, q_dev = _built("hnsw", seed=3)
    ix, ix_dev = st.backend_state.index, st_dev.backend_state.index
    want = graph_mod.hnsw_candidates(ix, mean_pool(q.embeddings, q.mask),
                                     ef_search=48)
    got = graph_mod.hnsw_candidates(
        ix_dev, mean_pool(q_dev.embeddings, q_dev.mask), ef_search=48)
    assert torch.equal(got[1].cpu(), want[1])
    fin = torch.isfinite(want[0])
    torch.testing.assert_close(got[0].cpu()[fin], want[0][fin], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("backend", ["flat", "cascade", "ivf", "hnsw"])
def test_index_file_round_trip_on_the_card(backend, tmp_path):
    """A card state saved and loaded onto the card searches the same bits;
    a file saved from the CPU loads onto the card and searches as the CPU
    state does."""
    from repro_torch import convert
    r, st, st_dev, q, q_dev = _built(backend, seed=4)
    mut = r.delete(st_dev, np.array([2, 9]))
    for state in (st_dev, mut):
        path = r.save(str(tmp_path / f"{backend}_dev"), state)
        loaded = r.load(path, device="cuda")
        for a, b in zip(convert.state_leaves(state),
                        convert.state_leaves(loaded)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert all(t.device.type == "cuda" for t in (
            loaded.codebook, loaded.rerank_codes))
        got, want = r.search(loaded, q_dev, k=10), r.search(state, q_dev,
                                                             k=10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    path = r.save(str(tmp_path / f"{backend}_cpu"), st)
    _assert_search_match(r.search(r.load(path), q_dev, k=10),
                         r.search(st, q, k=10))


def test_uint16_codes_gather_on_the_card():
    """CUDA's gather and scatter kernels have no uint16 instance: the
    Hamming member's candidate stages (monolithic and segmented), a K=512
    codebook's rerank rows and IVF buckets go through int16 views, and
    match the CPU."""
    from repro_torch import state_to
    from repro_torch.retrieval import Corpus, Query, Retriever
    dev = _card()
    d = _small_corpus(5, n=96, md=12, d=32)
    corpus = Corpus(d.doc_patches, d.doc_mask, d.doc_salience)
    q = Query(d.query_patches, d.query_mask, d.query_salience)
    q_dev = Query(*(a.to(dev) for a in q))
    pool = torch.randint(0, 96, (8, 20), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    pool[:, ::6] = -1
    r = Retriever(_cfg("hamming"))
    st = r.build(torch.Generator().manual_seed(0), corpus)
    seg = r.delete(r.add(st, corpus), np.array([4, 100]))
    for state in (st, seg):
        want = r.backend.search_candidates(state, q, pool, k=8)
        got = r.backend.search_candidates(state_to(state, dev), q_dev,
                                          pool.to(dev), k=8)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    for backend in ("flat", "ivf"):
        r = Retriever(dataclasses.replace(_cfg(backend), k=512))
        st = r.build(torch.Generator().manual_seed(0), corpus)
        assert st.rerank_codes.dtype == torch.uint16
        st_dev = state_to(st, dev)
        _assert_search_match(r.search(st_dev, q_dev, k=10),
                             r.search(st, q, k=10))
        mut = r.add(st_dev, Corpus(*(a[:10].to(dev) for a in corpus)))
        _assert_search_match(r.search(mut, q_dev, k=10),
                             r.search(state_to(mut, "cpu"), q, k=10))


# ---------------------------------------------------------------------------
# the encoder and the RAG path
# ---------------------------------------------------------------------------

def _cpu_copy(module, make):
    """A CPU module built by ``make`` holding ``module``'s weights."""
    cpu = make()
    cpu.load_state_dict(module.state_dict())
    return cpu


def test_encoder_cut_on_the_card_matches_the_cpu():
    """A 2-layer cut of the colpali-hpc encoder at full width, float32
    activations: one 256-patch page and a 32-token query on the card and
    on the CPU. Embeddings within 1e-4, salience / n_heads within 1e-6."""
    from repro_torch.configs import colpali_hpc
    from repro_torch.models import colpali
    dev = _card()
    full = colpali_hpc.COLPALI_HPC.config.encoder
    cfg = dataclasses.replace(full, backbone=dataclasses.replace(
        full.backbone, n_layers=2, activation_dtype="float32"))
    enc = colpali.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                       device=dev)
    cpu = _cpu_copy(enc, lambda: colpali.ColPaliEncoder(cfg, device="cpu"))
    g = torch.Generator().manual_seed(1)
    patches = torch.randn((1, 256, cfg.d_patch), generator=g)
    mask = torch.ones((1, 256), dtype=torch.bool)
    mask[0, 200:] = False
    tok = torch.randint(0, cfg.backbone.vocab, (1, 32), generator=g)
    tmask = torch.arange(32)[None] < 20
    heads = cfg.backbone.n_heads
    for fn, args in (("encode_doc", (patches, mask)),
                     ("encode_query", (tok, tmask))):
        e, s = getattr(enc, fn)(*(a.to(dev) for a in args))
        e_cpu, s_cpu = getattr(cpu, fn)(*args)
        torch.testing.assert_close(e.cpu(), e_cpu, atol=1e-4, rtol=0)
        torch.testing.assert_close(s.cpu() / heads, s_cpu / heads,
                                   atol=1e-6, rtol=0)


def test_cached_greedy_equals_uncached_on_the_card():
    """greedy_generate (prefill + cached decode steps) on the card gives
    the argmax of a full forward over the growing sequence at every step,
    and the CPU's tokens."""
    from repro_torch.core import rag
    from repro_torch.models import transformer as T
    dev = _card()
    cfg = T.LMConfig(n_layers=3, d_model=256, n_heads=8, n_kv_heads=2,
                     d_ff=512, vocab=1024, head_dim=32, qkv_bias=True,
                     rope_theta=1e6, q_chunk=16)
    model = T.init(cfg, generator=torch.Generator(dev).manual_seed(2),
                   device=dev)
    prompt = torch.randint(0, cfg.vocab, (6, 14),
                           generator=torch.Generator().manual_seed(3))
    got = rag.greedy_generate(model, prompt.to(dev), 5, 14)
    seq = prompt.to(dev)
    with torch.no_grad():
        for i in range(5):
            h, _, _ = model(seq)
            nxt = torch.argmax(model.logits(h[:, -1:])[:, 0], -1)
            assert torch.equal(nxt.to(torch.int32), got[:, i])
            seq = torch.cat([seq, nxt[:, None]], 1)
    cpu = _cpu_copy(model, lambda: T.Transformer(cfg, device="cpu"))
    assert torch.equal(rag.greedy_generate(cpu, prompt, 5, 14), got.cpu())


@pytest.mark.parametrize("backend", ["float_flat", "flat", "hamming"])
def test_rag_pipeline_on_the_card_matches_the_cpu(backend):
    """rag_pipeline over a small fact corpus: the same retrieved ids,
    prompts and tokens on the card (the kernels) as on the CPU (the plain
    path)."""
    from repro_torch import state_to
    from repro_torch.core import rag
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as T
    from repro_torch.retrieval import Corpus, HPCConfig, Retriever
    dev = _card()
    corpus, vocab = synthetic.make_fact_corpus(
        seed=4, n_docs=96, n_facts_vocab=60, facts_per_doc=3, dim=32,
        n_patches=12, n_queries=16, seq_len=8, device="cpu")
    cfg = HPCConfig(k=32 if backend == "flat" else 64, p=60.0,
                    backend=backend, rerank=8, kmeans_iters=8,
                    kmeans_restarts=2,
                    prune_side="none" if backend == "float_flat" else "doc")
    state = Retriever(cfg).build(torch.Generator().manual_seed(5), Corpus(
        corpus.doc_patches, corpus.doc_mask, corpus.doc_salience))
    lm = T.LMConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab=vocab["size"], q_chunk=8, qkv_bias=True)
    model = T.init(lm, generator=torch.Generator(dev).manual_seed(6),
                   device=dev)
    cpu_model = _cpu_copy(model, lambda: T.Transformer(lm, device="cpu"))
    rcfg = rag.RAGConfig(retriever=cfg, facts_per_doc=3,
                         fact0=vocab["fact0"], max_answer=3)
    dev_corpus = synthetic.FactCorpus(*(a.to(dev) for a in corpus))
    got = rag.retrieve_and_generate(state_to(state, dev), model, dev_corpus,
                                    rcfg, device=dev)
    want = rag.retrieve_and_generate(state, cpu_model, corpus, rcfg,
                                     device="cpu")
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.prompt.cpu(), want.prompt)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    m = rag.rag_pipeline(state_to(state, dev), model, dev_corpus, rcfg, 60,
                         device=dev)
    assert m == pytest.approx({**rag.rag_metrics(want, corpus, rcfg, 60),
                               **{k: m[k] for k in m if k.endswith("ms")}})


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

def _train_setup(which, dev, act="float32", n_layers=None, smoke=True):
    """(model on ``dev``, its train step, a batch maker) for the qwen2 LM
    or the colpali encoder of the repo's configs."""
    from repro_torch.configs import colpali_hpc, lm_archs
    from repro_torch.launch.train import colpali_batch
    from repro_torch.models import colpali
    from repro_torch.models import transformer as T
    gen = torch.Generator(dev).manual_seed(7)
    if which == "lm":
        spec = lm_archs.QWEN2_1_5B
        cfg = spec.smoke_config if smoke else spec.config
        cfg = dataclasses.replace(cfg, activation_dtype=act,
                                  n_layers=n_layers or cfg.n_layers)
        model = T.init(cfg, generator=gen, device=dev)

        def batch(g, b):
            tok = torch.randint(0, cfg.vocab, (b, 32), generator=g)
            return {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
        return model, T.train_step, batch
    arch = colpali_hpc.COLPALI_HPC
    enc = (arch.smoke_config if smoke else arch.config).encoder
    bb = dataclasses.replace(enc.backbone, activation_dtype=act,
                             n_layers=n_layers or enc.backbone.n_layers)
    enc = dataclasses.replace(enc, backbone=bb)
    model = colpali.init(enc, generator=gen, device=dev)
    return model, colpali.train_step, lambda g, b: colpali_batch(g, enc, b)


@pytest.mark.parametrize("which", ["lm", "colpali"])
def test_train_steps_on_the_card_match_the_cpu(which):
    """Two AdamW train steps (float32 activations, TF32 off) on the card
    and on a CPU copy: loss within 1e-5, grad norm within 1e-4 (sums in
    other orders); params: at most 0.1% of entries further apart than
    1e-5, none beyond 2 x the summed lr (an Adam step of a near-zero grad
    entry can take either sign)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    dev = _card()
    model, step, make = _train_setup(which, dev)
    cpu = _cpu_copy(model, lambda: type(model)(model.cfg, device="cpu"))
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=2)
    p_d, p_c = T.params_of(model), T.params_of(cpu)
    s_d, s_c = opt.init(ocfg, p_d), opt.init(ocfg, p_c)
    g = torch.Generator().manual_seed(8)
    sum_lr = 0.0
    for _ in range(2):
        b = make(g, 4)
        p_d, s_d, m_d = step(model, p_d, s_d,
                             {k: v.to(dev) for k, v in b.items()}, ocfg)
        p_c, s_c, m_c = step(cpu, p_c, s_c, b, ocfg)
        assert float(m_d["loss"]) == pytest.approx(float(m_c["loss"]),
                                                   rel=1e-5)
        assert float(m_d["grad_norm"]) == pytest.approx(
            float(m_c["grad_norm"]), rel=1e-4)
        sum_lr += float(m_c["lr"])
    err = torch.cat([(p_d[k].cpu() - p_c[k]).abs().reshape(-1)
                     for k in p_c])
    assert float((err > 1e-5).double().mean()) <= 1e-3
    assert float(err.max()) <= 2 * sum_lr
    assert int(s_d.step) == int(s_c.step) == 2


@pytest.mark.parametrize("which", ["lm", "colpali"])
def test_train_step_grads_ignore_the_bf16_flag(which, monkeypatch):
    """bf16 activations: the grads with PyTorch's bf16 reduced-precision
    flag set True before the step equal, bit for bit, those with it False:
    the step clears it across the forward, the backward and the
    recomputes, and restores it."""
    from repro_torch.models import colpali
    from repro_torch.models import transformer as T
    dev = _card()
    model, _, make = _train_setup(which, dev, act="bfloat16")
    b = {k: v.to(dev) for k, v in make(torch.Generator().manual_seed(9),
                                       4).items()}
    if which == "lm":
        def loss(p):
            return T.loss_fn(model, p, b["tokens"], b["targets"])
    else:
        def loss(p):
            return colpali.contrastive_loss(model, p, b)
    flag = torch.backends.cuda.matmul
    grads = {}
    for value in (True, False, True):
        monkeypatch.setattr(flag, "allow_bf16_reduced_precision_reduction",
                            value)
        _, _, g = T.value_and_grad(loss, T.params_of(model))
        assert flag.allow_bf16_reduced_precision_reduction is value
        grads.setdefault(value, []).append(g)
    for g in grads[True] + grads[False][1:]:
        assert all(torch.equal(g[k], grads[False][0][k]) for k in g)


def test_loop_resume_on_the_card_equals_an_uninterrupted_run(tmp_path):
    """The LM smoke config on the card: a run stopped at step 3 and
    resumed from its checkpoint to step 6 ends bit for bit where an
    uninterrupted 6-step run does."""
    import functools
    from repro_torch import convert
    from repro_torch.ckpt.checkpoint import leaves_with_paths
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    from repro_torch.train import loop as train_loop
    dev = _card()
    model, step, make = _train_setup("lm", dev)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    fn = functools.partial(step, model, opt_cfg=ocfg)
    batch = {k: v.to(dev) for k, v in make(torch.Generator().manual_seed(10),
                                           4).items()}

    def run(total, where):
        p = T.params_of(model)
        cfg = train_loop.LoopConfig(total_steps=total, ckpt_every=3,
                                    ckpt_dir=str(tmp_path / where),
                                    log_every=0)
        return train_loop.run(fn, p, opt.init(ocfg, p),
                              iter(lambda: batch, None), cfg,
                              log_fn=lambda *_: None)

    run(3, "a")
    resumed = run(6, "a")
    whole = run(6, "b")
    assert len(resumed["history"]) == 3
    assert resumed["params"]["embed"].device.type == dev.type
    got = convert.train_tree(resumed["params"], resumed["opt_state"])
    want = convert.train_tree(whole["params"], whole["opt_state"])
    for (k, a), (_, b) in zip(leaves_with_paths(got),
                              leaves_with_paths(want)):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_colpali_train_step_peak_memory_at_full_width():
    """A 2-layer cut of the colpali-hpc encoder at full width (bf16
    activations, 16 pages of 1024 patches and 16 queries): the step's peak
    memory stays under the reckoning of what it must hold:

      * params, grads, both moments, and the update's new params and
        moments: 28 B per parameter;
      * the update's temporaries for one tensor: 8 of the largest;
      * the block inputs the remat keeps (bf16), the page batch (float32);
      * one block recomputed in the backward: 6 bf16 FFN tensors (B, S,
        d_ff) and 6 float32 (B, H, q_chunk, S) score tensors of one
        query block.

    Without the per-block and per-query-block remat the two layers' score
    blocks and FFN tensors would all stay alive, about 2.5x the last
    item."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    dev = _card()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    model, step, make = _train_setup("colpali", dev, act="bfloat16",
                                     n_layers=2, smoke=False)
    enc, bb = model.cfg, model.cfg.backbone
    b, s = 16, enc.n_patches
    p = T.params_of(model)
    n = sum(t.numel() for t in p.values())
    largest = max(t.numel() for t in p.values()) * 4
    ocfg = opt.AdamWConfig()
    state = opt.init(ocfg, p)
    batch = {k: v.to(dev) for k, v in make(torch.Generator().manual_seed(11),
                                           b).items()}
    qc = min(bb.q_chunk, s)
    bound = (28 * n + 8 * largest
             + bb.n_layers * b * s * bb.d_model * 2 + b * s * enc.d_patch * 4
             + 6 * b * s * bb.d_ff * 2 + 6 * b * bb.n_heads * qc * s * 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p2, s2, m = step(model, p, state, batch, ocfg)
    torch.cuda.synchronize()
    # what this test holds at the step's peak: the model's params, the
    # moments, the batch and what the step allocates
    peak = torch.cuda.max_memory_allocated() - start
    print(f"peak {peak / 2**30:.2f} GiB of a {bound / 2**30:.2f} GiB bound")
    assert bool(torch.isfinite(m["loss"]))
    assert peak <= bound


# ---------------------------------------------------------------------------
# the MoE LM family on the card
# ---------------------------------------------------------------------------

_MOE_ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b")


def _moe_pair(arch, dev, **changes):
    """(smoke model on the card, its CPU copy) of a MoE arch, float32."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(registry.get(arch).smoke_config, **changes)
    model = T.init(cfg, generator=torch.Generator(dev).manual_seed(11),
                   device=dev)
    return model, _cpu_copy(model, lambda: T.Transformer(cfg, device="cpu"))


@pytest.mark.parametrize("arch", _MOE_ARCHS)
def test_moe_forward_and_decode_on_the_card_match_the_cpu(arch):
    """The smoke config's forward (hidden, aux, logits) over 2 x 32 tokens
    (llama4-scout's chunked layers in windows of 8) and a prefill of 12
    plus 4 decode steps, on the card and on a CPU copy: the same routing,
    so values within 1e-4."""
    from repro_torch.models import transformer as T
    dev = _card()
    model, cpu = _moe_pair(arch, dev)
    g = torch.Generator().manual_seed(12)
    tok = torch.randint(0, model.cfg.vocab, (2, 32), generator=g)
    with torch.no_grad():
        h, aux, _ = model(tok.to(dev))
        h_c, aux_c, _ = cpu(tok)
        torch.testing.assert_close(h.cpu(), h_c, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(model.logits(h).cpu(), cpu.logits(h_c),
                                   atol=1e-4, rtol=1e-4)
    assert float(aux) == pytest.approx(float(aux_c), rel=1e-5)
    logits, cache = T.prefill(model, tok[:, :12].to(dev), max_len=16)
    logits_c, cache_c = T.prefill(cpu, tok[:, :12], max_len=16)
    for i in range(4):
        torch.testing.assert_close(logits.cpu(), logits_c, atol=1e-4,
                                   rtol=1e-4)
        nxt = torch.argmax(logits_c, -1).to(torch.int32)
        logits, cache = T.decode_step(model, nxt.to(dev), cache, 12 + i)
        logits_c, cache_c = T.decode_step(cpu, nxt, cache_c, 12 + i)
    torch.testing.assert_close(cache.k.cpu(), cache_c.k, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", _MOE_ARCHS)
def test_moe_train_step_on_the_card_matches_the_cpu(arch):
    """One AdamW step of the smoke config on the card and on a CPU copy
    (float32, TF32 off): loss within 1e-5, grad norm within 1e-4, params
    at most 0.1% beyond 1e-5 and none beyond 2 x lr."""
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    dev = _card()
    model, cpu = _moe_pair(arch, dev)
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    b = make_lm_batch(torch.Generator().manual_seed(13), model.cfg.vocab,
                      4, 32)
    p_d, s_d, m_d = T.train_step(
        model, T.params_of(model), opt.init(ocfg, T.params_of(model)),
        {k: v.to(dev) for k, v in b.items()}, ocfg)
    p_c, s_c, m_c = T.train_step(cpu, T.params_of(cpu),
                                 opt.init(ocfg, T.params_of(cpu)), b, ocfg)
    for k in ("loss", "aux"):
        assert float(m_d[k]) == pytest.approx(float(m_c[k]), rel=1e-5), k
    assert float(m_d["grad_norm"]) == pytest.approx(float(m_c["grad_norm"]),
                                                    rel=1e-4)
    err = torch.cat([(p_d[k].cpu() - p_c[k]).abs().reshape(-1) for k in p_c])
    assert float((err > 1e-5).double().mean()) <= 1e-3
    assert float(err.max()) <= 2 * float(m_c["lr"])


def test_chunked_decode_across_a_window_edge_on_the_card():
    """llama4-scout's smoke config (windows of 8) with no drops: a prompt
    of 5 and 7 decode steps that cross the window edge at 8, in a cache
    of 16, on the card against the CPU and against the card's own
    teacher-forced forward (within 1e-4)."""
    from repro_torch.models import transformer as T
    dev = _card()
    model, cpu = _moe_pair("llama4-scout-17b-a16e", dev, capacity_factor=4.0)
    tok = torch.randint(0, model.cfg.vocab, (3, 5),
                        generator=torch.Generator().manual_seed(14))
    logits, cache = T.prefill(model, tok.to(dev), max_len=16)
    logits_c, cache_c = T.prefill(cpu, tok, max_len=16)
    seq = tok.to(dev)
    for i in range(7):
        torch.testing.assert_close(logits.cpu(), logits_c, atol=1e-4,
                                   rtol=1e-4)
        with torch.no_grad():
            ref = model.logits(model(seq)[0][:, -1:])[:, 0]
        torch.testing.assert_close(logits, ref, atol=1e-4, rtol=1e-4)
        nxt = torch.argmax(logits_c, -1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None].to(dev)], dim=1)
        logits, cache = T.decode_step(model, nxt.to(dev), cache, 5 + i)
        logits_c, cache_c = T.decode_step(cpu, nxt, cache_c, 5 + i)
    assert [blk.attn_chunk(16) for blk in model.blocks] == [8, 8, 8, 0]


# -- the recsys and GNN families: kmeans_assign at the tables' shapes, the
# fill rule of the lookups, and the smoke configs against the CPU ----------

@pytest.mark.parametrize("n,d,offset", [
    (4096, 16, 0),            # DCN-v2's tables: D = 16
    (3001, 16, 1),            # ... from an unaligned pointer
    (63488, 18, 0),           # the DIN/DIEN table: D % 4 != 0
    (3001, 18, 1),            # ... from an unaligned pointer
    (10_131_456, 16, 0)])     # DCN-v2's largest table
def test_kmeans_assign_kernel_at_the_recsys_tables(n, d, offset):
    """K = 256 codes of a table against the plain version: equal but for
    near-ties (at most 1 in 1000 rows, distances within 1e-4); an offset
    view takes the kernel's non-vector loads."""
    dev = _card()
    g = torch.Generator(dev).manual_seed(n + d + offset)
    buf = torch.randn((n * d + offset,), generator=g, device=dev) / d ** 0.5
    x = buf[offset:].view(n, d)
    c = torch.randn((256, d), generator=g, device=dev) / d ** 0.5
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(offset)
    before = km.launches
    got = km.kmeans_assign_cuda(x, c)
    assert km.launches == before + 1
    _assert_codes_match(x, c, got, km.kmeans_assign_plain(x, c),
                        max(1, n // 1000))


def test_take_rows_out_of_range_on_the_card():
    """Ids past either end of a table give the fill row, not a device
    assert: the next operation on the card still runs."""
    from repro_torch.models.layers import take_rows
    dev = _card()
    table = torch.arange(12, dtype=torch.float32, device=dev).reshape(6, 2)
    ids = torch.tensor([[0, 6, -1], [100, -7, 5]], device=dev)
    got = take_rows(table, ids)
    torch.cuda.synchronize()
    want = take_rows(table.cpu(), ids.cpu())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.isnan(got[0, 1]).all() and torch.equal(got[0, 2],
                                                        table[5])
    codes = take_rows(table.to(torch.uint8), ids)
    assert int(codes[1, 0, 0]) == 255
    assert float((table * 2).sum()) == 132.0


_FAMILIES = ("dlrm-mlperf", "dcn-v2", "din", "din-prune50", "dien",
             "pna-node", "pna-graph")


def _family_pair(name, dev):
    """(module, CPU copy, cfg, functions module, batch maker) of a smoke
    config, float32."""
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import gnn, recsys
    arch = name.split("-prune")[0].replace("-node", "").replace("-graph", "")
    cfg = registry.get(arch).smoke_config
    if name == "din-prune50":
        cfg = dataclasses.replace(cfg, din_prune_p=50.0)
    if name == "pna-graph":
        cfg = dataclasses.replace(cfg, d_feat=6, n_classes=2, task="graph")
    mod, cls = ((gnn, gnn.PNAModel) if arch == "pna"
                else (recsys, recsys.RecsysModel))
    model = mod.init(cfg, generator=torch.Generator(dev).manual_seed(15),
                     device=dev)
    cpu = _cpu_copy(model, lambda: cls(cfg, device="cpu"))

    def make(g):
        if name == "pna-node":
            return synthetic.make_graph(g, 200, 3200, cfg.d_feat,
                                        cfg.n_classes)
        if name == "pna-graph":
            return synthetic.make_molecule_batch(g, 16, 10, 20, 6)
        return synthetic.make_recsys_batch(g, 64, cfg.n_dense,
                                           cfg.table_rows, cfg.seq_len,
                                           cfg.family)
    return model, cpu, cfg, mod, make


@pytest.mark.parametrize("name", _FAMILIES)
def test_family_train_step_on_the_card_matches_the_cpu(name):
    """The smoke config's serve step and one AdamW step (float32, TF32
    off) on the card and on a CPU copy: outputs within 1e-5 (1e-4 for
    PNA, whose segment sums are atomics on the card), loss within 1e-5,
    grad norm within 1e-4, params at most 0.1% beyond 1e-5 and none
    beyond 2 x lr."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    dev = _card()
    model, cpu, cfg, mod, make = _family_pair(name, dev)
    b = make(torch.Generator().manual_seed(16))
    bd = {k: v.to(dev) for k, v in b.items()}
    tol = 1e-4 if name.startswith("pna") else 1e-5
    torch.testing.assert_close(
        mod.serve_step(T.params_of(model), bd, cfg).cpu(),
        mod.serve_step(T.params_of(cpu), b, cfg), atol=tol, rtol=tol)
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    p_d, s_d, m_d = mod.train_step(T.params_of(model), opt.init(
        ocfg, T.params_of(model)), bd, cfg, ocfg)
    p_c, s_c, m_c = mod.train_step(T.params_of(cpu), opt.init(
        ocfg, T.params_of(cpu)), b, cfg, ocfg)
    assert float(m_d["loss"]) == pytest.approx(float(m_c["loss"]), rel=1e-5)
    assert float(m_d["grad_norm"]) == pytest.approx(float(m_c["grad_norm"]),
                                                    rel=1e-4)
    err = torch.cat([(p_d[k].cpu() - p_c[k]).abs().reshape(-1) for k in p_c])
    assert float((err > 1e-5).double().mean()) <= 1e-3
    assert float(err.max()) <= 2 * float(m_c["lr"])


# ---------------------------------------------------------------------------
# distribution at world size 1: a one-rank NCCL group on the card
# ---------------------------------------------------------------------------

def _nccl_mesh():
    from repro_torch.launch import mesh as mesh_mod
    _card()
    mesh_mod.open_local_group("cuda")
    return mesh_mod.make_host_mesh((1, 1), device="cuda")


def test_sharded_search_on_the_card_matches_the_plain_version():
    """``sharded_search_fn`` over a one-rank NCCL mesh launches the
    ``quantized_maxsim`` kernel and agrees with the plain scan on the CPU:
    scores within 1e-4, ids outside near-ties; the reference's int32 codes
    and float masks give the same answer."""
    from repro_torch.core import distributed as D
    mesh = _nccl_mesh()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(31)
    n, md, k = 300, 24, 64
    q = torch.randn((5, 8, 16), generator=g)
    q_mask = torch.rand((5, 8), generator=g) < 0.9
    codes = torch.randint(0, k, (n, md), generator=g).to(torch.uint8)
    mask = torch.rand((n, md), generator=g) < 0.8
    ids = torch.arange(n, dtype=torch.int32) * 3
    cb = torch.randn((k, 16), generator=g)
    want = scan.quantized_maxsim_topk(q, q_mask, codes, mask, cb, k=20,
                                      doc_ids=ids,
                                      scan=scan.ScanConfig(impl="plain"))
    fn = D.sharded_search_fn(mesh, ("data", "model"), k=20)
    before = qm.launches
    got = fn(*(a.to(dev) for a in (q, q_mask, codes, mask, ids, cb)))
    assert qm.launches == before + 1
    _assert_search_match(got, want)
    ref = fn(*(a.to(dev) for a in (q, q_mask.float(), codes.int(),
                                   mask.float(), ids, cb)))
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])


def test_sharded_quantize_on_the_card_matches_kmeans_assign_plain():
    """``sharded_quantize`` launches ``kmeans_assign`` on the card: codes
    equal to the plain version's but for near-ties (distance gap <= 1e-4),
    for K = 256 (uint8) and K = 512 (uint16)."""
    from repro_torch.core import distributed as D
    mesh = _nccl_mesh()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(32)
    x = torch.randn((64, 20, 32), generator=g)
    for k, dtype in ((256, torch.uint8), (512, torch.uint16)):
        cb = torch.randn((k, 32), generator=g)
        before = km.launches
        got = D.sharded_quantize(mesh, x.to(dev), cb.to(dev), dtype)
        assert km.launches == before + 1 and got.dtype == dtype
        want = km.kmeans_assign_plain(x.reshape(-1, 32), cb)
        diff = torch.nonzero(got.cpu().reshape(-1).long() != want.long())[:, 0]
        xd, cd = x.reshape(-1, 32)[diff].double(), cb.double()
        c2 = (cd * cd).sum(-1)

        def dist(codes):
            return c2[codes] - 2.0 * (xd * cd[codes]).sum(-1)

        gap = (dist(got.cpu().reshape(-1)[diff].long())
               - dist(want[diff].long())).abs()
        assert diff.numel() <= 1e-3 * want.numel() and (gap <= 1e-4).all()


def test_uint16_shard_round_trip_over_nccl():
    """16-bit codes cross NCCL (which has no 16-bit integer) as a uint8
    view: placed, gathered and all-gathered back bit for bit. On one rank
    the port's helpers skip their collectives, so the view also goes
    through one NCCL all-gather of its own."""
    import torch.distributed as dist
    from repro_torch.dist import collectives, sharding
    mesh = _nccl_mesh()
    codes = torch.randint(0, 65536, (40, 7), generator=torch.Generator()
                          .manual_seed(33), dtype=torch.int32).to(
        torch.uint16).cuda()
    shd = sharding.Sharder(mesh)
    dt = sharding.distribute(codes, shd.named(("corpus", None), (40, 7)))
    assert dt.dtype == torch.uint16 and dt.to_local().is_cuda
    assert torch.equal(sharding.full_tensor(dt), codes)
    assert torch.equal(collectives.all_gather_axes(
        codes, mesh, ("data", "model")), codes)
    view = sharding._bytes_view(codes)
    assert view.dtype == torch.uint8
    out = torch.empty_like(view)
    dist.all_gather_into_tensor(out, view, group=mesh.get_group("data"))
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.uint16).squeeze(-1), codes)


def test_sharded_build_and_search_on_the_card():
    """``Retriever.build(mesh=)`` on a one-rank NCCL mesh quantizes through
    ``kmeans_assign``; ``shard`` + search equals the unsharded search of
    the same state."""
    from repro_torch.retrieval import Corpus, Query, Retriever
    mesh = _nccl_mesh()
    dev = torch.device("cuda")
    d = _small_corpus(34)
    corpus = Corpus(*(a.to(dev) for a in (d.doc_patches, d.doc_mask,
                                          d.doc_salience)))
    q = Query(*(a.to(dev) for a in (d.query_patches, d.query_mask,
                                    d.query_salience)))
    r = Retriever(_cfg("flat"))
    before = km.launches
    st = r.build(torch.Generator(device=dev).manual_seed(0), corpus,
                 mesh=mesh)
    assert km.launches > before
    want = r.search(st, q, k=10)
    got = r.search(r.shard(st, mesh), q, k=10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _launch_counts():
    return {"quantized_maxsim": qm.launches, "hamming_maxsim": hm.launches,
            "maxsim": ms.launches, "kmeans_assign": km.launches}


def _launched(fn):
    """fn()'s result and the kernels it launched."""
    before = _launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _launch_counts().items()}


def _sharded_case(backend, segmented, seed=5, k_codes=None):
    """(retriever, card state, its placement on a one-rank NCCL mesh, card
    query): monolithic, or after an add, an upsert and a delete."""
    from repro_torch.retrieval import Corpus, Retriever
    mesh = _nccl_mesh()
    r, st, st_dev, q, q_dev = _built(backend, seed=seed)
    if k_codes is not None:
        r = Retriever(dataclasses.replace(_cfg(backend), k=k_codes))
        d = _small_corpus(seed)
        dev = q_dev.embeddings.device
        st_dev = r.build(torch.Generator(device=dev).manual_seed(seed),
                         Corpus(*(a.to(dev) for a in (
                             d.doc_patches, d.doc_mask, d.doc_salience))))
    if segmented:
        d = _small_corpus(seed + 1, n=40)
        dev = q_dev.embeddings.device
        delta = Corpus(*(a.to(dev) for a in (d.doc_patches, d.doc_mask,
                                             d.doc_salience)))
        st_dev = r.add(st_dev, delta)
        st_dev = r.add(st_dev, Corpus(*(a[:3] for a in delta)),
                       doc_ids=[4, 30, 99])
        st_dev = r.delete(st_dev, np.array([3, 50, 101]))
    return r, st_dev, r.shard(st_dev, mesh), q_dev


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("backend", ["flat", "float_flat", "hamming", "ivf",
                                     "hnsw", "cascade"])
def test_sharded_search_equals_local_on_the_card(backend, segmented):
    """Every backend's state placed on a one-rank NCCL mesh searches as the
    unsharded state on the card, through the same kernels as often: a
    sweep's answer (float_flat, hamming without its rerank) bit for bit;
    where a candidate pool is scored by the full-score kernel (the
    rerank, the cascade's stages 2-3, the routers' pools) scores within
    1e-4 and ids outside near-ties."""
    r, st, sharded, q = _sharded_case(backend, segmented)
    want, n_want = _launched(lambda: r.search(st, q, k=10))
    got, n_got = _launched(lambda: r.search(sharded, q, k=10))
    assert n_got == n_want and sum(n_got.values()) > 0, (n_got, n_want)
    if backend == "float_flat":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        _assert_search_match(got, (want[0].cpu(), want[1].cpu()))
    sweep = r.backend.search(st, q, k=10)
    if backend in ("flat", "float_flat", "hamming"):   # shape (a) alone
        again = r.backend.search(sharded, q, k=10)
        assert torch.equal(again[0], sweep[0])
        assert torch.equal(again[1], sweep[1])


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("backend", ["flat", "float_flat", "hamming", "ivf",
                                     "hnsw", "cascade"])
def test_placed_mutation_equals_local_on_the_card(backend, segmented):
    """A state placed on a one-rank NCCL mesh given an add under fresh
    ids, upserts, deletes and a compaction: after each, still placed, and
    every mutation and search launches what the unplaced state's does;
    a sweep's answer (float_flat) bit for bit, the rest within 1e-4 with
    ids outside near-ties."""
    from torch.distributed.tensor import DTensor
    from repro_torch.retrieval import Corpus
    from repro_torch.retrieval.base import state_map
    r, st, placed, q = _sharded_case(backend, segmented, seed=8)
    d = _small_corpus(9, n=24)
    dev = q.embeddings.device
    delta = Corpus(*(a.to(dev) for a in (d.doc_patches, d.doc_mask,
                                         d.doc_salience)))
    steps = (lambda s: r.add(s, delta),
             lambda s: r.add(s, Corpus(*(a[:2] for a in delta)),
                             doc_ids=[7, 40]),
             lambda s: r.delete(s, np.array([2, 44, 97, 500])),
             lambda s: r.compact(s))
    for op in steps:
        st, n_want = _launched(lambda: op(st))
        placed, n_got = _launched(lambda: op(placed))
        assert n_got == n_want, (n_got, n_want)
        leaves = []
        state_map(leaves.append, placed)
        assert all(isinstance(x, DTensor) for x in leaves)
        want, n_want = _launched(lambda: r.search(st, q, k=10))
        got, n_got = _launched(lambda: r.search(placed, q, k=10))
        assert n_got == n_want and sum(n_got.values()) > 0, (n_got, n_want)
        if backend == "float_flat":
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        else:
            _assert_search_match(got, (want[0].cpu(), want[1].cpu()))


def test_sharded_hamming_k512_uint16_on_the_card():
    """A K = 512 codebook: 9-bit Hamming codes and uint16 rerank codes
    placed through their byte views; the sweep equal bit for bit, the
    reranked search within 1e-4, monolithic and segmented."""
    for segmented in (False, True):
        r, st, sharded, q = _sharded_case("hamming", segmented, seed=6,
                                          k_codes=512)
        assert sharded.rerank_codes.dtype == torch.uint16
        assert sharded.rerank_codes.to_local().dtype == torch.uint16
        got = r.backend.search(sharded, q, k=12)
        want = r.backend.search(st, q, k=12)
        assert got[0].dtype == torch.int32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        want = r.search(st, q, k=10)
        _assert_search_match(r.search(sharded, q, k=10),
                             (want[0].cpu(), want[1].cpu()))


@pytest.mark.parametrize("segmented", [False, True])
def test_sharded_cascade_rungs_on_the_card(segmented):
    """Every rung of the cascade's ladder on the placed state: the floor
    (the Hamming sweep alone, float32) bit for bit, the budget rungs
    within 1e-4; the floor launches no maxsim and no quantized_maxsim."""
    r, st, sharded, q = _sharded_case("cascade", segmented, seed=7)
    rungs = r.degrade_rungs(st, k=5)
    assert rungs[-1] is None
    for rung in rungs:
        want = r.search_degraded(st, q, k=5, rung=rung)
        got, n = _launched(lambda: r.search_degraded(sharded, q, k=5,
                                                     rung=rung))
        if rung is None:
            assert got[0].dtype == torch.float32
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            assert n["maxsim"] == n["quantized_maxsim"] == 0
            assert n["hamming_maxsim"] > 0 and n["kmeans_assign"] == 1
        else:
            _assert_search_match(got, (want[0].cpu(), want[1].cpu()))


# --- launch geometry and the dry run on the card ------------------------------

_GEOMETRY_EDGES = {
    "hpc_hamming_geometry": [(1, 1, 1), (3, 5, 8), (8, 257, 16),
                             (65535, 3, 8), (65536, 3, 8), (0, 5, 8)],
    "hpc_kmeans_assign_geometry": [(1, 128, 256, 132), (31, 18, 33, 132),
                                   (8447, 100, 4096, 132),
                                   (16_777_216, 128, 256, 132),
                                   (256, 1024, 512, 132), (5, 16, 32, 1)],
    "hpc_maxsim_geometry": [(0, 8, 32, 16384, 615, 128, 8, 132),
                            (0, 64, 257, 10, 16, 128, 8, 132),
                            (1, 3, 40, 100, 1, 130, 8, 132),
                            (2, 8, 32, 64, 1024, 128, 8, 132),
                            (0, 5, 5, 1, 615, 512, 1, 132)],
    "hpc_qmaxsim_geometry": [(1, 8, 32, 256, 16384, 615, 0, 256, 32, 2),
                             (2, 8, 32, 512, 300, 128, 0, 64, 10, 2),
                             (1, 8, 40, 256, 1024, 1024, 1, 256, 64, 2),
                             (1, 1, 5, 16, 1, 1, 0, 2, 1, 2),
                             (1, 64, 32, 256, 131072, 616, 0, 256, 128, 2),
                             (2, 8, 32, 4096, 256, 128, 0, 256, 0, 2),
                             (1, 8, 32, 256, 300, 16, 0, 257, 0, 2)],
}


def _py_geometry(name, args):
    from repro_torch.kernels import vmem
    try:
        if name == "hpc_qmaxsim_geometry":
            g = vmem.qmaxsim_geometry(*args[:6], bool(args[6]), *args[7:])
        else:
            g = {"hpc_hamming_geometry": vmem.hamming_geometry,
                 "hpc_kmeans_assign_geometry": vmem.kmeans_assign_geometry,
                 "hpc_maxsim_geometry": vmem.maxsim_geometry}[name](*args)
    except ValueError:
        return None
    return None if g is None else g.as_c()


@pytest.mark.parametrize("export", sorted(_GEOMETRY_EDGES))
def test_python_geometry_equals_the_library_at_edge_shapes(export):
    _card()
    from repro_torch.kernels import _build
    for args in _GEOMETRY_EDGES[export]:
        assert _py_geometry(export, args) == _build.c_geometry(export,
                                                               *args), args


def test_python_shared_bytes_equal_the_librarys_smem_exports():
    _card()
    from repro_torch.kernels import _build, vmem
    lib = _build.library()
    for cb, mq, k, md, r in [(1, 32, 256, 615, 256), (2, 40, 512, 16, 2),
                             (1, 5, 16, 1, 64), (2, 32, 4096, 128, 256)]:
        assert vmem.qmaxsim_smem_bytes(cb, mq, k, md, r) == \
            lib.hpc_qmaxsim_smem_bytes(cb, mq, k, md, r)
    for layout, b, mq, d in [(0, 8, 32, 128), (1, 8, 32, 128),
                             (2, 64, 257, 16), (0, 3, 5, 1024)]:
        assert vmem.maxsim_smem_bytes(layout, b, mq, d) == \
            lib.hpc_maxsim_smem_bytes(layout, b, mq, d)
    for d, k in [(128, 256), (16, 32), (18, 4096), (4096, 256)]:
        assert vmem.kmeans_assign_smem_bytes(d, k) == \
            lib.hpc_kmeans_assign_smem_bytes(d, k)


def _sites():
    from repro_torch.analysis import pallas_check as pc
    return [s.name for s in pc.kernel_sites()]


@pytest.mark.parametrize("site", _sites())
def test_pal03_on_the_card_every_output_written(site):
    """Each registered site launched once with its outputs filled with a
    sentinel (NaN, INT_MIN): none is left; the geometry equals the
    library's."""
    dev = _card()
    from repro_torch.analysis import pallas_check as pc
    from repro_torch.kernels import _build, vmem
    s = next(x for x in pc.kernel_sites() if x.name == site)
    budget = vmem.device_budget(dev)
    assert s.geometry(budget).as_c() == _build.c_geometry(s.c_call[0],
                                                          *s.c_call[1])
    r = pc.launch_site(s, dev)
    assert r["elements"] > 0 and r["unwritten"] == 0, r
    torch.cuda.empty_cache()


def test_registers_table_equals_the_build():
    _card()
    import json
    from repro_torch.analysis import pallas_check as pc
    from repro_torch.kernels import _build
    _build.library()
    log = _build.last_build.get("log") or ""
    if not _build.last_build.get("compiled"):
        import tempfile
        from pathlib import Path
        with tempfile.TemporaryDirectory() as tmp:
            log = _build._compile(_build._sources(),
                                  Path(tmp) / _build.LIB_NAME)
    from repro_torch.kernels import vmem
    table = json.loads(pc.REGISTERS_JSON.read_text())["registers"]
    assert _build.registers(log) == table
    assert pc.check_all(budget=vmem.device_budget(), registers=table) == []


def test_dry_run_peak_held_to_the_card_dcn_serve_bulk():
    """One recsys cell: the fake trace's peak above its arguments within
    10% or 256 MiB of the card's (max_memory_allocated above what was held
    after reset_peak_memory_stats), and its FLOPs equal to the real run's
    (chip_smoke.py phase 14's band)."""
    dev = _card()
    from repro_torch.configs import registry
    from repro_torch.launch import cells, dryrun
    spec = registry.get("dcn-v2")
    cell = next(c for c in spec.shapes if c.name == "serve_bulk")
    pred = dryrun.trace_cell(spec, cell, device=dev)
    torch.cuda.empty_cache()
    built = cells.build_cell(spec, cell, device=dev, fake=False, seed=2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out, flops = dryrun.real_flops(lambda: built.fn(*built.args))
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - held
    assert tuple(out.shape) == (cell.dims["batch"],)
    band = max(0.10 * measured, 256 * 2 ** 20)
    assert abs(pred["peak_above_args"] - measured) <= band, \
        (pred["peak_above_args"], measured)
    assert pred["flops"] == flops
    del built, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# model-internal sharding at world size 1: each family's smoke model placed
# on a one-rank NCCL mesh against the same model unsharded
# ---------------------------------------------------------------------------

def _same_on_card(got, want, tol, what):
    from repro_torch.dist.sharding import full_tensor
    got = full_tensor(got)
    assert got.device.type == "cuda" and got.shape == want.shape, what
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=what)


@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "llama4-scout-17b-a16e",
                                     "kimi-k2-1t-a32b"])
def test_lm_smoke_sharded_on_one_rank_equals_unsharded(arch_id):
    """A train step (kimi-k2 with int8 moments), the forward, prefill and
    two decode steps with params, optimizer state, caches and tokens
    placed by their specs: within 2e-5 (forward) and 5e-5 (params)."""
    mesh = _nccl_mesh()
    from repro_torch.configs import registry
    from repro_torch.dist.sharding import Sharder, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    shd = Sharder(mesh)
    cfg = registry.get(arch_id).smoke_config
    gen = torch.Generator("cuda").manual_seed(5)
    model = T.init(cfg, generator=gen, device="cuda")
    params = T.params_of(model)
    specs = T.param_specs(cfg)
    tok = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device="cuda")
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    ocfg = opt.AdamWConfig(moment_dtype="int8" if "kimi" in arch_id
                           else "fp32")
    st = opt.init(ocfg, params)
    p0, _, m0 = T.train_step(model, params, st, batch, ocfg)
    p1, _, m1 = T.train_step(
        model, shard_tree(shd, specs, params),
        shard_tree(shd, opt.state_specs(specs, ocfg), st),
        shard_tree(shd, T.batch_specs(), batch), ocfg, shd=shd)
    _same_on_card(m1["loss"], m0["loss"], 2e-5, "loss")
    for name in p0:
        _same_on_card(p1[name], p0[name], 5e-5, name)
    h0, _, _ = model(tok)
    lg0, c0 = T.prefill(model, tok[:, :12], 16)
    placed = T.shard_module(T.init(cfg, generator=torch.Generator(
        "cuda").manual_seed(5), device="cuda"), shd, specs)
    dtok = shard_tree(shd, ("batch", None), tok)
    h1, _, _ = placed(dtok, shd=shd)
    _same_on_card(h1, h0, 2e-5, "forward")
    lg1, c1 = T.prefill(placed, dtok[:, :12], 16, shd=shd)
    _same_on_card(lg1, lg0, 2e-5, "prefill")
    for i in range(2):
        feed = torch.argmax(lg0, -1).to(torch.int32)
        lg0, c0 = T.decode_step(model, feed, c0, 12 + i)
        lg1, c1 = T.decode_step(placed, shard_tree(shd, ("batch",), feed),
                                c1, 12 + i, shd=shd)
        _same_on_card(lg1, lg0, 2e-5, f"decode {i}")
    _same_on_card(c1.k, c0.k, 2e-5, "cache k")


def test_colpali_smoke_sharded_on_one_rank_equals_unsharded():
    """Both encoders and a contrastive train step, placed."""
    mesh = _nccl_mesh()
    from repro_torch.configs.colpali_hpc import COLPALI_HPC
    from repro_torch.dist.sharding import Sharder, shard_tree
    from repro_torch.models import colpali
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    shd = Sharder(mesh)
    cfg = COLPALI_HPC.smoke_config.encoder
    gen = torch.Generator("cuda").manual_seed(6)
    enc = colpali.init(cfg, generator=gen, device="cuda")
    b = 4
    batch = {"query_tokens": torch.randint(0, cfg.backbone.vocab,
                                           (b, cfg.query_len), generator=gen,
                                           device="cuda"),
             "query_mask": torch.ones((b, cfg.query_len), dtype=torch.bool,
                                      device="cuda"),
             "doc_patches": torch.randn((b, cfg.n_patches, cfg.d_patch),
                                        generator=gen, device="cuda"),
             "doc_mask": torch.ones((b, cfg.n_patches), dtype=torch.bool,
                                    device="cuda")}
    specs = colpali.param_specs(cfg)
    params = T.params_of(enc)
    ocfg = opt.AdamWConfig()
    st = opt.init(ocfg, params)
    p0, _, m0 = colpali.train_step(enc, params, st, batch, ocfg)
    db = shard_tree(shd, colpali.batch_specs(), batch)
    p1, _, m1 = colpali.train_step(
        enc, shard_tree(shd, specs, params),
        shard_tree(shd, opt.state_specs(specs, ocfg), st), db, ocfg, shd=shd)
    _same_on_card(m1["loss"], m0["loss"], 2e-5, "loss")
    for name in p0:
        _same_on_card(p1[name], p0[name], 5e-5, name)
    e0, s0 = enc.encode_doc(batch["doc_patches"], batch["doc_mask"])
    q0, _ = enc.encode_query(batch["query_tokens"], batch["query_mask"])
    T.shard_module(enc, shd, specs)
    e1, s1 = enc.encode_doc(db["doc_patches"], db["doc_mask"], shd=shd)
    q1, _ = enc.encode_query(db["query_tokens"], db["query_mask"], shd=shd)
    _same_on_card(e1, e0, 2e-5, "encode_doc")
    _same_on_card(s1, s0, 2e-5, "salience")
    _same_on_card(q1, q0, 2e-5, "encode_query")


@pytest.mark.parametrize("arch_id,cell_name", [
    ("dlrm-mlperf", "train_batch"), ("dcn-v2", "train_batch"),
    ("din", "train_batch"), ("dien", "serve_p99"),
    ("dcn-v2", "retrieval_cand"), ("pna", "full_graph_sm")])
def test_cell_smoke_sharded_on_one_rank_equals_unsharded(arch_id,
                                                         cell_name):
    """``launch.cells.build_cell`` of a recsys or PNA cell at the smoke
    config, without and with the mesh from one seed: the placed step
    (train: loss and new params; serve and candidates: the scores) equal
    to the unplaced one within 2e-5 (PNA's params 5e-5: its segment sums
    are float atomics)."""
    mesh = _nccl_mesh()
    from repro_torch.configs import registry
    from repro_torch.launch import cells
    spec = registry.get(arch_id)
    cell = next(c for c in spec.shapes if c.name == cell_name)
    outs = []
    for m in (None, mesh):
        built = cells.build_cell(spec, cell, m, smoke=True, device="cuda",
                                 fake=False, seed=7)
        outs.append(built.fn(*built.args))
        assert set(built.placements) >= {"mesh", "device", "params"}
    if cell.kind != "train":
        _same_on_card(outs[1], outs[0], 2e-5, cell_name)
        return
    (p0, _, m0), (p1, _, m1) = outs
    _same_on_card(m1["loss"], m0["loss"], 2e-5, "loss")
    for name in p0:
        _same_on_card(p1[name], p0[name], 5e-5, name)

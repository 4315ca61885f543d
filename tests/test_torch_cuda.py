"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips, inside its body, on a host without a
CUDA device. This file imports no JAX (the card's host has none), so it
runs there on its own:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import scan
from repro_torch.kernels import kmeans_assign as km
from repro_torch.kernels import ops
from repro_torch.kernels import quantized_maxsim as qm

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

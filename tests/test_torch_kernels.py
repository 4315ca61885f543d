"""The port's kernel modules against the Pallas kernels (interpret mode).

The plain PyTorch versions stand beside the CUDA kernels and are what the
port runs for CPU tensors, so they are held to the TPU kernels here on the
same numpy inputs. The CUDA kernels themselves are held to the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import late_interaction as jax_li
from repro.kernels import ops as jax_ops
from repro.kernels.quantized_maxsim import quantized_maxsim_pallas
from repro_torch.core import late_interaction as li
from repro_torch.core.scan import resolve_impl
from repro_torch.kernels import hamming as hm
from repro_torch.kernels import kmeans_assign as km
from repro_torch.kernels import maxsim as ms
from repro_torch.kernels import ops
from repro_torch.kernels import quantized_maxsim as qm
from tests._torch_parity import code_gaps, to_torch

SHAPES = [  # (B, Mq, D, N, Md), as tests/test_kernels.py:11-16
    (1, 4, 16, 16, 8),
    (2, 8, 32, 48, 10),
    (3, 5, 64, 64, 17),
    (2, 16, 128, 32, 32),
]
TOL = 1e-4  # as tests/test_kernels.py:50; f32 sums in another order


def _adc_inputs(shape, k, seed, per_query=False):
    b, mq, d, n, md = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    lead = (b, n) if per_query else (n,)
    codes = rng.integers(0, k, lead + (md,)).astype(np.uint8)
    qmask = (rng.random((b, mq)) > 0.2).astype(np.float32)
    dmask = rng.random(lead + (md,)) > 0.2
    table = np.asarray(jax_li.adc_table(jnp.asarray(q), jnp.asarray(cb)))
    return q, cb, table, qmask, codes, dmask


def _pallas(table, qmask, codes, dmask):
    return np.asarray(quantized_maxsim_pallas(
        table, qmask, codes.astype(np.int32), dmask.astype(np.float32),
        block_docs=16, interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [16, 256])
def test_quantized_maxsim_plain_matches_pallas(shape, k):
    _, _, table, qmask, codes, dmask = _adc_inputs(shape, k, sum(shape) + k)
    want = _pallas(table, qmask, codes, dmask)
    got = qm.quantized_maxsim_plain(*to_torch(table, qmask, codes, dmask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantized_maxsim_plain_per_query_matches_pallas(shape):
    """(B, P, Md) pools: one Pallas call per query b against its own pool."""
    _, _, table, qmask, codes, dmask = _adc_inputs(shape, 256, sum(shape),
                                                   per_query=True)
    want = np.concatenate([
        _pallas(table[i:i + 1], qmask[i:i + 1], codes[i], dmask[i])
        for i in range(shape[0])])
    got = qm.quantized_maxsim_plain(*to_torch(table, qmask, codes, dmask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("per_query", [False, True])
def test_quantized_maxsim_plain_all_masked_docs(per_query):
    """An all-masked doc scores sum_i qm_i * -1e30, as the TPU kernel."""
    _, _, table, qmask, codes, dmask = _adc_inputs(SHAPES[1], 16, 7,
                                                   per_query=per_query)
    dmask[..., ::3, :] = False
    if per_query:
        want = np.concatenate([
            _pallas(table[i:i + 1], qmask[i:i + 1], codes[i], dmask[i])
            for i in range(table.shape[0])])
    else:
        want = _pallas(table, qmask, codes, dmask)
    got = qm.quantized_maxsim_plain(*to_torch(table, qmask, codes,
                                              dmask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    dead = got[:, ::3]
    np.testing.assert_allclose(
        dead, np.broadcast_to(li.NEG_INF * qmask.sum(1)[:, None], dead.shape),
        rtol=1e-5)


@pytest.mark.parametrize("n,d,k", [(64, 16, 8), (100, 32, 16), (256, 128, 64),
                                   (130, 8, 4)])  # tests/test_kernels.py:70-71
def test_kmeans_assign_plain_matches_pallas(n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    want = np.asarray(jax_ops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                            impl="interpret", block_n=32))
    got = km.kmeans_assign_plain(*to_torch(x, c))
    assert got.dtype == torch.int32
    got = got.numpy()
    assert float(np.mean(got == want)) >= 0.99
    assert np.all(code_gaps(x, c, got, want) <= 1e-4)


def test_ops_auto_dispatches_cpu_tensors_to_plain():
    shape = SHAPES[2]
    q, cb, _, qmask, codes, dmask = _adc_inputs(shape, 64, 3)
    tq, tcb, tqm, tc, tdm = to_torch(q, cb, qmask > 0, codes, dmask)
    got = ops.quantized_maxsim(tq, tqm, tc, tdm, tcb)
    want = jax_li.quantized_maxsim(jnp.asarray(q), jnp.asarray(qmask > 0),
                                   jnp.asarray(codes), jnp.asarray(dmask),
                                   jnp.asarray(cb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (40, 64)).astype(np.float32))
    np.testing.assert_array_equal(ops.kmeans_assign(x, tcb).numpy(),
                                  km.kmeans_assign_plain(x, tcb).numpy())


def test_dispatch_follows_the_tensor_device():
    assert resolve_impl("auto", "cpu") == "plain"
    assert resolve_impl("auto", torch.device("cuda", 0)) == "cuda"
    assert resolve_impl("plain", "cuda") == "plain"
    for bad in ("cuda", "interpret", "pallas", "jnp", "triton"):
        with pytest.raises(ValueError):
            resolve_impl(bad, "cpu")


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel launch: the wrappers raise."""
    counts = (qm.launches, km.launches, hm.launches, ms.launches)
    _, cb, table, qmask, codes, dmask = _adc_inputs(SHAPES[0], 16, 1)
    args = to_torch(table, qmask, codes, dmask)
    with pytest.raises(ValueError, match="CUDA"):
        qm.quantized_maxsim_cuda(*args)
    x = torch.zeros((4, cb.shape[1]))
    with pytest.raises(ValueError, match="CUDA"):
        km.kmeans_assign_cuda(x, torch.from_numpy(cb))
    qc, qmi, dc, dm = to_torch(*_hamming_inputs(SHAPES[0], 8, 1))
    with pytest.raises(ValueError, match="CUDA"):
        hm.hamming_maxsim_cuda(qc.int(), qmi.int(), dc, dm, 8)
    q, qmf, docs, dmf = to_torch(*_float_inputs(SHAPES[0], 1))
    with pytest.raises(ValueError, match="CUDA"):
        ms.maxsim_cuda(q, qmf.float(), docs, dmf)
    assert (qm.launches, km.launches, hm.launches, ms.launches) == counts


# -- binary (Hamming) MaxSim --------------------------------------------------

def _hamming_inputs(shape, bits, seed, per_query=False):
    """Codes over the full 2^bits range (uint16 past 8 bits, as the
    HammingIndex stores them); every doc keeps a valid patch."""
    b, mq, _, n, md = shape
    rng = np.random.default_rng(seed)
    lead = (b, n) if per_query else (n,)
    dtype = np.uint8 if bits <= 8 else np.uint16
    qc = rng.integers(0, 2 ** bits, (b, mq)).astype(dtype)
    dc = rng.integers(0, 2 ** bits, lead + (md,)).astype(dtype)
    qmask = rng.random((b, mq)) > 0.3
    dmask = rng.random(lead + (md,)) > 0.3
    dmask[..., 0] = True
    return qc, qmask, dc, dmask


def _jax_hamming(qc, qmask, dc, dmask, bits):
    return np.asarray(jax_ops.hamming_maxsim(
        jnp.asarray(qc.astype(np.int32)), jnp.asarray(qmask),
        jnp.asarray(dc.astype(np.int32)), jnp.asarray(dmask), bits=bits,
        impl="interpret", block_docs=16))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 9])
def test_hamming_maxsim_plain_matches_pallas(shape, bits):
    """Exact: every score is a small integer on both sides."""
    qc, qmask, dc, dmask = _hamming_inputs(shape, bits, sum(shape) + bits)
    want = _jax_hamming(qc, qmask, dc, dmask, bits)
    got = hm.hamming_maxsim_plain(*to_torch(qc, qmask, dc, dmask), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    via_ops = ops.hamming_maxsim(*to_torch(qc, qmask, dc, dmask), bits=bits)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_hamming_maxsim_plain_per_query_matches_pallas():
    shape = SHAPES[2]
    qc, qmask, dc, dmask = _hamming_inputs(shape, 9, 5, per_query=True)
    want = np.concatenate([
        _jax_hamming(qc[i:i + 1], qmask[i:i + 1], dc[i], dmask[i], 9)
        for i in range(shape[0])])
    got = hm.hamming_maxsim_plain(*to_torch(qc, qmask, dc, dmask), 9)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("per_query", [False, True])
def test_hamming_maxsim_plain_all_masked_docs_follow_binary_maxsim(per_query):
    """Caveat C4: an all-masked doc scores sum_i qm_i * -(2**20) in int32,
    as the reference's jnp li.binary_maxsim (its Pallas kernel gives
    sum_i qm_i * -1e30 in f32 instead)."""
    shape, bits = SHAPES[1], 8
    qc, qmask, dc, dmask = _hamming_inputs(shape, bits, 3, per_query)
    dmask[..., ::4, :] = False
    got = hm.hamming_maxsim_plain(*to_torch(qc, qmask, dc, dmask), bits)
    if per_query:
        want = np.concatenate([np.asarray(jax_li.binary_maxsim(
            *map(jnp.asarray, (qc[i:i + 1], qmask[i:i + 1], dc[i],
                               dmask[i])), bits)) for i in range(shape[0])])
    else:
        want = np.asarray(jax_li.binary_maxsim(
            *map(jnp.asarray, (qc, qmask, dc, dmask)), bits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy()[:, ::4],
        np.broadcast_to(-(2 ** 20) * qmask.sum(1)[:, None],
                        got[:, ::4].shape))


def test_hamming_maxsim_masks_codes_to_bits():
    """Codes at or above 2^bits are read through the low ``bits`` bits,
    not treated as out of range."""
    qc, qmask, dc, dmask = _hamming_inputs(SHAPES[1], 4, 9)
    wide = (dc.astype(np.uint16) | (np.uint16(0x5A) << 4)).astype(np.uint16)
    got = hm.hamming_maxsim_plain(*to_torch(qc, qmask, wide, dmask), 4)
    want = hm.hamming_maxsim_plain(*to_torch(qc, qmask, dc, dmask), 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- float MaxSim -------------------------------------------------------------

def _float_inputs(shape, seed, per_query=False):
    b, mq, d, n, md = shape
    rng = np.random.default_rng(seed)
    lead = (b, n) if per_query else (n,)
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    docs = rng.standard_normal(lead + (md, d)).astype(np.float32)
    qmask = rng.random((b, mq)) > 0.2
    dmask = rng.random(lead + (md,)) > 0.2
    return q, qmask, docs, dmask


def _jax_maxsim(q, qmask, docs, dmask):
    return np.asarray(jax_ops.maxsim(*map(jnp.asarray, (q, qmask, docs,
                                                        dmask)),
                                     impl="interpret", block_docs=16))


@pytest.mark.parametrize("shape", SHAPES)
def test_maxsim_plain_matches_pallas(shape):
    q, qmask, docs, dmask = _float_inputs(shape, sum(shape))
    dmask[::5] = False                                   # all-masked docs
    want = _jax_maxsim(q, qmask, docs, dmask)
    got = ms.maxsim_plain(*to_torch(q, qmask.astype(np.float32), docs,
                                    dmask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    via_ops = ops.maxsim(*to_torch(q, qmask, docs, dmask))
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_maxsim_plain_per_query_matches_pallas():
    shape = SHAPES[2]
    q, qmask, docs, dmask = _float_inputs(shape, 4, per_query=True)
    want = np.concatenate([
        _jax_maxsim(q[i:i + 1], qmask[i:i + 1], docs[i], dmask[i])
        for i in range(shape[0])])
    got = ms.maxsim_plain(*to_torch(q, qmask.astype(np.float32), docs,
                                    dmask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fn", ["maxsim", "quantized_maxsim",
                                "quantized_maxsim_decode",
                                "single_vector_score", "binary_maxsim"])
def test_late_interaction_matches_jax(fn):
    rng = np.random.default_rng(11)
    b, mq, d, n, md, k = 2, 6, 16, 24, 9, 32
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    qmask = rng.random((b, mq)) > 0.2
    dmask = rng.random((n, md)) > 0.2
    dmask[3] = False                      # one all-masked doc
    if fn in ("maxsim", "single_vector_score"):
        docs = rng.standard_normal((n, md, d)).astype(np.float32)
    else:
        docs = rng.integers(0, k, (n, md)).astype(np.uint8)
    if fn == "binary_maxsim":
        q = rng.integers(0, k, (b, mq)).astype(np.uint8)
    arrays = (q, qmask, docs, dmask) + (
        () if fn in ("maxsim", "single_vector_score", "binary_maxsim")
        else (cb,))
    bits = (5,) if fn == "binary_maxsim" else ()
    want = getattr(jax_li, fn)(*map(jnp.asarray, arrays), *bits)
    got = getattr(li, fn)(*to_torch(*arrays), *bits)
    if fn == "binary_maxsim":                # exact int32, C4 included
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if fn == "quantized_maxsim":
        np.testing.assert_allclose(
            li.adc_table(*to_torch(q, cb)).numpy(),
            np.asarray(jax_li.adc_table(jnp.asarray(q), jnp.asarray(cb))),
            atol=1e-5, rtol=1e-5)

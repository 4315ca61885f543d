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
from repro_torch.kernels import kmeans_assign as km
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
    _, cb, table, qmask, codes, dmask = _adc_inputs(SHAPES[0], 16, 1)
    args = to_torch(table, qmask, codes, dmask)
    with pytest.raises(ValueError, match="CUDA"):
        qm.quantized_maxsim_cuda(*args)
    x = torch.zeros((4, cb.shape[1]))
    with pytest.raises(ValueError, match="CUDA"):
        km.kmeans_assign_cuda(x, torch.from_numpy(cb))


@pytest.mark.parametrize("fn", ["maxsim", "quantized_maxsim",
                                "quantized_maxsim_decode"])
def test_late_interaction_matches_jax(fn):
    rng = np.random.default_rng(11)
    b, mq, d, n, md, k = 2, 6, 16, 24, 9, 32
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    qmask = rng.random((b, mq)) > 0.2
    dmask = rng.random((n, md)) > 0.2
    if fn == "maxsim":
        docs = rng.standard_normal((n, md, d)).astype(np.float32)
    else:
        docs = rng.integers(0, k, (n, md)).astype(np.uint8)
    extra = () if fn == "maxsim" else (cb,)
    want = getattr(jax_li, fn)(*map(jnp.asarray, (q, qmask, docs, dmask,
                                                  *extra)))
    got = getattr(li, fn)(*to_torch(q, qmask, docs, dmask, *extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if fn == "quantized_maxsim":
        np.testing.assert_allclose(
            li.adc_table(*to_torch(q, cb)).numpy(),
            np.asarray(jax_li.adc_table(jnp.asarray(q), jnp.asarray(cb))),
            atol=1e-5, rtol=1e-5)

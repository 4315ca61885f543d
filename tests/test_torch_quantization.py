"""The port's quantization and pruning against ``repro.core``.

Distances and assignment agree outside near-ties (the port's quantize
uses the kernel's ``c2 - 2 x.c`` form, the reference's mesh-less build
the clamped full distance); pruning agrees exactly, planted salience ties
included; a k-means fit cannot replay ``jax.random``, so it is held to the
reference's quality: inertia within 5% on the same data and config.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jax_pruning
from repro.core import quantization as jax_quant
from repro_torch.core import pruning
from repro_torch.core import quantization as quant
from tests._torch_parity import code_gaps, to_torch


def _clustered(seed, n=2048, d=16, centers=24, noise=0.3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d))
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d))
    return x.astype(np.float32)


def _inertia(x, c):
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    d2 = (x * x).sum(1)[:, None] - 2 * x @ c.T + (c * c).sum(1)[None]
    return float(np.maximum(d2, 0).min(1).mean())


def test_pairwise_sq_dists_matches_jax_and_clamps():
    x = _clustered(0, n=200)
    c = x[:16].copy()                        # exact hits -> clamp at 0
    want = np.asarray(jax_quant.pairwise_sq_dists(jnp.asarray(x),
                                                  jnp.asarray(c)))
    got = quant.pairwise_sq_dists(*to_torch(x, c)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert got.min() >= 0.0


@pytest.mark.parametrize("k", [16, 512])
def test_assign_and_quantize_match_jax_outside_near_ties(k):
    x = _clustered(1, n=1024, d=32)
    c = np.random.default_rng(k).standard_normal((k, 32)).astype(np.float32)
    want = np.asarray(jax_quant.assign(jnp.asarray(x), jnp.asarray(c)))
    got = quant.assign(*to_torch(x, c)).numpy()
    assert np.all(code_gaps(x, c, got, want) <= 1e-4)
    assert float(np.mean(got == want)) >= 0.99
    x3 = x.reshape(32, 32, 32)
    dt_j = jnp.uint8 if k <= 256 else jnp.uint16
    want = np.asarray(jax_quant.quantize(jnp.asarray(x3), jnp.asarray(c),
                                         code_dtype=dt_j))
    dt_t = quant.KMeansConfig(k=k).code_dtype
    got = quant.quantize(*to_torch(x3, c), code_dtype=dt_t)
    assert got.dtype == dt_t and tuple(got.shape) == (32, 32)
    got = got.numpy()
    assert got.dtype == want.dtype
    gaps = code_gaps(x3, c, got, want)
    assert np.all(gaps <= 1e-4) and gaps.size <= 0.01 * got.size


def test_decode_matches_jax():
    rng = np.random.default_rng(2)
    c = rng.standard_normal((300, 8)).astype(np.float32)
    codes = rng.integers(0, 300, (5, 7)).astype(np.uint16)
    want = np.asarray(jax_quant.decode(jnp.asarray(codes), jnp.asarray(c)))
    got = quant.decode(*to_torch(codes, c)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lloyd_step_and_repair_match_jax():
    """Same start -> same step: a centroid far from every point dies and
    is repaired onto the farthest point, as in the reference."""
    x = _clustered(3, n=512, d=8, centers=6)
    c0 = x[:12].copy()
    c0[5] = 1e3                              # never the nearest: dead
    want_c, want_i = jax_quant._lloyd_step(jnp.asarray(x), jnp.asarray(c0))
    got_c, got_i = quant._lloyd_step(*to_torch(x, c0))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-5)
    assert not np.allclose(got_c.numpy()[5], 1e3)


def test_repair_dead_centroids_ties_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    c = rng.standard_normal((6, 4)).astype(np.float32)
    counts = np.array([3, 0, 2, 0, 0, 1], np.float32)
    min_d2 = np.round(rng.random(20), 1).astype(np.float32)  # planted ties
    want = jax_quant._repair_dead_centroids(*map(jnp.asarray,
                                                 (x, c, counts, min_d2)))
    got = quant._repair_dead_centroids(*to_torch(x, c, counts, min_d2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmeans_refine_returns_best_iterate():
    x = _clustered(5, n=600, d=8)
    c0 = x[:32].copy()
    best_c, inertias, best_i = quant.kmeans_refine(*to_torch(x, c0), 6)
    assert tuple(inertias.shape) == (6,)
    assert float(best_i) <= float(inertias.min()) + 1e-6
    np.testing.assert_allclose(_inertia(x, best_c.numpy()), float(best_i),
                               rtol=1e-4)


@pytest.mark.parametrize("minibatch", [0, 256])
def test_kmeans_fit_quality_matches_jax(minibatch):
    """Mean inertia over four data sets and seeds: one fit's local optimum
    varies by +-20% with the seed on either side, so a single pair says
    little about the algorithm."""
    cfg = dict(k=32, iters=10, seed_batch=1024, n_restarts=8,
               minibatch=minibatch)
    ours, ref = [], []
    for seed in range(4):
        x = _clustered(6 + seed, n=2048, d=16, centers=40)
        cb_j, _ = jax_quant.kmeans_fit(jax.random.PRNGKey(seed),
                                       jnp.asarray(x),
                                       jax_quant.KMeansConfig(**cfg))
        cb_t, inertias = quant.kmeans_fit(torch.Generator().manual_seed(seed),
                                          torch.from_numpy(x),
                                          quant.KMeansConfig(**cfg))
        assert tuple(cb_t.shape) == (32, 16)
        assert tuple(inertias.shape) == (10,)
        ours.append(_inertia(x, cb_t.numpy()))
        ref.append(_inertia(x, np.asarray(cb_j)))
    assert np.mean(ours) <= 1.05 * np.mean(ref), (ours, ref)
    np.testing.assert_allclose(
        float(quant.quantization_error(torch.from_numpy(x), cb_t)),
        ours[-1], rtol=1e-4)


@pytest.mark.parametrize("m,p", [(10, 60.0), (16, 33.0), (7, 100.0),
                                 (1024, 60.0), (5, 0.0)])
def test_keep_count_matches_jax(m, p):
    assert pruning.keep_count(m, p) == jax_pruning.keep_count(m, p)


def _salience_case(seed, shape=(6, 16)):
    rng = np.random.default_rng(seed)
    sal = rng.integers(0, 4, shape).astype(np.float32) / 4  # many ties
    mask = rng.random(shape) > 0.3
    mask[0, :12] = False                     # fewer valid than kept
    return sal, mask


@pytest.mark.parametrize("p", [25.0, 60.0, 100.0])
def test_prune_topp_matches_jax_exactly(p):
    sal, mask = _salience_case(7)
    emb = np.random.default_rng(8).standard_normal(
        sal.shape + (4,)).astype(np.float32)
    want = jax_pruning.prune_topp(*map(jnp.asarray, (emb, sal, mask)), p=p)
    got = pruning.prune_topp(*to_torch(emb, sal, mask), p=p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_prune_topp_codes_matches_jax_exactly(dtype):
    sal, mask = _salience_case(9)
    codes = np.random.default_rng(10).integers(
        0, np.iinfo(dtype).max, sal.shape).astype(dtype)
    want = jax_pruning.prune_topp_codes(*map(jnp.asarray, (codes, sal, mask)),
                                        p=60.0)
    got = pruning.prune_topp_codes(*to_torch(codes, sal, mask), p=60.0)
    assert got[0].numpy().dtype == dtype
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

"""A placed retrieval state mutated and served, on gloo ranks.

This process writes ``inputs.npz`` (the reference's cascade, ivf, hnsw and
hamming states over docs 0-79 of one corpus, its searches of each state
after an append of docs 80-95 and three deletes, and those docs), then
spawns worlds of 1, 2 and 4 gloo ranks running the ``live`` suite of
``tests/_torch_dist_ranks.py`` (torch and repro_torch only), and one world
of 2 running ``follower_gone``. Each check of a world is one case here.

Held:
  * all six backends, monolithic and segmented, placed by
    ``Retriever.shard`` and then given an add (fresh ids), upserts,
    deletes and a compaction on every rank alike, each step searched
    against the same mutation of the unplaced state: ids equal, ties
    included, scores within 1e-6 (Hamming scores equal); every tensor a
    DTensor on the mesh and each segment placed as its spec resolves;
  * under ``CommDebugMode``, ``add`` and ``delete`` of a placed segmented
    state issue no all-gather (HNSW's graph, which ``add`` regrows whole,
    excepted);
  * the reference's monolithic states placed and mutated by the port with
    the reference's delta, against the reference's search of its own
    unsharded mutation (cascade 1e-4 with every rung, ivf and hnsw 1e-5,
    hamming exact) and the port's unplaced mutation;
  * ``LiveIndexSession`` over a placed state (every backend at world 1,
    flat and cascade at worlds 2 and 4): the first rank serves requests
    (one at a time bit for bit, a burst within 1e-5), adds, upserts,
    deletes, every degradation level and a compaction; the other ranks
    follow until ``close``; every rank then searches its final state
    against the unplaced one;
  * a follower that dies makes the first rank's next request fail within
    the collective timeout, and its ``close`` raise.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from tests import _torch_dist_ranks as ranks
from tests.test_torch_dist import JAX_SPEC, _reference_states, _spawn

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from repro.data import synthetic as jax_synthetic
    path = tmp_path_factory.mktemp("dist_live") / "inputs.npz"
    data = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(0), jax_synthetic.CorpusSpec(**JAX_SPEC))
    z = _reference_states()
    for key, arr in (("p", data.doc_patches), ("m", data.doc_mask),
                     ("s", data.doc_salience)):
        z[f"jx_add_{key}"] = np.asarray(arr)[80:]
    np.savez(path, **z)
    return path


@pytest.fixture(scope="module")
def world_results(inputs):
    cache = {}

    def get(suite: str, world: int) -> dict:
        if (suite, world) not in cache:
            cache[suite, world] = _spawn(world, inputs, suite)
        return cache[suite, world]

    return get


RUNS = [("live", w, c) for w in WORLDS for c, _ in ranks.live_cases(w)]
RUNS += [("follower_gone", 2, "follower_gone")]


@pytest.mark.parametrize("suite,world,case", RUNS,
                         ids=[f"w{w}-{c}" for _, w, c in RUNS])
def test_placed_state_on_gloo_ranks(suite, world, case, world_results):
    res = world_results(suite, world)[case]
    assert res == "ok", res

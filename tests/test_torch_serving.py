"""The port's async serving against ``repro.serving`` and its own search.

On the CPU: coalesced requests through the ported `AsyncRetrievalServer`
return what `Retriever.search` returns per query; ladder rungs and the
``stats()`` keys match the JAX server's; the serving CLI runs end to end.
"""
import asyncio
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import server as jax_server
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.retrieval import Corpus, HPCConfig, Query, Retriever
from repro_torch.serving.client import drive
from repro_torch.serving.server import (AsyncRetrievalServer, ServeConfig,
                                        padding_ladder)
from tests._torch_parity import to_torch

SPEC = synthetic.CorpusSpec(n_docs=96, n_queries=12, n_patches=12,
                            n_q_patches=4, dim=16, n_topics=6)


@pytest.fixture(scope="module")
def built():
    data = synthetic.make_retrieval_corpus(SPEC, seed=3, device="cpu")
    r = Retriever(HPCConfig(k=32, rerank=8, kmeans_iters=5,
                            kmeans_restarts=1, scan_block_docs=32))
    state = r.build(torch.Generator().manual_seed(0), Corpus(
        data.doc_patches, data.doc_mask, data.doc_salience))
    return data, r, state


def _serve(server, q, qm, qs, n):
    async def go():
        out = await drive(server, q, qm, qs, n_requests=n)
        await server.aclose()
        return out
    return asyncio.run(go())


@pytest.mark.parametrize("max_batch", [1, 4, 8])
def test_coalesced_results_equal_per_query_search(built, max_batch):
    data, r, state = built
    calls = []

    def search(q, qm, qs):
        calls.append(q.shape[0])
        return r.search(state, Query(q, qm, qs), k=5)

    server = AsyncRetrievalServer(
        search, ServeConfig(max_batch=max_batch, max_wait_ms=20.0, top_k=5),
        device="cpu")
    q, qm, qs = (a.numpy() for a in (data.query_patches, data.query_mask,
                                     data.query_salience))
    server.warm_shapes(q[0], qm[0], qs[0])
    assert calls == list(server.ladder)
    calls.clear()
    results = _serve(server, q, qm, qs, 12)
    assert all(b in server.ladder for b in calls)
    assert max(calls) <= max_batch
    for i, (scores, ids) in enumerate(results):
        want_s, want_i = r.search(state, Query(*to_torch(
            q[i:i + 1], qm[i:i + 1], qs[i:i + 1])), k=5)
        np.testing.assert_array_equal(ids, want_i[0].numpy())
        np.testing.assert_allclose(scores, want_s[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
    st = server.stats()
    assert st["n"] == 12 and st["mean_batch"] <= max_batch
    assert sum(v["batches"] for v in st["rungs"].values()) == len(calls)


@pytest.mark.parametrize("max_batch", [1, 3, 8, 12, 32])
def test_ladder_matches_jax(max_batch):
    assert padding_ladder(max_batch) == jax_server.padding_ladder(max_batch)
    for ladder in (None, (max_batch,), (1, max_batch)):
        assert ServeConfig(max_batch=max_batch, ladder=ladder) \
            .resolved_ladder() == jax_server.ServeConfig(
                max_batch=max_batch, ladder=ladder).resolved_ladder()
    with pytest.raises(ValueError):
        padding_ladder(0)
    with pytest.raises(ValueError):
        ServeConfig(max_batch=max_batch, ladder=(1, max_batch + 1)) \
            .resolved_ladder()


def test_stats_keys_match_jax():
    k = 3

    def jsearch(q, qm, qs):
        return (jnp.zeros((q.shape[0], k)),
                jnp.zeros((q.shape[0], k), jnp.int32))

    def tsearch(q, qm, qs):
        return (torch.zeros((q.shape[0], k)),
                torch.zeros((q.shape[0], k), dtype=torch.int32))

    q = np.zeros((5, 4, 8), np.float32)
    qm = np.ones((5, 4), bool)
    qs = np.ones((5, 4), np.float32)
    jsrv = jax_server.AsyncRetrievalServer(jsearch, jax_server.ServeConfig(
        max_batch=4, top_k=k))
    tsrv = AsyncRetrievalServer(tsearch, ServeConfig(max_batch=4, top_k=k),
                                device="cpu")
    assert tsrv.stats().keys() == jsrv.stats().keys()
    _serve(jsrv, q, qm, qs, 5)
    _serve(tsrv, q, qm, qs, 5)
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts.keys() == js.keys()
    assert ts["rungs"].keys() == js["rungs"].keys()
    for rung in ts["rungs"].values():
        assert rung.keys() == {"batches", "occupancy"}
    tsrv.reset_stats()
    assert tsrv.stats()["n"] == 0


def test_abandoned_query_counts_as_timeout():
    def slow(q, qm, qs):
        time.sleep(0.2)
        return (torch.zeros((q.shape[0], 1)),
                torch.zeros((q.shape[0], 1), dtype=torch.int32))

    server = AsyncRetrievalServer(slow, ServeConfig(max_batch=1),
                                  device="cpu")
    one = (np.zeros((2, 4), np.float32), np.ones(2, bool),
           np.ones(2, np.float32))

    async def go():
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(server.query(*one), 0.01)
        await server.aclose()

    asyncio.run(go())
    assert server.stats()["timeouts"] == 1


def test_serve_cli_runs_on_cpu(capsys):
    run = serve.main(["--device", "cpu", "--n-docs", "64", "--queries", "8",
                      "--k", "16", "--max-batch", "4"])
    assert run.stats["n"] == 8 and len(run.results) == 8
    assert run.storage["payload"] == 64 * 20          # 32 patches -> 20
    assert 0.0 <= run.hit_rate <= 1.0
    assert run.ladder == (1, 2, 4)    # every rung warmed before the window
    out = capsys.readouterr().out
    assert "ladder (1, 2, 4) warmed" in out and "served 8 queries" in out

"""The port's distribution layer against the reference, on gloo ranks.

This process makes the inputs from a seed with numpy, runs the reference
(the JAX package, on its single CPU device) for the expected outputs, and
writes both to ``inputs.npz``. It then spawns worlds of 1, 2 and 4 gloo
ranks (``tests/_torch_dist_ranks.py``, which imports only torch and
repro_torch); each world runs every check once, and each check is a case
here. Ranks meet through a ``file://`` rendezvous under ``tmp_path`` (no
port), each collective has a 60 s timeout, and this process waits at most
``SPAWN_TIMEOUT`` for a world and names the rank that hung.

Held, as the reference's own tests hold its mesh paths
(``tests/test_distributed.py``) but against single-device results
(caveat C3 of ROADMAP.md: the reference's mesh paths fail under this
JAX):
  * ``sharded_search_fn`` against ``late_interaction.quantized_maxsim`` +
    ``top_k``: scores within 1e-4, and every returned id's true score its
    reported one (ties may pick other ids), with the reference's int32
    codes and f32 masks and with the port's uint8 and bool, at k above
    and below a rank's share;
  * ``sharded_kmeans_refine_fn`` against ``quantization.kmeans_refine``
    from the same x and c0 (three centroids start far from every point,
    so the repair runs): within 1e-5;
  * ``sharded_quantize`` against ``quantization.quantize`` outside
    near-ties (distance gap <= 1e-4), K = 256 (uint8) and 512 (uint16);
  * GPipe against the stages run in sequence (1e-4, the reference's);
    ``ring_allgather_matmul`` against ``x @ w`` (1e-5);
  * at world 1: ``Retriever.build(mesh=)`` against the port's single-host
    build (codebook 1e-5, rerank codes and search equal) for flat, ivf and
    hamming;
  * at every world: all six backends, monolithic and segmented (appends,
    upserts and deletes; a replicated first segment beside sharded
    appends), searched from ``Retriever.shard`` against each rank's own
    unsharded search: ids equal, ties included (copies of a document
    across rank boundaries and segments), scores within 1e-6 (Hamming
    scores equal), at k above a rank's share and above N, at an N that
    does not divide 4, under a 512-entry codebook (uint16 codes); every
    cascade rung and its floor; the member backends' candidate searches;
  * at every world: the reference's cascade, ivf, hnsw and hamming states
    (monolithic, and after an append and deletes), built here and carried
    as arrays, searched from ``Retriever.shard`` against the reference's
    unsharded ``Retriever.search``: the cascade within 1e-4 (every rung
    too, the floor's Hamming scores exactly), ivf and hnsw within 1e-5
    (ids equal outside near-ties, ``topk_mismatches``), hamming exactly;
  * at world 2: ``restore_elastic`` of a reference-written checkpoint
    (float32, uint16 and bfloat16 leaves) onto a (1, 2) mesh, equal to the
    tree with the expected local shards; ``device_put_batch`` by
    placements;
  * model-internal sharding, at world 2 on ("data", "model") meshes
    (2, 1) and (1, 2) and at world 4 on (2, 2): every family's smoke model
    (qwen2-1.5b, llama4-scout and kimi-k2 with int8 moments, ColPali,
    DLRM, DCN-v2, DIN, DIEN, PNA) with params, optimizer state and batch
    placed by their specs, against the port's unsharded run and the
    reference's single-device one (``ms/<arch>/`` in ``inputs.npz``; the
    MoE archs at g token groups, g the data axis, through stand-in
    sharders): the loss and one train step's params, the grads (5e-5;
    PNA's relative to each leaf's largest), the LMs' forward, aux,
    prefill logits and caches and two decode steps, the encoders, the
    recsys forward and candidates (2e-5); each placed param's local numel
    as its resolved spec gives; under ``CommDebugMode`` one MoE block's
    dispatch issues two all-to-alls and no all-gather, and a row-sharded
    table lookup all-gathers no table;
  * the dry run at world 4 on (2, 2): one cell per family (qwen2-1.5b
    train_4k, llama4-scout decode_32k, pna molecule, dlrm-mlperf
    serve_p99, dien retrieval_cand, colpali-hpc serve_query) at smoke
    widths, run for real on every rank: rank 0's recorded FLOPs,
    collectives (kind, bytes, calls) and argument bytes equal the trace
    of rank 0 of a fake 4-rank group (made in a process of its own), and
    rank 0's peak is the largest of the four ranks'. Exact.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ckpt import checkpoint as jax_ck
from repro.core import late_interaction as jax_li
from repro.core import quantization as jax_quant
from tests import _torch_dist_ranks as ranks
from tests._torch_parity import state_arrays

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 420
WORLDS = (1, 2, 4)
TIE_TOL = 1e-4
JAX_SPEC = dict(n_docs=96, n_queries=8, n_patches=10, n_q_patches=4, dim=24,
                n_topics=6, dup_per_doc=2)      # tests/test_cascade.py:25-31


def _inputs(path: Path) -> None:
    """Inputs and the reference's outputs, written to ``path``."""
    rng = np.random.default_rng(0)
    z = {}
    # search: 64 docs of ragged patch masks, 3 queries (one patch off)
    n, md, mq, b, d, k = 64, 6, 4, 3, 16, 16
    codes = rng.integers(0, k, (n, md)).astype(np.int32)
    mask = (rng.random((n, md)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    q = rng.standard_normal((b, mq, d)).astype(np.float32)
    qm = np.ones((b, mq), np.float32)
    qm[2, 3] = 0.0
    cb = rng.standard_normal((k, d)).astype(np.float32)
    full = np.asarray(jax_li.quantized_maxsim(q, qm, codes, mask, cb))
    z.update(s_codes=codes, s_mask=mask, s_q=q, s_qm=qm, s_cb=cb,
             s_ids=np.arange(n, dtype=np.int32), s_full=full)
    for top in (8, 20):
        z[f"s_top{top}"] = np.asarray(jax.lax.top_k(full, top)[0])
    # k-means: 96 points, 12 centroids of which 3 start far from them all
    x = rng.standard_normal((96, 8)).astype(np.float32)
    c0 = np.concatenate([x[:9], 100.0 + rng.standard_normal((3, 8))]
                        ).astype(np.float32)
    best_c, hist, best_i = jax_quant.kmeans_refine(jnp.asarray(x),
                                                   jnp.asarray(c0), 6)
    z.update(km_x=x, km_c0=c0, km_iters=np.int64(6),
             km_best_c=np.asarray(best_c), km_hist=np.asarray(hist),
             km_best_i=np.asarray(best_i))
    # quantize: (32, 5, 8) against K = 256 and 512
    xq = rng.standard_normal((32, 5, 8)).astype(np.float32)
    z["q_x"] = xq
    for kk, dt in ((256, jnp.uint8), (512, jnp.uint16)):
        cbk = rng.standard_normal((kk, 8)).astype(np.float32)
        dist2 = ((xq[..., None, :].astype(np.float64) - cbk) ** 2).sum(-1)
        two = np.sort(dist2, axis=-1)[..., :2]
        z[f"q_cb{kk}"] = cbk
        z[f"q_codes{kk}"] = np.asarray(jax_quant.quantize(
            jnp.asarray(xq), jnp.asarray(cbk), code_dtype=dt)).astype(np.int64)
        z[f"q_tie{kk}"] = (two[..., 1] - two[..., 0]) <= TIE_TOL
    # GPipe: 8 microbatches of 4, d 16, one stage per rank
    n_micro, mb, dp = 8, 4, 16
    xp = rng.standard_normal((n_micro * mb, dp)).astype(np.float32)
    z.update(pipe_x=xp, pipe_micro=np.int64(n_micro))
    for world in WORLDS:
        ws = (rng.standard_normal((world, dp, dp)) / np.sqrt(dp)
              ).astype(np.float32)
        y = jnp.asarray(xp)
        for i in range(world):
            y = jnp.tanh(y @ ws[i])
        z[f"pipe_w{world}"], z[f"pipe_y{world}"] = ws, np.asarray(y)
    # ring matmul
    xr = rng.standard_normal((16, 8)).astype(np.float32)
    wr = rng.standard_normal((8, 12)).astype(np.float32)
    z.update(ring_x=xr, ring_w=wr, ring_y=xr @ wr)
    # a checkpoint the reference writes
    ck_dir = path.parent / "ck"
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    codes16 = rng.integers(0, 512, (8, 4)).astype(np.uint16)
    h = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    jax_ck.save(str(ck_dir), 3, {"w": jnp.asarray(w), "codes": codes16,
                                 "h": h})
    z.update(ck_dir=np.array(str(ck_dir)), ck_w=w, ck_codes=codes16,
             ck_h_bits=np.asarray(h).view(np.uint16))
    z.update(_reference_states())
    z.update(_model_references())
    np.savez(path, **z)


def _model_references() -> dict:
    """Each family's smoke model, inputs and the reference's single-device
    results for the model-sharding cases, under ``ms/<arch>/``: params
    (the reference's init, biases and norm weights drawn, ``p/<key>``),
    inputs (``in/``), and per token-group count g (the data axis of the
    ranks' meshes; a stand-in sharder gives the reference's MoE g groups)
    the outputs under ``g<g>/``: the forward, the loss and its grads
    (``grad/<key>``), the params after one train step (``step/<key>``), and
    for the LMs the prefill's logits and caches and two decode steps fed
    the prefill's greedy tokens; for recsys the candidates' scores; for
    ColPali both encoders' embeddings."""
    from repro.configs import registry as jax_registry
    from repro.models import colpali as jcol
    from repro.models import gnn as jgnn
    from repro.models import recsys as jrec
    from repro.models import transformer as jtr
    from repro.optim import optimizer as jopt
    from repro_torch.convert import _flatten
    from tests.test_torch_gnn import _graph
    from tests.test_torch_model_sharding import _JaxGroups

    out = {}
    rng = np.random.default_rng(7)

    def put(prefix, tree):
        for k, v in _flatten(jax.tree.map(np.asarray, tree)).items():
            out[f"{prefix}{k}"] = v

    for arch, (name, kind) in ranks.MODEL_ARCHS.items():
        spec = jax_registry.get(name)
        cfg = spec.smoke_config
        cfg = cfg.encoder if kind == "colpali" else cfg
        init = {"lm": jtr.init, "colpali": jcol.init, "recsys": jrec.init,
                "gnn": jgnn.init}[kind]
        params = _draw(rng, jax.eval_shape(functools.partial(init, cfg=cfg),
                                           jax.random.PRNGKey(3)))
        pre = f"ms/{arch}/"
        put(pre + "p/", params)
        ocfg = jopt.AdamWConfig(
            moment_dtype="int8" if arch == "kimi" else "fp32")
        if kind == "lm":
            b, s = ranks.LM_BATCH, ranks.LM_SEQ
            batch = {"tokens": rng.integers(0, cfg.vocab, (b, s), np.int32),
                     "targets": rng.integers(0, cfg.vocab, (b, s), np.int32)}
        elif kind == "colpali":
            b = ranks.LM_BATCH
            batch = {"query_tokens": rng.integers(
                         0, cfg.backbone.vocab, (b, cfg.query_len), np.int32),
                     "query_mask": rng.random((b, cfg.query_len)) < 0.8,
                     "doc_patches": rng.standard_normal(
                         (b, cfg.n_patches, cfg.d_patch)).astype(np.float32),
                     "doc_mask": rng.random((b, cfg.n_patches)) < 0.8}
            batch["query_mask"][:, 0] = batch["doc_mask"][:, 0] = True
        elif kind == "recsys":
            batch = ranks.recsys_batch(rng, cfg)
        else:
            batch = _graph("node", 5, padded=True)
        put(pre + "in/", batch)
        jb = jax.tree.map(jnp.asarray, batch)
        for g in ranks.MODEL_GROUPS:
            if g > 1 and not (kind == "lm" and cfg.is_moe):
                continue      # only the MoE routes by token groups
            res = jax.jit(functools.partial(
                _reference_run, kind=kind, cfg=cfg, ocfg=ocfg,
                shd=_JaxGroups(g)))(params, jb)
            put(f"{pre}g{g}/", res)
    return out


def _draw(rng, shapes):
    """Params of the reference's shapes: weights normal / sqrt(fan-in),
    norm weights 1 + 0.1 normal, biases 0.1 normal."""
    def leaf(path, sd):
        name = str(getattr(path[-1], "key", ""))
        z = rng.standard_normal(sd.shape)
        if name.startswith("ln"):
            z = 1.0 + 0.1 * z
        elif name in ("b", "bq", "bk", "bv") or len(sd.shape) < 2:
            z = 0.1 * z
        else:
            z = z / np.sqrt(sd.shape[-2])
        return z.astype(sd.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _reference_run(params, batch, *, kind, cfg, ocfg, shd):
    """Everything the model cases read of one family, in one jitted call:
    the loss, its grads and the params after one AdamW step from a fresh
    state; the LMs' forward, prefill and two greedy decode steps; the
    recsys forward and candidates; the ColPali encoders."""
    from repro.models import colpali as jcol
    from repro.models import gnn as jgnn
    from repro.models import recsys as jrec
    from repro.models import transformer as jtr
    from repro.optim import optimizer as jopt
    out = {}
    if kind == "lm":
        loss = functools.partial(jtr.loss_fn, cfg=cfg, shd=shd)
        args = (batch["tokens"], batch["targets"])
        out["hidden"], out["aux"], _ = jtr.forward(params, batch["tokens"],
                                                   cfg, shd)
        s0 = ranks.LM_PROMPT
        logits, cache = jtr.prefill(params, batch["tokens"][:, :s0], cfg,
                                    ranks.LM_SEQ, shd)
        out["prefill"], out["cache_k"], out["cache_v"] = (logits, cache.k,
                                                          cache.v)
        for i in range(2):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            out[f"feed{i}"] = nxt
            logits, cache = jtr.decode_step(params, nxt, cache,
                                            jnp.int32(s0 + i), cfg, shd)
            out[f"decode{i}"] = logits
    elif kind == "colpali":
        out["doc"], _ = jcol.encode_doc(params, batch["doc_patches"],
                                        batch["doc_mask"], cfg)
        out["query"], _ = jcol.encode_query(params, batch["query_tokens"],
                                            batch["query_mask"], cfg)
        loss = functools.partial(jcol.contrastive_loss, cfg=cfg)
        args = (batch,)
    elif kind == "recsys":
        cand = batch["cand"]
        batch = {k: v for k, v in batch.items() if k != "cand"}
        out["forward"] = jrec.forward(params, batch, cfg)
        user = {k: v[:1] for k, v in batch.items() if k != "label"}
        out["cand"] = jrec.score_candidates(params, user, cand, cfg)
        loss = functools.partial(jrec.loss_fn, cfg=cfg)
        args = (batch,)
    else:
        loss = functools.partial(jgnn.loss_fn, cfg=cfg)
        args = (batch,)
    (out["loss"], _), grads = jax.value_and_grad(loss, has_aux=True)(
        params, *args)
    out["grad"] = grads
    out["step"], _, _ = jopt.update(ocfg, grads, jopt.init(ocfg, params),
                                    params)
    return out



def _reference_states() -> dict:
    """cascade, ivf, hnsw and hamming states the reference builds over
    docs 0-79 of one corpus, and each after an append of docs 80-95 and
    three deletes (segmented), as ``state_arrays`` under ``jx/<name>/``;
    the reference's unsharded searches under ``jxout/<name>/`` (the
    cascade's every rung too)."""
    from repro.core.graph import HNSWConfig as JHNSWConfig
    from repro.core.index import IVFConfig as JIVFConfig
    from repro.data import synthetic as jax_synthetic
    from repro.retrieval import CascadeConfig as JCascadeConfig
    from repro.retrieval import Corpus as JCorpus
    from repro.retrieval import HPCConfig as JConfig
    from repro.retrieval import Query as JQuery
    from repro.retrieval import Retriever as JRetriever

    data = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(0), jax_synthetic.CorpusSpec(**JAX_SPEC))
    docs = [np.asarray(a) for a in (data.doc_patches, data.doc_mask,
                                    data.doc_salience)]
    q = [np.asarray(a) for a in (data.query_patches, data.query_mask,
                                 data.query_salience)]
    jq = JQuery(*map(jnp.asarray, q))
    out = {"jx_q": q[0], "jx_qm": q[1], "jx_qs": q[2]}
    for backend in ranks.JAX_BACKENDS:
        r = JRetriever(JConfig(
            cascade=JCascadeConfig(p1=32, p2=12),
            ivf=JIVFConfig(n_list=8, n_probe=3, iters=6),
            hnsw=JHNSWConfig(ef_search=32), **ranks.jax_cfg(backend)))
        st = r.build(jax.random.PRNGKey(1),
                     JCorpus(*(jnp.asarray(a[:80]) for a in docs)))
        seg = r.delete(r.add(st, JCorpus(*(jnp.asarray(a[80:])
                                           for a in docs))),
                       np.array([2, 41, 85]))
        for variant, state in (("monolithic", st), ("segmented", seg)):
            name = f"{backend}_{variant}"
            for key, val in state_arrays(state, backend).items():
                out[f"jx/{name}/{key}"] = val
            got = r.search(state, jq, k=ranks.JAX_K)
            out[f"jxout/{name}/s"], out[f"jxout/{name}/i"] = map(
                np.asarray, got)
            if backend != "cascade":
                continue
            for j, rung in enumerate(r.degrade_rungs(state, k=ranks.JAX_K)):
                got = r.search_degraded(state, jq, k=ranks.JAX_K, rung=rung)
                out[f"jxout/{name}/rung{j}_s"], \
                    out[f"jxout/{name}/rung{j}_i"] = map(np.asarray, got)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    path = tmp_path_factory.mktemp("dist") / "inputs.npz"
    _inputs(path)
    return path


def _spawn(world: int, inputs: Path, suite: str = "dist") -> dict:
    """Run one world of the rank script's ``suite``; -> {case: "ok" or
    what went wrong}."""
    cases = [c for c, _ in ranks.SUITES[suite](world)]
    workdir = inputs.parent / (f"world{world}" if suite == "dist"
                               else f"{suite}{world}")
    workdir.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    if suite == "dist" and world == ranks.DRYRUN_WORLD:
        # the fake-group traces the ranks' real runs are held to, made in
        # a process of their own (each opens its default group)
        out = inputs.parent / ranks.FAKE_TRACES
        code = ("import sys; from pathlib import Path; "
                f"sys.path.insert(0, {str(Path(ranks.__file__).parent)!r}); "
                "import _torch_dist_ranks as r; "
                f"r.fake_traces(Path({str(out)!r}))")
        got = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True,
                             timeout=SPAWN_TIMEOUT)
        if got.returncode:
            return {c: f"the fake traces failed:\n{got.stderr[-4000:]}"
                    for c in cases}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(ranks.__file__)), str(r), str(world),
         str(workdir), suite], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    outs = {}
    try:
        for r, p in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            try:
                outs[r] = p.communicate(timeout=left)[0]
            except subprocess.TimeoutExpired:
                return {c: f"rank {r} of {world} hung past "
                           f"{SPAWN_TIMEOUT} s" for c in cases}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    per_rank = []
    for r, p in enumerate(procs):
        got = workdir / f"rank{r}.json"
        if not got.exists():
            return {c: f"rank {r} of {world} exited {p.returncode} without "
                       f"results:\n{outs[r][-4000:]}" for c in cases}
        per_rank.append(json.loads(got.read_text()))
    results = {}
    for case in cases:   # ok only if every rank says so
        bad = [f"rank {r}: {res.get(case, 'not run')}"
               for r, res in enumerate(per_rank) if res.get(case) != "ok"]
        results[case] = bad[0] if bad else "ok"
    return results


@pytest.fixture(scope="module")
def world_results(inputs):
    cache = {}

    def get(world: int) -> dict:
        if world not in cache:
            cache[world] = _spawn(world, inputs)
        return cache[world]

    return get


@pytest.mark.parametrize("world,case", [
    (w, c) for w in WORLDS for c, _ in ranks.cases(w)],
    ids=[f"w{w}-{c}" for w in WORLDS for c, _ in ranks.cases(w)])
def test_on_gloo_ranks(world, case, world_results):
    res = world_results(world)[case]
    assert res == "ok", res

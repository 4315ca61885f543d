"""One gloo rank of the port's distribution tests (tests/test_torch_dist.py).

    python tests/_torch_dist_ranks.py RANK WORLD WORKDIR

Imports only torch, numpy and repro_torch. Reads the inputs and the
reference's outputs from ``WORKDIR/../inputs.npz`` (made by the test
process from a seed with numpy and run through the JAX package), meets
the other ranks through a ``file://`` rendezvous in WORKDIR (one rank
opens a group on an in-memory store), runs every check of its world size
in order and writes ``WORKDIR/rank<RANK>.json``: {case: "ok" or the
error}. It stops at the first failure: a later collective would pair
with the wrong call on the other ranks.
"""
from __future__ import annotations

import datetime
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import state_from_numpy
from repro_torch.core import distributed as D
from repro_torch.core import index as index_mod
from repro_torch.data.pipeline import device_put_batch
from repro_torch.data.synthetic import CorpusSpec, make_retrieval_corpus
from repro_torch.dist import collectives, sharding
from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import optimizer as opt
from repro_torch.parity import topk_mismatches
from repro_torch.retrieval import (CascadeConfig, Corpus, HNSWConfig,
                                   HPCConfig, IVFConfig, Query, Retriever)
from repro_torch.train import elastic
from repro_torch.train.loop import make_pipelined_fn

torch.set_num_threads(1)

BACKENDS = ("flat", "float_flat", "hamming", "ivf", "hnsw", "cascade")
MESH = {1: (1, 1), 2: (2, 1), 4: (2, 2)}     # ("data", "model")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def cases(world: int):
    """(name, check) of a world size, in the order every rank runs them."""
    out = [("mesh_checks", check_mesh)]
    out += [(f"search_{dt}_k{k}", lambda z, m, dt=dt, k=k: check_search(
        z, m, dt, k)) for dt in ("reference", "port") for k in (8, 20)]
    out += [("kmeans_refine", check_refine), ("kmeans_fit", check_fit),
            ("kmeans_fit_falls_back", check_fallback),
            ("quantize_k256", lambda z, m: check_quantize(z, m, 256)),
            ("quantize_k512", lambda z, m: check_quantize(z, m, 512)),
            ("gpipe", check_gpipe), ("ring_matmul", check_ring)]
    if world == 1:
        out += [(f"build_mesh_{b}", lambda z, m, b=b: check_build(z, m, b))
                for b in ("flat", "ivf", "hamming")]
    out += [(f"shard_search_{b}", lambda z, m, b=b: check_shard(z, m, b))
            for b in BACKENDS]
    out += [(f"shard_{b}_{v}", lambda z, m, b=b, v=v: check_variant(
        m, b, v)) for v in VARIANTS for b in BACKENDS]
    out += [(f"shard_cascade_rungs_{v}", lambda z, m, v=v: check_rungs(m, v))
            for v in ("monolithic", "segmented")]
    out += [(f"shard_candidates_{b}_{v}", lambda z, m, b=b, v=v:
             check_candidates(m, b, v))
            for b in ("flat", "float_flat", "hamming")
            for v in ("monolithic", "segmented")]
    out += [(f"jax_{name}", lambda z, m, name=name: check_jax(z, m, name))
            for name in JAX_STATES]
    if world == 2:
        out += [("restore_elastic", check_elastic),
                ("device_put_batch", check_put),
                ("constraint_redistributes", check_constraint)]
    out += [(f"model_d{d}m{m}_{arch}",
             lambda z, _, arch=arch, shape=(d, m): check_model(z, arch,
                                                               shape))
            for d, m in MODEL_MESHES.get(world, ()) for arch in MODEL_ARCHS]
    if world == DRYRUN_WORLD:
        out += [(f"dryrun_{arch}_{shape}",
                 lambda z, m, arch=arch, shape=shape: check_dryrun(
                     m, arch, shape)) for arch, shape, _ in DRYRUN_CELLS]
    return out


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def check_mesh(z, mesh):
    world = dist.get_world_size()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == MESH[world]
    for bad in ((4, 4), (world, 2)):
        try:
            mesh_mod.make_host_mesh(bad, device="cpu")
        except ValueError as e:
            assert "ranks" in str(e)
        else:
            raise AssertionError(f"a {bad} mesh over {world} ranks")
    try:
        mesh_mod.make_production_mesh(device="cpu")
    except ValueError as e:
        assert "256" in str(e)
    else:
        raise AssertionError("a production mesh over the test ranks")


def check_search(z, mesh, dtypes, k):
    codes, mask = z["s_codes"], z["s_mask"]
    if dtypes == "port":
        codes, mask = codes.astype(np.uint8), mask > 0
    fn = D.sharded_search_fn(mesh, ("data", "model"), k=k)
    s, i = fn(t(z["s_q"]), t(z["s_qm"]), t(codes), t(mask),
              t(z["s_ids"]), t(z["s_cb"]))
    s, i = s.numpy(), i.numpy()
    want = z[f"s_top{k}"]
    np.testing.assert_allclose(s, want, atol=1e-4)
    # ids may differ on exact ties (documents with the same codes): every
    # returned id's true score must be its reported score
    true = np.take_along_axis(z["s_full"], i, axis=1)
    np.testing.assert_allclose(true, s, atol=1e-4)


def check_refine(z, mesh):
    x, c0 = z["km_x"], z["km_c0"]
    fn = D.sharded_kmeans_refine_fn(mesh, ("data", "model"), k=c0.shape[0],
                                    iters=int(z["km_iters"]),
                                    n_total=x.shape[0], block_rows=10)
    c, hist, best = fn(t(x), t(c0))
    np.testing.assert_allclose(c.numpy(), z["km_best_c"], atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), z["km_hist"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(best), float(z["km_best_i"]), rtol=1e-5)


def check_fit(z, mesh):
    """The sharded fit from the single-host fit's generator state: the
    same seeds, restarts and Lloyd steps (1e-4: the ranks' sums add in
    another order, as the reference's own test allows)."""
    from repro_torch.core import quantization as quant
    cfg = quant.KMeansConfig(k=12, iters=6, seed_batch=48, n_restarts=2)
    x = t(z["km_x"])
    c, hist = D.sharded_kmeans_fit(mesh, torch.Generator().manual_seed(4),
                                   x, cfg)
    c_ref, hist_ref = quant.kmeans_fit(torch.Generator().manual_seed(4), x,
                                       cfg)
    np.testing.assert_allclose(c.numpy(), c_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), hist_ref.numpy(), atol=1e-4)


def check_fallback(z, mesh):
    """No corpus axis divides N (97 rows over 2 or 4 ranks; at one rank
    every N divides): a warning and the single-host fit and quantizer."""
    import warnings
    from repro_torch.core import quantization as quant
    x = t(z["km_x"][:1] if dist.get_world_size() == 1 else
          np.concatenate([z["km_x"], z["km_x"][:1]]))
    cfg = quant.KMeansConfig(k=4, iters=2, n_restarts=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c, _ = D.sharded_kmeans_fit(mesh, torch.Generator().manual_seed(6),
                                    x, cfg)
        codes = D.sharded_quantize(mesh, x[:, None], c, torch.uint8)
    if dist.get_world_size() > 1:
        assert len(caught) == 2 and "falling back" in str(caught[0].message)
    c_ref, _ = quant.kmeans_fit(torch.Generator().manual_seed(6), x, cfg)
    assert torch.equal(c, c_ref)
    assert torch.equal(codes, quant.quantize(x[:, None], c))


def check_quantize(z, mesh, k):
    x, cb = z["q_x"], z[f"q_cb{k}"]
    dtype = torch.uint8 if k == 256 else torch.uint16
    got = D.sharded_quantize(mesh, t(x), t(cb), dtype)
    assert got.dtype == dtype and tuple(got.shape) == x.shape[:-1]
    want, tie = z[f"q_codes{k}"], z[f"q_tie{k}"]
    diff = (got.to(torch.int64).numpy() != want) & ~tie
    assert not diff.any(), f"codes differ outside near-ties at {diff.sum()}"


def check_gpipe(z, mesh):
    world = dist.get_world_size()
    pipe = mesh_mod.make_host_mesh((world,), ("pipe",), device="cpu")
    ws = z[f"pipe_w{world}"]
    f = make_pipelined_fn(pipe, lambda sp, x: torch.tanh(x @ sp["w"]),
                          n_microbatches=int(z["pipe_micro"]))
    y = f({"w": t(ws)}, t(z["pipe_x"]))
    np.testing.assert_allclose(y.numpy(), z[f"pipe_y{world}"], atol=1e-4)


def check_ring(z, mesh):
    world = dist.get_world_size()
    ring = mesh_mod.make_host_mesh((world,), ("model",), device="cpu")
    y = collectives.ring_allgather_matmul(ring, "model")(
        t(z["ring_x"]), t(z["ring_w"]))
    if world > 1:
        assert isinstance(y, torch.distributed.tensor.DTensor)
        assert y.to_local().shape[0] == z["ring_x"].shape[0] // world
    np.testing.assert_allclose(sharding.full_tensor(y).numpy(),
                               z["ring_y"], atol=1e-5)


def _corpus(n_docs=64):
    data = make_retrieval_corpus(
        CorpusSpec(n_docs=n_docs, n_queries=8, n_patches=12, n_q_patches=4,
                   dim=16, n_topics=4, patches_per_topic=16),
        seed=3, device="cpu")
    return (Corpus(data.doc_patches, data.doc_mask, data.doc_salience),
            Query(data.query_patches, data.query_mask, data.query_salience))


def _cfg(backend):
    return HPCConfig(k=16, p=60.0, backend=backend, prune_side="doc",
                     kmeans_iters=4, kmeans_restarts=2, kmeans_minibatch=0,
                     rerank=12)


def _build(backend, mesh=None):
    corpus, query = _corpus()
    r = Retriever(_cfg(backend))
    gen = torch.Generator().manual_seed(5)
    return r, r.build(gen, corpus, mesh=mesh), query


def check_build(z, mesh, backend):
    r, st_mesh, q = _build(backend, mesh)
    _, st_local, _ = _build(backend)
    np.testing.assert_allclose(st_mesh.codebook.numpy(),
                               st_local.codebook.numpy(), atol=1e-5)
    assert torch.equal(st_mesh.rerank_codes, st_local.rerank_codes)
    s_m, i_m = r.search(st_mesh, q, k=5)
    s_l, i_l = r.search(st_local, q, k=5)
    np.testing.assert_allclose(s_m.numpy(), s_l.numpy(), atol=1e-6)
    assert torch.equal(i_m, i_l)


def check_shard(z, mesh, backend):
    r, state, q = _build(backend)
    sharded = r.shard(state, mesh)
    assert isinstance(sharded.rerank_codes, torch.distributed.tensor.DTensor)
    s_sh, i_sh = r.search(sharded, q, k=5)
    s, i = r.search(state, q, k=5)
    np.testing.assert_allclose(s_sh.numpy(), s.numpy(), atol=1e-6)
    assert torch.equal(i_sh, i)
    if backend == "flat":       # each rank holds its rows only
        n_local = state.rerank_codes.shape[0] // dist.get_world_size()
        assert sharded.rerank_codes.to_local().shape[0] == n_local


# ---------------------------------------------------------------------------
# every backend searched across ranks: each rank's answer against its own
# unsharded search (ids equal, scores within 1e-6; Hamming scores equal)
# ---------------------------------------------------------------------------

# "segmented": 63 docs (dim 0 replicated at 2 and 4 ranks), then appends of
#   16 and 9 docs (capacity 16: sharded), 3 upserts and 5 deletes;
# "k_past_share": 64 docs searched at k = 40 (above a rank's share at 2 and
#   4 ranks, and above the cascade's p2) and k = 80 (above N);
# "indivisible": 66 docs (and 7 IVF lists): N does not divide 4, so dim 0
#   shards over "data" alone at 4 ranks, and IVF's buckets replicate;
# "ties": copies of doc 15 at positions 16, 31, 32 and 40 (across the rank
#   boundaries at 2 and 4 ranks) and as the first doc of an appended
#   segment (rank 0's rows): query 0 is doc 15's patches, so the six
#   copies tie at the top (under the ADC and Hamming scans with 18 more
#   docs of every rank), in position order only if every segment is
#   merged on its own in shard order;
# "k512": 64 docs under a 512-entry codebook: uint16 codes (9-bit Hamming
#   codes, uint16 rerank rows) placed through their byte views.
VARIANTS = ("segmented", "k_past_share", "indivisible", "ties", "k512")
SEG_BASE, SEG_DELETE, SEG_UPSERT = 63, (5, 33, 50, 70, 82), (3, 20, 41)
TIE_DOC, TIE_COPIES = 15, (16, 31, 32, 40)
VARIANT_K = {"segmented": (5, 40), "k_past_share": (40, 80),
             "indivisible": (5, 40), "ties": (30,), "k512": (5,)}
_STATES = {}


def _scfg(backend, n_list=8, k=16):
    return HPCConfig(k=k, p=60.0, backend=backend, prune_side="doc",
                     kmeans_iters=4, kmeans_restarts=2, kmeans_minibatch=0,
                     rerank=12, cascade=CascadeConfig(32, 12),
                     ivf=IVFConfig(n_list=n_list, n_probe=3, bucket_cap=32,
                                   iters=4, restarts=1),
                     hnsw=HNSWConfig(ef_search=24))


def _rows(corpus, lo, hi):
    return Corpus(*(a[lo:hi] for a in corpus))


def _state(backend, variant):
    """(retriever, unsharded state, query) of a variant, built once per
    rank (every rank builds the same state from the same seeds)."""
    key = (backend, variant)
    if key in _STATES:
        return _STATES[key]
    r = Retriever(_scfg(backend, 7 if variant == "indivisible" else 8,
                        512 if variant == "k512" else 16))
    gen = torch.Generator().manual_seed(5)
    if variant == "segmented":
        corpus, query = _corpus(96)
        st = r.build(gen, _rows(corpus, 0, SEG_BASE))
        st = r.add(st, _rows(corpus, SEG_BASE, 79))
        st = r.add(st, _rows(corpus, 79, 88))
        st = r.add(st, _rows(corpus, 88, 91), doc_ids=list(SEG_UPSERT))
        st = r.delete(st, list(SEG_DELETE))
    elif variant == "ties":
        corpus, query = _corpus(72)
        corpus = Corpus(*(a.clone() for a in corpus))
        corpus.salience[TIE_DOC, :4] += 10.0     # the queried patches kept
        for a in corpus:
            a[list(TIE_COPIES) + [64]] = a[TIE_DOC].clone()
        st = r.add(r.build(gen, _rows(corpus, 0, 64)), _rows(corpus, 64, 72))
        query = Query(*(a.clone() for a in query))
        query.embeddings[0] = corpus.embeddings[TIE_DOC, :4]
        query.mask[0] = True
    else:
        corpus, query = _corpus(66 if variant == "indivisible" else 64)
        st = r.build(gen, corpus)
    _STATES[key] = (r, st, query)
    return _STATES[key]


def _same(got, want, what):
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == ws.dtype and gi.dtype == wi.dtype, what
    assert torch.equal(gi, wi), f"{what}: ids\n{gi}\n!=\n{wi}"
    if gs.dtype.is_floating_point:
        np.testing.assert_allclose(gs.numpy(), ws.numpy(), atol=1e-6,
                                   err_msg=what)
    else:
        assert torch.equal(gs, ws), f"{what}: scores"


def _expect_ties(got, backend):
    """Query 0's answer holds the copies of doc 15 at one score, in
    position order (all six where a stage budget does not cut the tied
    group: the ADC and Hamming scans tie 24 docs of every rank there)."""
    copies = [TIE_DOC, *TIE_COPIES, 64]
    ids = got[1][0].tolist()
    seen = [i for i in ids if i in copies]
    assert seen == [c for c in copies if c in seen], seen
    assert len({float(got[0][0, ids.index(i)]) for i in seen}) == 1
    want = 3 if backend in ("cascade", "hnsw") else 6
    assert len(seen) >= want, f"{len(seen)} tied copies returned: {ids}"


def _placed(r, sharded, backend, variant):
    """Across ranks: the rerank rows are sharded, and a segmented state
    mixes a replicated first segment (63 rows) with sharded appends."""
    rc = sharded.rerank_codes
    assert rc.to_local().shape[0] < rc.shape[0], "rerank rows replicated"
    if variant == "k512" and backend != "float_flat":
        assert rc.dtype == rc.to_local().dtype == torch.uint16
    if variant != "segmented" or backend in ("ivf", "hnsw"):
        return
    first, second = (index_mod.seg_doc_ids(p)
                     for p in r.backend._segmented(sharded).segments[:2])
    assert first.to_local().shape == first.shape, "segment 0 sharded"
    assert second.to_local().shape[0] < second.shape[0], "appends replicated"


def check_variant(mesh, backend, variant):
    r, state, q = _state(backend, variant)
    sharded = r.shard(state, mesh)
    if dist.get_world_size() > 1:
        _placed(r, sharded, backend, variant)
    for k in VARIANT_K[variant]:
        got = r.search(sharded, q, k=k)
        _same(got, r.search(state, q, k=k), f"{backend} {variant} k={k}")
        if variant == "ties":
            _expect_ties(got, backend)


def check_rungs(mesh, variant):
    """Every rung of the cascade's degradation ladder and its floor."""
    r, state, q = _state("cascade", "segmented" if variant == "segmented"
                         else "k_past_share")
    sharded = r.shard(state, mesh)
    rungs = r.degrade_rungs(state, k=5)
    assert rungs == r.degrade_rungs(sharded, k=5) and rungs[-1] is None
    assert len(rungs) == 3, rungs
    for rung in rungs:
        _same(r.search_degraded(sharded, q, k=5, rung=rung),
              r.search_degraded(state, q, k=5, rung=rung), f"rung {rung}")


def check_candidates(mesh, backend, variant):
    """A member backend's candidate search: (B, P) pools with -1 slots,
    repeats, and (monolithic) positions past the corpus, which read the
    last doc as the local path's clamp does."""
    r, state, q = _state(backend, "segmented" if variant == "segmented"
                         else "k_past_share")
    sharded = r.shard(state, mesh)
    rng = np.random.default_rng(7)
    top = 96 if variant == "segmented" else 70
    pool = rng.integers(-1, top, (q.embeddings.shape[0], 24))
    pool[:, 5] = pool[:, 4]
    pool = torch.from_numpy(pool.astype(np.int32))
    be = r.backend
    for k in (6, 30):
        _same(be.search_candidates(sharded, q, pool, k=k),
              be.search_candidates(state, q, pool, k=k),
              f"{backend} candidates k={k}")


# ---------------------------------------------------------------------------
# a placed state mutated and served (tests/test_torch_dist_live.py): every
# backend, monolithic (64 docs) and segmented (the "segmented" variant),
# placed by ``Retriever.shard`` and then mutated on every rank alike, each
# step searched at VARIANT_K against the same mutation of the unplaced
# state (``_same``: ids equal, ties included; scores within 1e-6, Hamming
# scores equal); every tensor stays a DTensor on the mesh, each segment
# placed by its spec (sharded where its rows divide the shards)
# ---------------------------------------------------------------------------

MUT_VARIANTS = {"monolithic": "k_past_share", "segmented": "segmented"}
MUT_UPSERT, MUT_DELETE = (3, 20, 70), (5, 22, 66, 81, 500)


def _mut_steps(r):
    """(name, op) of the mutations: 16 docs under fresh ids (pages of
    docs 40-55), 3 upserts (pages of docs 10-12), 5 deletes (one unknown
    id), compact."""
    corpus, _ = _corpus(96)
    return (("add", lambda st: r.add(st, _rows(corpus, 40, 56))),
            ("upsert", lambda st: r.add(st, _rows(corpus, 10, 13),
                                        doc_ids=list(MUT_UPSERT))),
            ("delete", lambda st: r.delete(st, list(MUT_DELETE))),
            ("compact", lambda st: r.compact(st)))


def _members(r, state):
    """(backend, view) of each member of a cascade, else of the state."""
    be = r.backend
    return be._views(state) if be.name == "cascade" else [(be, state)]


def _still_placed(r, state, mesh, what):
    """Every tensor a DTensor on ``mesh``; each segment's rows placed as
    its spec resolves (the divisibility fallback per segment)."""
    from repro_torch.retrieval.base import state_map
    from torch.distributed.tensor import DTensor
    leaves = []
    state_map(leaves.append, state)
    bad = [tuple(x.shape) for x in leaves if not isinstance(x, DTensor)
           or x.device_mesh != mesh]
    assert not bad, f"{what}: not placed on the mesh: {bad}"
    shd = sharding.Sharder(mesh)
    for be, view in _members(r, state):
        seg = be._segmented(view)
        for payload, lv in zip(seg.segments, seg.live):
            ids = index_mod.seg_doc_ids(payload)
            cut = shd.num_shards("corpus", ids.shape[0])
            assert ids.to_local().shape[0] * cut == ids.shape[0], (
                what, tuple(ids.shape), cut)
        assert seg.pos_of_id.to_local().shape == seg.pos_of_id.shape


def check_mutate(mesh, backend, variant):
    r, state, q = _state(backend, MUT_VARIANTS[variant])
    placed = r.shard(state, mesh)
    for name, op in _mut_steps(r):
        state, placed = op(state), op(placed)
        _still_placed(r, placed, mesh, f"{backend} {variant} {name}")
        for k in VARIANT_K[MUT_VARIANTS[variant]]:
            _same(r.search(placed, q, k=k), r.search(state, q, k=k),
                  f"{backend} {variant} {name} k={k}")


def check_no_gather(mesh, backend):
    """``add`` (fresh ids within the id map's capacity, and upserts) and
    ``delete`` on a placed segmented state issue no all-gather: no
    existing segment is taken whole."""
    r, state, q = _state(backend, "segmented")
    placed = r.shard(state, mesh)
    corpus, _ = _corpus(96)
    comm = CommDebugMode()
    with comm:
        placed = r.add(placed, _rows(corpus, 40, 56))
        placed = r.add(placed, _rows(corpus, 10, 13),
                       doc_ids=list(MUT_UPSERT))
        placed = r.delete(placed, list(MUT_DELETE))
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert not [k for k in counts if "gather" in k], counts
    state = r.delete(r.add(r.add(state, _rows(corpus, 40, 56)),
                           _rows(corpus, 10, 13), doc_ids=list(MUT_UPSERT)),
                     list(MUT_DELETE))
    _same(r.search(placed, q, k=5), r.search(state, q, k=5),
          f"{backend} after the counted mutations")


def check_jax_mutation(z, mesh, backend):
    """The reference's monolithic state placed and mutated by the port as
    the reference mutated it (docs 80-95 added, ids 2, 41 and 85
    deleted), against the reference's search of its own mutation (and
    for the cascade every rung), and against the port's unplaced
    mutation."""
    name = f"{backend}_monolithic"
    prefix = f"jx/{name}/"
    state = state_from_numpy({key[len(prefix):]: z[key] for key in z
                              if key.startswith(prefix)}, device="cpu",
                             backend=backend)
    r = Retriever(HPCConfig(
        cascade=CascadeConfig(p1=32, p2=12),
        ivf=IVFConfig(n_list=8, n_probe=3, iters=6),
        hnsw=HNSWConfig(ef_search=32), **jax_cfg(backend)))
    q = Query(t(z["jx_q"]), t(z["jx_qm"]), t(z["jx_qs"]))
    delta = Corpus(t(z["jx_add_p"]), t(z["jx_add_m"]), t(z["jx_add_s"]))

    def mutate(st):
        return r.delete(r.add(st, delta), np.array(JAX_DELETED))

    placed, state = mutate(r.shard(state, mesh)), mutate(state)
    _still_placed(r, placed, mesh, name)
    seg_name = f"{backend}_segmented"
    tol = JAX_TOL[backend]
    _same(r.search(placed, q, k=JAX_K), r.search(state, q, k=JAX_K), name)
    _match(r.search(placed, q, k=JAX_K), z[f"jxout/{seg_name}/s"],
           z[f"jxout/{seg_name}/i"], tol, name)
    if backend != "cascade":
        return
    for j, rung in enumerate(r.degrade_rungs(placed, k=JAX_K)):
        _match(r.search_degraded(placed, q, k=JAX_K, rung=rung),
               z[f"jxout/{seg_name}/rung{j}_s"],
               z[f"jxout/{seg_name}/rung{j}_i"],
               0.0 if rung is None else tol, f"{name} rung {rung}")


# LiveIndexSession over a placed state: the first rank serves, the others
# follow; answers held to the unplaced state under the same mutations
SESSION_K, SESSION_BATCH = 5, 4


def _session(r, placed):
    from repro_torch.serving import (LiveIndexSession, ResilienceConfig,
                                     ServeConfig)
    return LiveIndexSession(r, placed, ServeConfig(
        max_batch=SESSION_BATCH, top_k=SESSION_K,
        resilience=ResilienceConfig(max_queue=64)), device="cpu")


def _rows_of(q, lo, hi):
    return Query(*(a[lo:hi] for a in q))


def check_session(mesh, backend):
    """Rounds of requests (one at a time, bit for bit against the
    unplaced search; a burst of concurrent ones within 1e-5 with ids
    outside near-ties), an add, upserts and deletes between rounds,
    every degradation level, warm_shapes at every rung and level, a
    compaction; the followers leave ``follow`` at ``close`` and every
    rank then searches the state its session ended with."""
    r, state, q = _state(backend, "k_past_share")
    sess = _session(r, r.shard(state, mesh))
    steps = _mut_steps(r)
    n_q = q.embeddings.shape[0]
    if not sess.leader:
        assert sess.server is None
        assert sess.follow() > 0
    else:
        host = tuple(a.numpy() for a in q)
        corpus, _ = _corpus(96)

        def one_at_a_time(st):
            for i in range(n_q):
                out = sess.query(*(a[i] for a in host), timeout=120.0)
                got = tuple(torch.from_numpy(np.asarray(a))[None]
                            for a in out)
                _same(got, r.search(st, _rows_of(q, i, i + 1),
                                    k=SESSION_K), f"{backend} query {i}")

        def burst(st):
            reqs = [sess.submit(*(a[i] for a in host)) for i in range(n_q)]
            want = r.search(st, q, k=SESSION_K)
            for i, req in enumerate(reqs):
                assert req.event.wait(120.0), "a request hung"
                if req.error is not None:
                    raise req.error
                gs, gi = (np.asarray(a)[None] for a in req.result)
                ws, wi = (a[i:i + 1].numpy() for a in want)
                np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=1e-5)
                assert not topk_mismatches(gi, gs, wi, ws, 1e-5), (gi, wi)

        sess.warm_shapes(*(a[0] for a in host))
        one_at_a_time(state)
        for name, op in steps:
            if name == "compact":
                for level, fn in enumerate(sess.search_fns):
                    want = (r.search(state, q, k=SESSION_K) if level == 0
                            else r.search_degraded(
                                state, q, k=SESSION_K,
                                rung=sess.degrade_rungs[level - 1]))
                    _same(fn(*q), want, f"{backend} level {level}")
            state = op(state)
            {"add": lambda: sess.add(_rows(corpus, 40, 56)),
             "upsert": lambda: sess.add(_rows(corpus, 10, 13),
                                        doc_ids=list(MUT_UPSERT)),
             "delete": lambda: sess.delete(list(MUT_DELETE)),
             "compact": sess.compact}[name]()
            (burst if name == "upsert" else one_at_a_time)(state)
        sess.close()
    if not sess.leader:
        for _, op in steps:
            state = op(state)
    _same(r.search(sess.state, q, k=SESSION_K),
          r.search(state, q, k=SESSION_K), f"{backend} after close")


def check_follower_gone(mesh):
    """A follower that dies: the first rank's next request fails within
    the group's collective timeout (60 s), never hangs, and ``close``
    raises. Runs alone (the group is broken after it)."""
    import os
    import time
    r, state, q = _state("flat", "k_past_share")
    sess = _session(r, r.shard(state, mesh))
    host = tuple(a.numpy() for a in q)
    if not sess.leader:
        sess._run(*collectives.broadcast_op(mesh))     # the first request
        _WORKDIR[0].joinpath(f"rank{dist.get_rank()}.json").write_text(
            json.dumps({"follower_gone": "ok"}))
        os._exit(0)
    sess.query(*(a[0] for a in host), timeout=120.0)
    time.sleep(1.0)
    t0 = time.monotonic()
    try:
        sess.query(*(a[1] for a in host), timeout=120.0)
    except TimeoutError:
        raise AssertionError("the request hung past its own timeout")
    except RuntimeError as e:
        waited = time.monotonic() - t0
        assert waited < 75.0, waited
        print(f"follower gone: {type(e).__name__} after {waited:.1f} s")
    else:
        raise AssertionError("a request was served with a follower gone")
    try:
        sess.close()
    except RuntimeError:
        pass
    else:
        raise AssertionError("close() reached a follower that is gone")


def live_cases(world: int):
    out = [(f"mutate_{b}_{v}", lambda z, m, b=b, v=v: check_mutate(m, b, v))
           for v in MUT_VARIANTS for b in BACKENDS]
    out += [(f"no_gather_{b}", lambda z, m, b=b: check_no_gather(m, b))
            for b in BACKENDS if b != "hnsw"]
    out += [(f"jax_mutation_{b}", lambda z, m, b=b: check_jax_mutation(
        z, m, b)) for b in JAX_BACKENDS]
    out += [(f"session_{b}", lambda z, m, b=b: check_session(m, b))
            for b in (BACKENDS if world == 1 else ("flat", "cascade"))]
    return out


# ---------------------------------------------------------------------------
# the reference's states, searched across ranks, against the reference's
# unsharded search (its arrays and outputs in inputs.npz under jx/ and
# jxout/): cascade 1e-4 (every rung and the floor too; the floor's Hamming
# scores exact), ivf and hnsw 1e-5, hamming exact
# ---------------------------------------------------------------------------

JAX_BACKENDS = ("cascade", "ivf", "hnsw", "hamming")
JAX_STATES = tuple(f"{b}_{v}" for b in JAX_BACKENDS
                   for v in ("monolithic", "segmented"))
JAX_TOL = {"cascade": 1e-4, "ivf": 1e-5, "hnsw": 1e-5, "hamming": 0.0}
JAX_RERANK = {"cascade": 0, "ivf": 16, "hnsw": 16, "hamming": 0}
JAX_K = 10
JAX_DELETED = (2, 41, 85)   # the reference's segmented states' deletes


def jax_cfg(backend):
    """The search-side knobs both packages use (the rest rides in the
    state's arrays)."""
    return dict(k=32, p=60.0, backend=backend, prune_side="doc",
                kmeans_iters=6, kmeans_restarts=2,
                rerank=JAX_RERANK[backend])


def _match(got, want_s, want_i, tol, what):
    gs, gi = got[0].numpy(), got[1].numpy()
    assert gi.shape == want_i.shape, what
    if tol == 0.0:
        np.testing.assert_array_equal(gs, want_s, err_msg=what)
        np.testing.assert_array_equal(gi, want_i, err_msg=what)
        return
    np.testing.assert_allclose(gs, want_s, atol=tol, rtol=tol, err_msg=what)
    bad = topk_mismatches(gi, gs, want_i, want_s, tol)
    assert not bad, f"{what}: ids differ outside near-ties at {bad}"


def check_jax(z, mesh, name):
    backend = name.rsplit("_", 1)[0]
    prefix = f"jx/{name}/"
    arrays = {key[len(prefix):]: z[key] for key in z
              if key.startswith(prefix)}
    state = state_from_numpy(arrays, device="cpu", backend=backend)
    r = Retriever(HPCConfig(**jax_cfg(backend)))
    q = Query(t(z["jx_q"]), t(z["jx_qm"]), t(z["jx_qs"]))
    sharded = r.shard(state, mesh)
    tol = JAX_TOL[backend]
    _match(r.search(sharded, q, k=JAX_K), z[f"jxout/{name}/s"],
           z[f"jxout/{name}/i"], tol, name)
    if backend != "cascade":
        return
    for j, rung in enumerate(r.degrade_rungs(sharded, k=JAX_K)):
        _match(r.search_degraded(sharded, q, k=JAX_K, rung=rung),
               z[f"jxout/{name}/rung{j}_s"], z[f"jxout/{name}/rung{j}_i"],
               0.0 if rung is None else tol, f"{name} rung {rung}")


def check_elastic(z, mesh):
    mesh = mesh_mod.make_host_mesh((1, 2), device="cpu")
    template = {"w": torch.zeros((8, 8)),
                "codes": torch.zeros((8, 4), dtype=torch.uint16),
                "h": torch.zeros((4, 6), dtype=torch.bfloat16)}
    specs = {"w": ("batch", "mlp"), "codes": (None, "mlp"),
             "h": (None, "mlp")}
    step, got = elastic.restore_elastic(str(Path(z["ck_dir"].item())),
                                        template, specs, mesh)
    assert step == 3
    assert got["w"].to_local().shape == (8, 4)
    assert got["codes"].to_local().shape == (8, 2)
    assert got["h"].to_local().shape == (4, 3)
    np.testing.assert_array_equal(sharding.full_tensor(got["w"]).numpy(),
                                  z["ck_w"])
    np.testing.assert_array_equal(
        sharding.full_tensor(got["codes"]).numpy(), z["ck_codes"])
    h = sharding.full_tensor(got["h"]).view(torch.int16).numpy()
    np.testing.assert_array_equal(h.view(np.uint16), z["ck_h_bits"])


def check_put(z, mesh):
    batch = {"x": torch.arange(24.0).reshape(8, 3),
             "ids": torch.arange(8, dtype=torch.int16), "keep": torch.ones(2)}
    shd = sharding.Sharder(mesh)
    out = device_put_batch(batch, {
        "x": shd.named(("batch", None), (8, 3)),
        "ids": shd.named(("batch",), (8,))})
    assert out["x"].to_local().shape == (4, 3)
    assert out["keep"] is batch["keep"]
    assert torch.equal(sharding.full_tensor(out["ids"]), batch["ids"])


def check_constraint(z, mesh):
    shd = sharding.Sharder(mesh)
    x = torch.arange(32.0).reshape(8, 4)
    dt = sharding.distribute(x, shd.named(("batch", None), (8, 4)))
    assert dt.to_local().shape == (4, 4)
    full = shd.constraint(dt, None, None)
    assert full.to_local().shape == (8, 4) and torch.equal(full.to_local(), x)
    assert shd.constraint(x, "batch", None) is x
    assert sharding.NULL.constraint(dt, "batch") is dt


# ---------------------------------------------------------------------------
# model-internal sharding: every family's smoke model on a placed mesh
# ---------------------------------------------------------------------------

# ("data", "model") meshes of each world, and the archs run on each
MODEL_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
MODEL_ARCHS = {"qwen2": ("qwen2-1.5b", "lm"),
               "scout": ("llama4-scout-17b-a16e", "lm"),
               "kimi": ("kimi-k2-1t-a32b", "lm"),
               "colpali": ("colpali-hpc", "colpali"),
               "dlrm": ("dlrm-mlperf", "recsys"),
               "dcn": ("dcn-v2", "recsys"), "din": ("din", "recsys"),
               "dien": ("dien", "recsys"), "pna": ("pna", "gnn")}
MODEL_GROUPS = (1, 2)        # the token groups of a data axis of 1 and 2
LM_BATCH, LM_SEQ, LM_PROMPT = 4, 16, 12
N_CAND = 16
FWD_TOL, GRAD_TOL = 2e-5, 5e-5
_MESHES = {}


def recsys_batch(rng, cfg):
    """A numpy batch of a recsys family (8 rows, every id inside its
    table) and ``cand``: N_CAND candidate ids."""
    b = 8
    if cfg.family in ("din", "dien"):
        mask = np.arange(cfg.seq_len)[None] < rng.integers(
            cfg.seq_len // 2, cfg.seq_len + 1, (b, 1))
        out = {"hist_ids": rng.integers(0, cfg.table_rows[0],
                                        (b, cfg.seq_len), np.int32),
               "hist_mask": mask,
               "target_ids": rng.integers(0, cfg.table_rows[0], (b,),
                                          np.int32)}
    else:
        out = {"dense": rng.standard_normal((b, cfg.n_dense)).astype(
                   np.float32),
               "sparse_ids": np.stack([rng.integers(0, r, b, np.int32)
                                       for r in cfg.table_rows], 1)}
    out["label"] = (rng.random(b) < 0.5).astype(np.float32)
    rows = cfg.table_rows[0 if cfg.family in ("din", "dien") else -1]
    out["cand"] = rng.integers(0, rows, (N_CAND,), np.int32)
    return out


class _Groups:
    """The port without a mesh, routing its MoE in g token groups as a
    mesh whose token axes shard g ways does."""
    mesh = None

    def __init__(self, g):
        self.g = g

    def num_shards(self, name, dim):
        return self.g if name == "tokens" and dim % self.g == 0 else 1

    def constraint(self, x, *spec):
        return x

    def scope(self):
        import contextlib
        return contextlib.nullcontext()


class _Gathers(TorchDispatchMode):
    """The input shapes of every all-gather issued inside it."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "all_gather" in str(func):
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def _full(x):
    return sharding.full_tensor(x).detach()


def _agree(got, port, ref, tol, what):
    """A sharded result against the port's unsharded one and the
    reference's (numpy; None: the port's alone)."""
    got = _full(got).float().numpy()
    np.testing.assert_allclose(got, _full(port).float().numpy(), atol=tol,
                               rtol=tol, err_msg=f"{what} vs the port")
    if ref is not None:
        np.testing.assert_allclose(got, ref, atol=tol, rtol=tol,
                                   err_msg=f"{what} vs the reference")


def _tree(z, prefix):
    from repro_torch.convert import _nest
    return _nest({k[len(prefix):]: z[k] for k in z if k.startswith(prefix)})


def _same_params(got, port, z, prefix, tol, what, scale=False):
    """Named tensors (grads or params) in the reference's layout against
    the port's and the reference's ``prefix`` arrays (``z`` None: the
    port's alone); ``scale`` takes the tolerance relative to each leaf's
    largest value."""
    from repro_torch.convert import _flatten, params_to_numpy
    g = _flatten(params_to_numpy({k: _full(v) for k, v in got.items()}))
    p = _flatten(params_to_numpy({k: _full(v) for k, v in port.items()}))
    if z is not None:
        assert set(g) == {k[len(prefix):] for k in z if k.startswith(prefix)}
    else:
        assert set(g) == set(p)
    for key, val in g.items():
        want = p[key] if z is None else z[prefix + key]
        t_ = tol * max(1.0, float(np.abs(want).max())) if scale else tol
        np.testing.assert_allclose(val, p[key], atol=t_, rtol=tol,
                                   err_msg=f"{what} {key} vs the port")
        if z is not None:
            np.testing.assert_allclose(
                val, want, atol=t_, rtol=tol,
                err_msg=f"{what} {key} vs the reference")


def _check_local_numel(shd, specs, params):
    """Each placed param's local shard holds the numel its resolved spec
    gives (e.g. half of ``wq`` at model = 2)."""
    sizes = dict(zip(shd.mesh.mesh_dim_names, shd.mesh.shape))
    for name, spec in specs.items():
        x = params[name]
        cut = 1
        for entry in shd.resolve(spec, tuple(x.shape)):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                cut *= sizes[a]
        assert x.to_local().numel() * cut == x.numel(), (name, cut)


def check_model(z, arch, shape):
    from repro_torch.models import transformer as T
    if shape not in _MESHES:
        _MESHES[shape] = mesh_mod.make_host_mesh(shape, device="cpu")
    shd = sharding.Sharder(_MESHES[shape])
    name, kind = MODEL_ARCHS[arch]
    check = {"lm": _check_lm, "colpali": _check_colpali,
             "recsys": _check_recsys, "gnn": _check_pna}[kind]
    torch.manual_seed(0)
    check(z, shd, arch, registry.get(name), f"ms/{arch}/", shape[0], T)


def _train(z, shd, specs, params, batch, bspecs, step, ocfg, pre, g, what,
           scale=False):
    """One train step placed and unplaced from the same state: the loss
    and the new params against the port and the reference."""
    st = opt.init(ocfg, params)
    new0, _, m0 = step(params, st, batch, _Groups(g))
    placed = sharding.shard_tree(shd, specs, params)
    new, st1, m = step(placed, sharding.shard_tree(
        shd, opt.state_specs(specs, ocfg), st),
        sharding.shard_tree(shd, bspecs, batch), shd)
    _check_local_numel(shd, specs, placed)
    _agree(m["loss"], m0["loss"], None if z is None else
           z[f"{pre}g{g}/loss"], FWD_TOL * 5, f"{what} loss")
    _same_params(new, new0, z, f"{pre}g{g}/step/", GRAD_TOL, what, scale)
    return placed


def _check_lm(z, shd, arch, spec, pre, g, T):
    from repro_torch.convert import lm_params_from_numpy
    cfg = spec.smoke_config
    tree = _tree(z, pre + "p/")
    _lm_case(z, shd, arch, cfg,
             lambda: lm_params_from_numpy(tree, cfg, device="cpu"),
             t(z[pre + "in/tokens"]), t(z[pre + "in/targets"]), pre,
             g if cfg.is_moe else 1, T)


def _lm_case(z, shd, arch, cfg, make, tok, tgt, pre, g, T):
    """An LM (``make()`` builds the same model each call) placed by
    ``shd`` against the port's unplaced run and, with ``z``, the
    reference's (``pre``): one train step, the grads, the forward,
    prefill and its caches, and two decode steps (fed the reference's
    greedy tokens, or the unplaced run's without ``z``)."""
    from repro_torch.models import layers as L
    model = make()
    params = T.params_of(model)
    specs = T.param_specs(cfg)
    batch = {"tokens": tok, "targets": tgt}
    ref = ((lambda k: z[f"{pre}g{g}/{k}"]) if z is not None
           else (lambda k: None))
    grp = _Groups(g)
    ocfg = opt.AdamWConfig(moment_dtype="int8" if arch == "kimi" else "fp32")
    placed = _train(z, shd, specs, params, batch, T.batch_specs(),
                    lambda p, o, b, s: T.train_step(model, p, o, b, ocfg,
                                                    shd=s),
                    ocfg, pre, g, arch)
    db = sharding.shard_tree(shd, T.batch_specs(), batch)
    _, _, gr = T.value_and_grad(lambda p: T.loss_fn(
        model, p, tok, tgt, remat=False, shd=grp), params)
    with shd.scope():
        _, _, gr1 = T.value_and_grad(lambda p: T.loss_fn(
            model, p, db["tokens"], db["targets"], remat=False, shd=shd),
            placed)
    _same_params(gr1, gr, z, f"{pre}g{g}/grad/", GRAD_TOL, f"{arch} grad")
    # the serving entry points on the module's own placed weights
    served = T.shard_module(make(), shd, specs)
    with torch.no_grad():
        h, aux, _ = served(db["tokens"], shd=shd)
        h0, aux0, _ = model(tok, shd=grp)
        _agree(h, h0, ref("hidden"), FWD_TOL, f"{arch} forward")
        _agree(aux, aux0, ref("aux"), FWD_TOL, f"{arch} aux")
        prompt = db["tokens"][:, :LM_PROMPT]
        lg, cache = T.prefill(served, prompt, LM_SEQ, shd=shd)
        lg0, cache0 = T.prefill(model, tok[:, :LM_PROMPT], LM_SEQ, shd=grp)
        _agree(lg, lg0, ref("prefill"), FWD_TOL, f"{arch} prefill")
        _agree(cache.k, cache0.k, ref("cache_k"), FWD_TOL, f"{arch} cache k")
        _agree(cache.v, cache0.v, ref("cache_v"), FWD_TOL, f"{arch} cache v")
        for i in range(2):
            feed = (t(ref(f"feed{i}")) if z is not None
                    else lg0.argmax(-1).to(torch.int32))
            lg, cache = T.decode_step(served, sharding.shard_tree(
                shd, ("batch",), feed), cache, LM_PROMPT + i, shd=shd)
            lg0, cache0 = T.decode_step(model, feed, cache0, LM_PROMPT + i,
                                        shd=grp)
            _agree(lg, lg0, ref(f"decode{i}"), FWD_TOL, f"{arch} decode {i}")
    if not cfg.is_moe or shd.mesh.size(0) == 1:
        return
    # one MoE block's dispatch: all-to-alls, no all-gather
    moe = served.blocks[0].moe
    x = sharding.shard_tree(shd, ("tokens", None), torch.randn(
        LM_BATCH * LM_SEQ, cfg.d_model))
    comm, gathers = CommDebugMode(), _Gathers()
    with torch.no_grad(), shd.scope(), comm, gathers:
        L.moe_apply(moe, x, top_k=cfg.moe_top_k, shd=shd)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert counts.get("c10d_functional.all_to_all_single") == 2, counts
    assert not gathers.shapes, gathers.shapes


# F5: attention whose kv heads shard at model = 2, run under this host's
# PyTorch with no reference: each smoke model takes its arch's head
# layout (qwen2-1.5b 12/2, llama4-scout 40/8) at smoke widths, its weights
# and biases drawn from a seed, placed on a (1, 2) mesh against the port's
# own unplaced run (2e-5 forward, 5e-5 grads and the step's params)
F5_ARCHS = {"qwen2": ("qwen2-1.5b", {"n_heads": 12, "n_kv_heads": 2,
                                     "head_dim": 4}),
            "scout": ("llama4-scout-17b-a16e", {"n_heads": 40,
                                                "n_kv_heads": 8,
                                                "head_dim": 4})}
F5_MESH = (1, 2)


def check_f5(arch):
    import dataclasses
    from repro_torch.models import transformer as T
    name, heads = F5_ARCHS[arch]
    cfg = dataclasses.replace(registry.get(name).smoke_config, **heads)

    def make():
        model = T.init(cfg, generator=torch.Generator().manual_seed(11),
                       device="cpu")
        gen = torch.Generator().manual_seed(12)
        with torch.no_grad():       # norms and biases off their 1s and 0s
            for prm in model.parameters():
                if prm.dim() == 1:
                    prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
        return model

    if F5_MESH not in _MESHES:
        _MESHES[F5_MESH] = mesh_mod.make_host_mesh(F5_MESH, device="cpu")
    shd = sharding.Sharder(_MESHES[F5_MESH])
    rng = np.random.default_rng(13)
    tok, tgt = (t(rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ), np.int32))
                for _ in range(2))
    torch.manual_seed(0)
    _lm_case(None, shd, f"f5 {arch}", cfg, make, tok, tgt, None, 1, T)


def _check_colpali(z, shd, arch, spec, pre, g, T):
    from repro_torch.convert import colpali_params_from_numpy
    from repro_torch.models import colpali
    cfg = spec.smoke_config.encoder
    tree = _tree(z, pre + "p/")
    enc = colpali_params_from_numpy(tree, cfg, device="cpu")
    params = T.params_of(enc)
    specs = colpali.param_specs(cfg)
    batch = {k: t(z[f"{pre}in/{k}"]) for k in colpali.batch_specs()}
    ocfg = opt.AdamWConfig()
    _train(z, shd, specs, params, batch, colpali.batch_specs(),
           lambda p, o, b, s: colpali.train_step(enc, p, o, b, ocfg, shd=s),
           ocfg, pre, 1, arch)
    served = T.shard_module(colpali_params_from_numpy(tree, cfg,
                                                      device="cpu"),
                            shd, specs)
    db = sharding.shard_tree(shd, colpali.batch_specs(), batch)
    e, _ = served.encode_doc(db["doc_patches"], db["doc_mask"], shd=shd)
    q, _ = served.encode_query(db["query_tokens"], db["query_mask"],
                               shd=shd)
    e0, _ = enc.encode_doc(batch["doc_patches"], batch["doc_mask"])
    q0, _ = enc.encode_query(batch["query_tokens"], batch["query_mask"])
    _agree(e, e0, z[pre + "g1/doc"], FWD_TOL, "encode_doc")
    _agree(q, q0, z[pre + "g1/query"], FWD_TOL, "encode_query")


def _check_recsys(z, shd, arch, spec, pre, g, T):
    from repro_torch.convert import recsys_params_from_numpy
    from repro_torch.models import recsys
    cfg = spec.smoke_config
    model = recsys_params_from_numpy(_tree(z, pre + "p/"), cfg,
                                     device="cpu")
    params = T.params_of(model)
    specs = recsys.param_specs(cfg)
    bspecs = recsys.batch_specs(cfg)
    batch = {k: t(z[f"{pre}in/{k}"]) for k in bspecs}
    ocfg = opt.AdamWConfig()
    placed = _train(z, shd, specs, params, batch, bspecs,
                    lambda p, o, b, s: recsys.train_step(p, o, b, cfg, ocfg,
                                                         shd=s),
                    ocfg, pre, 1, arch)
    db = sharding.shard_tree(shd, bspecs, batch)
    with torch.no_grad():
        _agree(recsys.forward(placed, db, cfg, shd),
              recsys.forward(params, batch, cfg), z[pre + "g1/forward"],
              FWD_TOL, f"{arch} forward")
    user = {k: v[:1] for k, v in batch.items() if k != "label"}
    cand = t(z[pre + "in/cand"])
    got = recsys.score_candidates(placed, user, sharding.shard_tree(
        shd, ("candidate",), cand), cfg, shd)
    _agree(got, recsys.score_candidates(params, user, cand, cfg),
          z[pre + "g1/cand"], FWD_TOL, f"{arch} candidates")
    # a row-sharded table lookup gathers no table (only ids, and the
    # candidates' activations onto "batch")
    gathers = _Gathers()
    with torch.no_grad(), shd.scope(), gathers:
        recsys.forward(placed, db, cfg, shd)
        recsys.score_candidates(placed, user, sharding.shard_tree(
            shd, ("candidate",), cand), cfg, shd)
    tables = {tuple(placed[f"tables.{i}"].to_local().shape)
              for i in range(cfg.n_sparse)}
    assert not tables & set(gathers.shapes), (gathers.shapes, tables)


def _check_pna(z, shd, arch, spec, pre, g, T):
    from repro_torch.convert import pna_params_from_numpy
    from repro_torch.models import gnn
    cfg = spec.smoke_config
    model = pna_params_from_numpy(_tree(z, pre + "p/"), cfg, device="cpu")
    params = T.params_of(model)
    batch = {k[len(pre + "in/"):]: t(z[k]) for k in z
             if k.startswith(pre + "in/")}
    ocfg = opt.AdamWConfig()
    placed = _train(z, shd, gnn.param_specs(cfg), params, batch,
                    gnn.batch_specs(batch),
                    lambda p, o, b, s: gnn.train_step(p, o, b, cfg, ocfg,
                                                      shd=s),
                    ocfg, pre, 1, arch, scale=True)
    db = sharding.shard_tree(shd, gnn.batch_specs(batch), batch)
    _, _, gr = T.value_and_grad(lambda p: gnn.loss_fn(p, batch, cfg), params)
    with shd.scope():
        _, _, gr1 = T.value_and_grad(lambda p: gnn.loss_fn(p, db, cfg, shd),
                                     placed)
    _same_params(gr1, gr, z, pre + "g1/grad/", GRAD_TOL, "pna grad",
                 scale=True)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the dry run's fake trace against the real program
# ---------------------------------------------------------------------------

# one cell per family at smoke widths, its dims cut for a real CPU run
DRYRUN_WORLD = 4
DRYRUN_CELLS = (
    ("qwen2-1.5b", "train_4k", {"seq_len": 32, "global_batch": 4}),
    ("llama4-scout-17b-a16e", "decode_32k",
     {"seq_len": 64, "global_batch": 4}),
    ("pna", "molecule", {}),
    ("dlrm-mlperf", "serve_p99", {"batch": 64}),
    ("dien", "retrieval_cand", {"n_candidates": 64}),
    ("colpali-hpc", "serve_query", {"queries": 8, "corpus": 2048}),
)
FAKE_TRACES = "fake_traces.json"
_WORKDIR = []


def _dryrun_cell(arch, shape):
    import dataclasses
    dims = next(d for a, s, d in DRYRUN_CELLS if (a, s) == (arch, shape))
    spec = registry.get(arch)
    cell = next(c for c in spec.shapes if c.name == shape)
    return spec, dataclasses.replace(cell, dims={**cell.dims, **dims})


def _dryrun_counts(m) -> dict:
    return {"flops": m["flops"], "collectives": m["coll_each"],
            "argument_bytes_each": m["argument_bytes_each"],
            "peak": m["argument_bytes"] + m["peak_above_args"]}


def fake_traces(path: Path) -> None:
    """Each DRYRUN_CELLS cell traced on fake tensors as rank 0 of a fake
    group of DRYRUN_WORLD ranks on the (2, 2) mesh, as the dry run traces
    a production mesh; its counts written to ``path``. Run in a process
    of its own (it opens the default group)."""
    from repro_torch.launch import dryrun
    mesh_mod.open_fake_group(DRYRUN_WORLD)
    mesh = mesh_mod.make_host_mesh(MESH[DRYRUN_WORLD], device="cpu")
    out = {}
    for arch, shape, _ in DRYRUN_CELLS:
        spec, cell = _dryrun_cell(arch, shape)
        out[f"{arch}/{shape}"] = _dryrun_counts(dryrun.trace_cell(
            spec, cell, mesh, smoke=True, device="cpu"))
    path.write_text(json.dumps(out))
    dist.destroy_process_group()


def check_dryrun(mesh, arch, shape):
    """The cell's step run for real on every rank (arguments drawn from
    one seed, placed by their specs): rank 0's recorded FLOPs,
    collectives (kind, bytes and calls) and argument bytes equal the fake
    trace's, and rank 0's peak is the largest of the ranks' peaks."""
    from repro_torch.launch import dryrun
    spec, cell = _dryrun_cell(arch, shape)
    got = _dryrun_counts(dryrun.trace_cell(spec, cell, mesh, smoke=True,
                                           device="cpu", fake=False,
                                           seed=5))
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, got["peak"])
    if dist.get_rank() != 0:
        return
    want = json.loads((_WORKDIR[0].parent / FAKE_TRACES).read_text())[
        f"{arch}/{shape}"]
    for key in ("flops", "collectives", "argument_bytes_each"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["peak"] == max(peaks), peaks


SUITES = {"dist": cases, "live": live_cases,
          "follower_gone": lambda world: [
              ("follower_gone", lambda z, m: check_follower_gone(m))],
          "f5": lambda world: [(f"f5_{a}", lambda z, m, a=a: check_f5(a))
                               for a in F5_ARCHS]}
NO_INPUTS = ("f5", "follower_gone")


def main(rank: int, world: int, workdir: Path, suite: str = "dist") -> int:
    _WORKDIR.append(workdir)
    if world == 1:
        mesh_mod.open_local_group("cpu")
    else:
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir / 'rendezvous'}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60))
    mesh = mesh_mod.make_host_mesh(MESH[world], device="cpu")
    results = {}
    z = {}
    if suite not in NO_INPUTS:
        with np.load(workdir.parent / "inputs.npz") as npz:
            z = {k: npz[k] for k in npz.files}
    code = 0
    for name, check in SUITES[suite](world):
        try:
            check(z, mesh)
            results[name] = "ok"
        except BaseException:
            results[name] = traceback.format_exc()
            code = 1
            break
    (workdir / f"rank{rank}.json").write_text(json.dumps(results))
    if code == 0 and suite != "follower_gone":
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]),
                  *sys.argv[4:5]))

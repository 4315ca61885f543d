"""The primitives of placed mutation and serving, on the CPU.

* The id -> position map that ``add``, ``delete`` and ``compact`` update
  on the host from the delta's ids, the new segment's slots and the killed
  positions equals ``rebuild_pos_of_id`` of the mutated segments, after
  every step of a lifecycle, for all six backends (each cascade member).
* On a one-rank gloo mesh, the map of a placed state after the same
  lifecycle equals ``rebuild_pos_of_id`` of its segments taken whole, and
  every search equals the unplaced state's (worlds 2 and 4 run on gloo
  ranks in ``tests/test_torch_dist_live.py``).
* ``dist.collectives``' operation header round-trips every operation a
  ``LiveIndexSession`` broadcasts (searches at each level, adds with and
  without ids, deletes, compactions, the stop), with every dtype a state
  or a query carries; ``broadcast_op`` on one rank hands the tensors back.

The reference has no placed mutation to hold these to (ROADMAP caveat
C11: its ``add`` raises on a placed state); the unplaced mutation they
equal is held to the reference's in ``tests/test_torch_segments.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import index as index_mod
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import full_tensor, local
from repro_torch.retrieval.base import state_map
from tests import _torch_dist_ranks as ranks

BACKENDS = ranks.BACKENDS


def _maps(r, state):
    """(pos_of_id, the map rebuilt from the segments taken whole) of every
    member of ``state``."""
    out = []
    for be, view in ranks._members(r, state):
        seg = be._segmented(view)
        whole = tuple(type(p)(*(full_tensor(x) for x in p))
                      for p in seg.segments)
        lives = tuple(full_tensor(lv) for lv in seg.live)
        out.append((local(seg.pos_of_id), index_mod.rebuild_pos_of_id(
            whole, lives, seg.pos_of_id.shape[0])))
    return out


def _lifecycle(r):
    """Two adds under fresh ids, upserts, deletes, an add after them and a
    compaction, as (name, op)."""
    corpus, _ = ranks._corpus(96)
    steps = list(ranks._mut_steps(r))
    steps.insert(3, ("add again", lambda st: r.add(
        st, ranks._rows(corpus, 80, 88), doc_ids=np.arange(88, 96) * 3)))
    return steps


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("variant", ranks.MUT_VARIANTS)
def test_host_map_equals_rebuild_pos_of_id(backend, variant):
    r, state, _ = ranks._state(backend, ranks.MUT_VARIANTS[variant])
    for name, op in _lifecycle(r):
        state = op(state)
        for got, want in _maps(r, state):
            assert got.dtype == want.dtype == torch.int32
            assert torch.equal(got, want), (backend, variant, name)


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch import mesh as mesh_mod
    opened = not dist.is_initialized()
    mesh_mod.open_local_group("cpu")
    yield mesh_mod.make_host_mesh((1, 1), device="cpu")
    if opened:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("variant", ranks.MUT_VARIANTS)
def test_placed_map_equals_rebuild_of_the_whole_state(mesh, backend,
                                                      variant):
    from torch.distributed.tensor import DTensor
    r, state, q = ranks._state(backend, ranks.MUT_VARIANTS[variant])
    placed = r.shard(state, mesh)
    for name, op in _lifecycle(r):
        state, placed = op(state), op(placed)
        leaves = []
        state_map(leaves.append, placed)
        assert all(isinstance(x, DTensor) for x in leaves), name
        for got, want in _maps(r, placed):
            assert torch.equal(got, want), (backend, variant, name)
        for k in ranks.VARIANT_K[ranks.MUT_VARIANTS[variant]]:
            ranks._same(r.search(placed, q, k=k), r.search(state, q, k=k),
                        f"{backend} {variant} {name} k={k}")


def _q(b=3, mq=5, d=16):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((b, mq, d), generator=g), torch.rand(
        (b, mq), generator=g) < 0.7, torch.rand((b, mq), generator=g))


def _delta():
    g = torch.Generator().manual_seed(1)
    return (torch.randn((4, 6, 16), generator=g),
            torch.ones((4, 6), dtype=torch.bool), torch.rand((4, 6),
                                                             generator=g))


OPS = {
    "search level 0": ("search", {"level": 0}, _q()),
    "search level 2": ("search", {"level": 2}, _q(1, 32, 128)),
    "add": ("add", {"doc_ids": False}, _delta()),
    "upsert": ("add", {"doc_ids": True},
               _delta() + (torch.tensor([3, 9, 2, 70]),)),
    "delete": ("delete", {}, (torch.tensor([5, 1 << 40]),)),
    "compact": ("compact", {}, ()),
    "stop": ("stop", {}, ()),
    "every dtype": ("search", {"level": 1}, (
        torch.zeros((2, 3), dtype=torch.uint16), torch.ones(
            (), dtype=torch.bfloat16), torch.zeros((0, 4)),
        torch.arange(6, dtype=torch.uint8).reshape(2, 3),
        torch.tensor([True, False]))),
}


@pytest.mark.parametrize("name", OPS)
def test_header_round_trips_every_operation(name):
    op, meta, tensors = OPS[name]
    got_op, got_meta, specs = coll.decode_header(
        coll.encode_header(op, meta, tensors))
    assert (got_op, got_meta) == (op, meta)
    assert specs == [(t.dtype, tuple(t.shape)) for t in tensors]


@pytest.mark.parametrize("name", OPS)
def test_broadcast_op_on_one_rank_hands_the_tensors_back(mesh, name):
    op, meta, tensors = OPS[name]
    got_op, got_meta, got = coll.broadcast_op(mesh, op, meta, tensors)
    assert (got_op, got_meta) == (op, meta)
    assert len(got) == len(tensors)
    for a, b in zip(got, tensors):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert torch.equal(_bytes(a), _bytes(b))


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def test_only_the_mesh_s_other_ranks_follow():
    from repro_torch.serving import LiveIndexSession, ServeConfig
    r, state, _ = ranks._state("flat", "k_past_share")
    sess = LiveIndexSession(r, state, ServeConfig(max_batch=2, top_k=5),
                            device="cpu")
    try:
        assert sess.leader and sess.server is not None
        with pytest.raises(RuntimeError, match="only the other ranks"):
            sess.follow()
    finally:
        sess.close()

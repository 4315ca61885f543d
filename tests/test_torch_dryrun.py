"""Cells and the dry run (``repro_torch.launch.cells``, ``launch.dryrun``).

  * ``build_cell`` succeeds for every (arch, shape) of the registry at the
    smoke configs on ``device="cpu"`` under a ``FakeTensorMode`` (nothing
    allocated), with ``meta["model_flops"]`` equal to the reference's
    MODEL_FLOPS formulas (``repro.launch.cells``) for the same cell;
  * forward-only cells at reduced dims: ``FlopCounterMode`` on the fake
    trace equals the count on a real CPU run of the same step;
  * the two-depth extrapolation equals the full trace at a small depth;
  * a record at world size 1 (no collective, ``fits``, roofline terms);
  * ``registry.ASSIGNED`` equals the reference's;
  * the ring model over hand-made records of every collective op the
    recorder sees (the functional and the in-place c10d ops), and over a
    recorded trace of ``dist.collectives`` on a fake (2, 2) group, against
    a reckoning written beside each assertion.

The production meshes are ``tests/test_torch_dryrun_meshes.py``'s.
Tolerance: exact (FLOP and byte counts are integers).
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.launch import cells, dryrun
from repro_torch.launch import mesh as mesh_mod

ALL = [(a, c.name) for a, c in registry.all_cells(include_skipped=True)]


@pytest.fixture(scope="module")
def ref_mesh():
    from repro.launch.mesh import make_host_mesh
    return make_host_mesh()


def _ref_model_flops(arch: str, shape: str, mesh) -> float:
    ref_cells = importlib.import_module("repro.launch.cells")
    from repro.configs import registry as ref_registry
    spec = ref_registry.get(arch)
    cell = next(c for c in spec.shapes if c.name == shape)
    if spec.family == "lm":
        return ref_cells._lm_model_flops(spec.smoke_config, cell)
    return ref_cells.build_cell(spec, cell, mesh, smoke=True).meta[
        "model_flops"]


@pytest.mark.parametrize("arch,shape", ALL)
def test_build_cell_every_cell_at_smoke(arch, shape, ref_mesh):
    spec = registry.get(arch)
    cell = next(c for c in spec.shapes if c.name == shape)
    mesh = dryrun._world_mesh("cpu") if cell.kind == "search" else None
    with FakeTensorMode():
        built = cells.build_cell(spec, cell, mesh, smoke=True, device="cpu")
        leaves = [t for t in torch.utils._pytree.tree_leaves(built.args)
                  if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    assert built.placements["device"] == "cpu"
    assert built.meta["model_flops"] == _ref_model_flops(arch, shape,
                                                         ref_mesh)


def test_assigned_equals_reference():
    from repro.configs import registry as ref_registry
    assert registry.ASSIGNED == ref_registry.ASSIGNED
    assert "colpali-hpc" not in registry.ASSIGNED
    assert len(list(registry.all_cells())) == 39
    assert len(list(registry.all_cells(include_skipped=True))) == 43


def _small(arch, shape, **dims):
    spec = registry.get(arch)
    cell = next(c for c in spec.shapes if c.name == shape)
    return spec, dataclasses.replace(cell, dims={**cell.dims, **dims})


FORWARD = [
    ("qwen2-1.5b", "prefill_32k", {"seq_len": 64, "global_batch": 2}),
    ("qwen2-1.5b", "decode_32k", {"seq_len": 64, "global_batch": 2}),
    ("llama4-scout-17b-a16e", "prefill_32k",
     {"seq_len": 32, "global_batch": 2}),
    ("dlrm-mlperf", "serve_p99", {"batch": 64}),
    ("dcn-v2", "serve_p99", {"batch": 64}),
    ("din", "serve_p99", {"batch": 32}),
    ("dien", "serve_p99", {"batch": 16}),
    ("dcn-v2", "retrieval_cand", {"n_candidates": 128}),
    ("din", "retrieval_cand", {"n_candidates": 64}),
    ("colpali-hpc", "encode_corpus", {"global_batch": 2}),
    ("colpali-hpc", "serve_query", {"queries": 8, "corpus": 2048}),
]


@pytest.mark.parametrize("arch,shape,dims", FORWARD)
def test_fake_flops_equal_a_real_cpu_run(arch, shape, dims):
    spec, cell = _small(arch, shape, **dims)
    mesh = dryrun._world_mesh("cpu") if cell.kind == "search" else None
    fake = dryrun.trace_cell(spec, cell, mesh, smoke=True, device="cpu")
    built = cells.build_cell(spec, cell, mesh, smoke=True, device="cpu",
                             fake=False, seed=3)
    fc = FlopCounterMode(display=False)
    with torch.no_grad(), fc:
        out = built.fn(*built.args)
    assert out is not None
    assert fake["counter_flops"] == fc.get_total_flops() > 0
    assert fake["kernel_flops"] == 0          # the CPU runs no kernel


@pytest.mark.parametrize("shape,dims", [
    ("train_4k", {"seq_len": 32, "global_batch": 2}),
    ("prefill_32k", {"seq_len": 64, "global_batch": 2}),
    ("decode_32k", {"seq_len": 64, "global_batch": 2}),
])
def test_extrapolation_equals_the_full_trace_at_small_depth(shape, dims):
    spec, cell = _small("qwen2-1.5b", shape, **dims)
    cfg = dataclasses.replace(spec.smoke_config, n_layers=5)
    spec = dataclasses.replace(spec, config=cfg, smoke_config=cfg)
    full = dryrun.exact_cost_metrics(spec, cell, smoke=True, device="cpu",
                                     extrapolate=False)
    extr = dryrun.exact_cost_metrics(spec, cell, smoke=True, device="cpu",
                                     extrapolate=True)
    assert full["source"] == "full depth"
    assert extr["source"] == "extrapolated from L=2,3 to 5"
    for key in ("flops", "counter_flops", "bytes", "argument_bytes",
                "output_bytes"):
        assert extr[key] == full[key], key
    assert extr["meta"] == full["meta"]
    # the peak is the largest phase's live bytes: exact while one phase
    # holds it at every depth (prefill, decode); a train step's moves from
    # the backward to the optimizer between 3 and 5 layers at this size,
    # so its extrapolated peak is an estimate (the dry run says so, and
    # the card's comparisons use fully traced cells)
    if shape != "train_4k":
        assert extr["peak_above_args"] == full["peak_above_args"]
    else:
        assert extr["peak_source"].startswith("extrapolated")


# in a process of its own: a fake group is its default group
_FAKE_EXTRAPOLATION = """
import dataclasses, json, sys
from repro_torch.configs import registry
from repro_torch.launch import dryrun, mesh as mesh_mod
shape, dims = sys.argv[1], json.loads(sys.argv[2])
spec = registry.get("qwen2-1.5b")
cell = next(c for c in spec.shapes if c.name == shape)
cell = dataclasses.replace(cell, dims={**cell.dims, **dims})
cfg = dataclasses.replace(spec.smoke_config, n_layers=5)
spec = dataclasses.replace(spec, config=cfg, smoke_config=cfg)
mesh_mod.open_fake_group(4)
mesh = mesh_mod.make_host_mesh((2, 2), device="cpu")
out = {}
for name, ex in (("full", False), ("extr", True)):
    m = dryrun.exact_cost_metrics(spec, cell, mesh, smoke=True,
                                  device="cpu", extrapolate=ex)
    out[name] = {k: m[k] for k in (
        "source", "flops", "counter_flops", "bytes", "argument_bytes",
        "output_bytes", "coll", "coll_each", "links", "peak_above_args")}
print(json.dumps(out))
"""


@pytest.mark.parametrize("shape,dims", [
    ("train_4k", {"seq_len": 32, "global_batch": 4}),
    ("decode_32k", {"seq_len": 64, "global_batch": 4}),
])
def test_extrapolation_equals_the_full_trace_on_a_fake_mesh(shape, dims):
    """Rank 0 of a fake (2, 2) group: FLOPs, bytes and every collective's
    bytes and calls are affine in depth, so two depths give the full
    trace's exactly."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _FAKE_EXTRAPOLATION, shape,
                          json.dumps(dims)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    full, extr = got["full"], got["extr"]
    assert full["source"] == "full depth"
    assert extr["source"] == "extrapolated from L=2,3 to 5"
    assert full["coll"]["count"] > 0
    for key in ("flops", "counter_flops", "bytes", "argument_bytes",
                "output_bytes", "coll", "coll_each", "links"):
        assert extr[key] == full[key], key
    if shape != "train_4k":      # see the world-size-1 case above
        assert extr["peak_above_args"] == full["peak_above_args"]


def test_run_cell_record_at_world_size_one():
    rec = dryrun.run_cell("dcn-v2", "serve_p99", smoke=True, device="cpu")
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["collective_bytes_per_dev"]["count"] == 0
    assert rec["roofline"]["collective_s"] == 0.0
    mem = rec["mem"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits"] and mem["hbm_bytes"] == 80 * 2 ** 30
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["flops_per_dev"] == rec["counter_flops"]
    skipped = dryrun.run_cell("glm4-9b", "long_500k", device="cpu")
    assert skipped["status"] == "skipped"


def test_cli_lists_every_cell(capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 43
    assert sum("SKIP" in ln for ln in lines) == 4


def _out(shape, nbytes, alias=False):
    return (shape, torch.float32, nbytes, alias, False)


def test_ring_model_counts_collectives():
    from repro_torch.analysis.jaxpr_budget import OpRecord
    ops = [OpRecord("all_reduce", (_out((4,), 16),), (), 2),
           OpRecord("all_gather_into_tensor", (_out((8,), 32),), ()),
           OpRecord("mm", (_out((2, 2), 16),), ()),
           # the in-place c10d ops return their tensors once, aliased to
           # the inputs: allreduce_ of a (4,) tensor in a group of ranks
           # 0-7, allgather_ of 2 x (8,) parts over ranks 0 and 16
           OpRecord("allreduce_", (_out((4,), 16, True),), (),
                    group=tuple(range(8))),
           OpRecord("allgather_", (_out((8,), 32, True),
                                   _out((8,), 32, True)), (),
                    group=(0, 16)),
           OpRecord("alltoall_base_", (_out((6,), 24, True),), (),
                    group=(0, 1)),
           OpRecord("broadcast_", (_out((3,), 12, True),), (), 3,
                    group=(0, 8)),
           OpRecord("wait_tensor", (_out((8,), 32),), ())]
    c = dryrun.collective_bytes(ops)
    # all-reduce: 2 x 16 B x 2 calls + 2 x 16 B; all-gather: 32 + 2 x 32;
    # all-to-all 24; broadcast 3 calls of 12 B
    assert c["all-reduce"] == 2 * 16 * 2 + 2 * 16
    assert c["all-gather"] == 32 + 2 * 32
    assert c["all-to-all"] == 24 and c["broadcast"] == 3 * 12
    assert c["count"] == 2 + 1 + 1 + 1 + 1 + 3
    # no group, or one within a node of 8 ranks: NVLink; ranks 0 and 16,
    # 0 and 8: InfiniBand
    links = dryrun.collective_links(ops)
    assert links == {"nvlink": 64 + 32 + 32 + 24, "ib": 64 + 36}
    assert dryrun.collective_seconds(links) == (
        152 / mesh_mod.NVLINK_BW_PER_DIRECTION
        + 100 / mesh_mod.IB_BW_PER_DIRECTION)
    assert jax.__name__ == "jax"          # the reference is importable


# one process of its own: the fake group is its default group
_FAKE_COLLECTIVES = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.analysis.jaxpr_budget import Recorder
from repro_torch.dist import collectives
from repro_torch.launch import dryrun, mesh as mesh_mod
mesh_mod.open_fake_group(4)
mesh = mesh_mod.make_host_mesh((2, 2), device="cpu")
with FakeTensorMode():
    x = torch.empty((8, 3), dtype=torch.float32)
    ids = torch.empty((8, 3), dtype=torch.int16)
    rec = Recorder()
    with rec:
        rec.mark()
        g = collectives.all_gather_axes(x, mesh, ("data", "model"), dim=1)
        collectives.all_gather_axes(ids, mesh, ("model",))
        collectives.all_reduce_axes(x, mesh, ("data", "model"))
        collectives.broadcast_axes(x, mesh, ("model",))
print(json.dumps({"shape": list(g.shape),
                  "coll": dryrun.collective_bytes(rec.ops),
                  "links": dryrun.collective_links(rec.ops),
                  "groups": sorted({r.group for r in rec.ops if r.group})}))
"""


def test_recorded_collectives_on_a_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _FAKE_COLLECTIVES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["shape"] == [8, 12]
    x = 8 * 3 * 4                 # one rank's (8, 3) float32 block
    # all_gather_axes over ("data", "model"), the minor axis first: 2
    # blocks over "model", then 2 of those over "data"; the int16 ids
    # cross as uint8 (8, 3, 2) blocks, 2 over "model"; all_reduce_axes
    # reduces x over each axis in turn, 2x its size each (ring model);
    # broadcast_axes sends x once over "model"
    want_ag = 2 * x + 2 * (2 * x) + 2 * (8 * 3 * 2)
    assert got["coll"]["all-gather"] == want_ag
    assert got["coll"]["all-reduce"] == 2 * (2 * x)
    assert got["coll"]["broadcast"] == x
    assert got["coll"]["count"] == 2 + 1 + 2 + 1
    # rank 0's groups: "model" = ranks 0, 1 and "data" = ranks 0, 2, both
    # within one node of 8
    assert got["groups"] == [[0, 1], [0, 2]]
    assert got["links"] == {"nvlink": want_ag + 4 * x + x, "ib": 0}

"""Cells and the dry run (``repro_torch.launch.cells``, ``launch.dryrun``).

  * ``build_cell`` succeeds for every (arch, shape) of the registry at the
    smoke configs on ``device="cpu"`` under a ``FakeTensorMode`` (nothing
    allocated), with ``meta["model_flops"]`` equal to the reference's
    MODEL_FLOPS formulas (``repro.launch.cells``) for the same cell;
  * forward-only cells at reduced dims: ``FlopCounterMode`` on the fake
    trace equals the count on a real CPU run of the same step;
  * the two-depth extrapolation equals the full trace at a small depth;
  * a record at world size 1 (no collective, ``fits``, roofline terms);
  * ``registry.ASSIGNED`` equals the reference's; the production meshes
    raise NotImplementedError naming ROADMAP.md §A item 4.

Tolerance: exact (FLOP and byte counts are integers).
"""
import dataclasses
import importlib

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.launch import cells, dryrun

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


def test_production_meshes_wait_for_model_sharding():
    for mesh in ("single", "multi"):
        with pytest.raises(NotImplementedError, match="§A item 4"):
            dryrun.run_cell("qwen2-1.5b", "train_4k", mesh=mesh,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="§A item 4"):
        dryrun.main(["--all", "--mesh", "multi", "--device", "cpu"])


def test_cli_lists_every_cell(capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 43
    assert sum("SKIP" in ln for ln in lines) == 4


def test_ring_model_counts_collectives():
    from repro_torch.analysis.jaxpr_budget import OpRecord
    ops = [OpRecord("all_reduce", (((4,), torch.float32, 16, False,
                                     False),), (), 2),
           OpRecord("all_gather_into_tensor", (((8,), torch.float32, 32,
                                                False, False),), ()),
           OpRecord("mm", (((2, 2), torch.float32, 16, False, False),), ())]
    c = dryrun.collective_bytes(ops)
    assert c["all-reduce"] == 2 * 16 * 2 and c["all-gather"] == 32
    assert c["count"] == 3
    assert jax.__name__ == "jax"          # the reference is importable

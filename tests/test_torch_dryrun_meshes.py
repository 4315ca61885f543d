"""The dry run at the production meshes (``repro_torch.launch.dryrun
--mesh single|multi``): rank 0 of a fake 256- or 512-rank process group.

  * every non-skipped cell at the smoke configs, on (16, 16) and (2, 16,
    16): rank 0's argument bytes, argument by argument, equal the
    reference's per-device bytes (``repro.launch.cells.build_cell`` on
    512 forced host devices, each argument's ``in_shardings`` shard shape
    x itemsize summed over its leaves; nothing is lowered, caveat C3 of
    ROADMAP.md), and MODEL_FLOPS equal the reference's, with the
    differences by design of ROADMAP.md §C named where they arise: the
    decode step's position is a Python int in the port, the recsys serve
    batch carries no label, the reference's prefill cells fail to build
    under this JAX (their params and tokens are read from its train
    cell's), and serve_query is a ``shard_map`` whose corpus is sharded
    over every axis (its bytes reckoned from those specs, at the
    reference's int32 codes and float32 masks against the port's uint8
    and bool);
  * ``run_cell`` on both meshes for one cell per family (spawned
    workers, each opening its own fake group): ``ok``, 256 or 512 chips,
    rank 0, MODEL_FLOPS per device, collectives priced on InfiniBand
    (every group of both meshes crosses nodes), serve_query's all-gathers
    against a reckoning;
  * the CLI with ``--mesh both`` exits 0.

The port's side runs in processes of its own: a fake group is its
process's default group. Tolerance: exact (byte and FLOP counts are
integers).
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

from tests.conftest import run_subprocess

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [(a, c.name) for a, c in registry.all_cells()]
CHIPS = {"single": 256, "multi": 512}

# per cell and mesh: for each argument, {leaf path: [per-device bytes,
# itemsize]}, and MODEL_FLOPS
_REFERENCE = """
import json, math
import jax
from repro.configs import registry
from repro.launch import cells
from repro.launch.mesh import make_production_mesh

def leaves(arg, sharding, whole=False, chips=1):
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(arg)[0]
    shs = ([None] * len(flat) if sharding is None else
           jax.tree.leaves(sharding, is_leaf=lambda x: isinstance(
               x, jax.sharding.Sharding)))
    for (path, sds), sh in zip(flat, shs):
        shape = (sh.shard_shape(sds.shape) if sh is not None else
                 sds.shape)
        n = math.prod(shape) // (1 if whole else chips)
        out[jax.tree_util.keystr(path)] = [n * sds.dtype.itemsize,
                                           sds.dtype.itemsize]
    return out

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    chips = mesh.devices.size
    for arch, cell in registry.all_cells():
        spec = registry.get(arch)
        key = f"{arch}/{cell.name}/{chips}"
        try:
            b = cells.build_cell(spec, cell, mesh, smoke=True)
        except ValueError as e:
            out[key] = {"error": repr(e), "model_flops":
                        cells._lm_model_flops(spec.smoke_config, cell)}
            continue
        if b.in_shardings is None:
            # the shard_map search: codes, masks, ids sharded over every
            # axis (in_specs), the rest replicated
            each = [leaves(a, None, whole=i not in (2, 3, 4), chips=chips)
                    for i, a in enumerate(b.args)]
        else:
            each = [leaves(a, s) for a, s in zip(b.args, b.in_shardings)]
        out[key] = {"each": each, "model_flops": b.meta["model_flops"]}
print(json.dumps(out))
"""

_PORT = """
import json
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import registry
from repro_torch.launch import cells, dryrun, mesh as mesh_mod

out = {}
for name, chips in (("single", 256), ("multi", 512)):
    mesh_mod.open_fake_group(chips)
    mesh = mesh_mod.make_production_mesh(multi_pod=name == "multi",
                                         device="cpu")
    for arch, cell in registry.all_cells():
        with FakeTensorMode():
            b = cells.build_cell(registry.get(arch), cell, mesh, smoke=True,
                                 device="cpu")
            each = []
            for a in b.args:
                flat = torch.utils._pytree.tree_flatten_with_path(a)[0]
                each.append({
                    torch.utils._pytree.keystr(p): [dryrun._tree_bytes(t),
                                                    t.element_size()]
                    for p, t in flat if isinstance(t, torch.Tensor)})
            out[f"{arch}/{cell.name}/{chips}"] = {
                "each": each, "total": [dryrun._tree_bytes(a)
                                        for a in b.args],
                "model_flops": b.meta["model_flops"]}
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    return json.loads(run_subprocess(_REFERENCE, n_devices=512,
                                     timeout=600).strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PORT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _total(arg) -> int:
    return sum(b for b, _ in arg.values())


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_the_reference(arch, shape, mesh, reference,
                                            port):
    chips = CHIPS[mesh]
    key = f"{arch}/{shape}/{chips}"
    got, want = port[key], reference[key]
    # a DTensor's leaves are its local shards: no argument counts a
    # storage twice
    assert got["total"] == [_total(a) for a in got["each"]]
    kind = next(c.kind for c in registry.get(arch).shapes if c.name == shape)
    if "error" in want:
        # the reference's prefill cell fails to build under this JAX
        # (caveat C3): its params and tokens are its train cell's
        assert kind == "prefill", want["error"]
        train = reference[f"{arch}/train_4k/{chips}"]
        want = {"each": [train["each"][0],
                         {"": train["each"][2]["['tokens']"]}],
                "model_flops": want["model_flops"]}
    assert got["model_flops"] == want["model_flops"]
    ref_each = want["each"]
    if kind == "decode":
        # the reference passes the position as a 0-d int32 argument, the
        # port as a Python int
        assert list(ref_each[3].values()) == [[4, 4]]
        ref_each = ref_each[:3]
    if kind == "serve":
        # the reference's serve batch carries the label its step never
        # reads; the port's has none
        ref_each = [ref_each[0], {k: v for k, v in ref_each[1].items()
                                  if k != "['label']"}]
    if kind == "search":
        # int32 codes and float32 query and doc masks in the reference,
        # uint8 codes and bool masks in the port: the same elements
        for g, w in zip(got["each"], ref_each):
            (gb, gi), = g.values()
            (wb, wi), = w.values()
            assert gb * wi == wb * gi, (gb, gi, wb, wi)
        return
    assert [_total(a) for a in got["each"]] == [_total(a) for a in ref_each]


def _record(recs, arch, shape, mesh):
    return next(r for r in recs if (r["arch"], r["shape"], r["mesh"])
                == (arch, shape, mesh))


# one cell per family
FAMILY_CELLS = [("qwen2-1.5b", "decode_32k"), ("pna", "molecule"),
                ("dcn-v2", "serve_p99"), ("colpali-hpc", "serve_query")]


@pytest.fixture(scope="module")
def records():
    return {mesh: dryrun.run_cells(FAMILY_CELLS, workers=2, smoke=True,
                                   device="cpu", mesh=mesh)
            for mesh in ("single", "multi")}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_run_cell_on_a_production_mesh(arch, shape, mesh, records):
    rec = _record(records[mesh], arch, shape, mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    chips = CHIPS[mesh]
    assert rec["chips"] == chips and rec["rank"] == 0
    assert tuple(rec["mesh_shape"]) == dryrun.MESHES[mesh][0]
    r = rec["roofline"]
    assert r["model_flops_per_dev"] == rec["meta"]["model_flops"] / chips
    assert r["useful_flops_ratio"] == \
        r["model_flops_per_dev"] / rec["flops_per_dev"]
    mem = rec["mem"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits"] and mem["argument_bytes"] == sum(
        mem["argument_bytes_each"])
    coll = rec["collective_bytes_per_dev"]
    total = sum(v for k, v in coll.items() if k != "count")
    assert coll["count"] > 0 and total > 0
    # every group of both meshes spans 16 ranks, or strides by 16
    assert rec["collective_bytes_by_link"] == {"nvlink": 0, "ib": total}
    assert r["collective_s"] == total / mesh_mod.IB_BW_PER_DIRECTION \
        == r["collective_s_all_ib"]
    if shape == "serve_query":
        # rank 0's top-8 lists of 64 queries, scores (float32) and ids
        # (int32), all-gathered over the minor axis, then each wider
        # list over the next: 16 lists, then 16 x 16 (and 2 x 256 on the
        # pods' axis)
        lst = 64 * 8 * 4
        widths = [16, 256] if mesh == "single" else [16, 256, 512]
        assert coll["all-gather"] == 2 * lst * sum(widths)
        assert coll["count"] == 2 * len(widths)
        assert mem["argument_bytes_each"][2] == 4_194_304 // chips * 10


def test_cli_runs_both_meshes(capsys):
    assert dryrun.main(["--arch", "dcn-v2", "--shape", "serve_p99",
                        "--mesh", "both", "--smoke", "--device",
                        "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dcn-v2/serve_p99/single" in out and \
        "dcn-v2/serve_p99/multi" in out
    assert "256 chips, rank 0" in out and "512 chips, rank 0" in out

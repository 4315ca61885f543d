"""Dry run: every (arch x shape) cell's step traced on tensors without data,
with its FLOPs, bytes, memory, collectives and roofline terms.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on the production meshes. Here each cell's step runs once under a
``FakeTensorMode`` (``launch/cells.py`` builds it; nothing is allocated)
with a ``analysis.jaxpr_budget.Recorder`` and a ``LocalFlopCounter``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke \\
        --device cpu --mesh both --workers 6 --out build/dryrun.json

Per cell it records: the trace seconds (lowering and compiling have no
counterpart), FLOPs (``LocalFlopCounter`` plus the CUDA kernels' recorded
launches, which it cannot see), HBM bytes by the cost model's rules
(``analysis.cost_model``), collective bytes by the ring model over the
collectives the step issues, priced on the link each one's group crosses,
the per-device memory (the recorded peak of live bytes: arguments,
outputs and temporaries, with ``fits`` against the card's ``HBM_BYTES``),
MODEL_FLOPS, and the roofline terms on the H100's figures
(``launch/mesh.py``).

Meshes (``--mesh``): ``one`` is world size 1, the one card (or a
one-rank gloo group on the CPU). ``single`` and ``multi`` are the
reference's production meshes, (16, 16) on 256 ranks and (2, 16, 16) on
512: the process opens a fake process group of that size
(``mesh.open_fake_group``) in which it is rank 0, builds the mesh on it
and traces rank 0's program. The cell's arguments are placed by their
specs, so rank 0 holds its own shards only; DTensor ops are counted at
their local shapes and the collectives they and the model's per-rank
programs issue are recorded with their groups; the fake group sends
nothing and writes no output. Rank 0 stands for every rank. DTensor
chunks a dim with the larger shards first, so rank 0 would hold the
largest of uneven shards; the Sharder never shards a dim unevenly (it
replicates instead), so every rank's shards have rank 0's shapes. Where
a per-rank program depends on the rank it runs the same ops on the same
shapes on every rank: a row-sharded lookup masks the ids outside its
rows, and the MoE slices its local experts out of one expert block (with
``moe_expert_chunks`` > 1, which no registered config sets, a rank's
experts fall in one block and a later block runs beside the blocks'
summed output, so a later rank could peak above rank 0).
``tests/test_torch_dist.py`` holds rank 0's peak as the largest of four
gloo ranks'. Each production-mesh trace runs in a worker process of its
own group (``run_cells``).

A collective's seconds are its ring-model bytes over the rate of the
links its group crosses: NVLink within a node of ``GPUS_PER_NODE`` ranks,
InfiniBand across nodes (``mesh.IB_BW_PER_DIRECTION``). With ranks
numbered row-major, every group of both production meshes crosses nodes.

Depth: a full-depth trace is exact (PyTorch has no loop a cost pass visits
once), on a production mesh too. Where a full-depth trace takes too long
(``EXTRAPOLATED``: kimi-k2's 61 layers of 384 experts) the cell is traced
at two depths and every count extrapolated linearly, as the reference's
``exact_cost_metrics``: FLOPs, bytes, collective bytes, arguments and
outputs are affine in depth, so they come out exact; the peak is the
largest of several phases' live bytes, each affine in depth, so it comes
out exact while one phase holds it from the first traced depth on, and
is otherwise an estimate held to at least the traced depths' peaks
(``cost_source`` and ``peak_source`` say which cells were extrapolated).

Entry points run on the card unless given ``--device cpu`` (fake CUDA
tensors need a CUDA build).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import cost_model
from repro_torch.analysis.jaxpr_budget import (LocalFlopCounter, Recorder,
                                               Trace, local_leaves)
from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.launch import cells as cells_mod
from repro_torch.launch import mesh as mesh_mod

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
# recorded collective op -> kind: the functional c10d ops (DTensor's
# redistributions, all_to_all) and the in-place ones torch.distributed's
# calls issue (dist.collectives, core.distributed's per-rank programs)
_C10D_OPS = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "allreduce_": "all-reduce",
             "allgather_": "all-gather",
             "_allgather_base_": "all-gather",
             "allgather_into_tensor_coalesced": "all-gather",
             "reduce_scatter_": "reduce-scatter",
             "_reduce_scatter_base_": "reduce-scatter",
             "alltoall_base_": "all-to-all",
             "alltoall_": "all-to-all",
             "broadcast_": "broadcast"}
LINKS = ("nvlink", "ib")

# archs whose full-depth trace takes too long: traced at two depths
# (llama4-scout's 48 layers of 16 experts took 44-51 s for 12 of them on
# the H100 host's CPU, kimi-k2 has 61 of 384)
EXTRAPOLATED = frozenset({"kimi-k2-1t-a32b", "llama4-scout-17b-a16e"})

# --mesh -> (mesh shape, chips); "one" is world size 1
MESHES = {"one": ((1,), 1), "single": ((16, 16), 256),
          "multi": ((2, 16, 16), 512)}


def _ring_bytes(rec) -> Optional[Tuple[str, int]]:
    """(kind, per-device link bytes) of one recorded collective by the
    ring model, None for any other op: an all-reduce moves ~2x its size
    per device (reduce-scatter + all-gather phases), the others ~1x. The
    size is the op's outputs' (an in-place op returns its tensors once)."""
    kind = _C10D_OPS.get(rec.name)
    if kind is None:
        return None
    nbytes = sum(b for _, _, b, _, _ in rec.outs)
    return kind, (2 if kind == "all-reduce" else 1) * nbytes * rec.weight


def collective_bytes(ops) -> Dict[str, int]:
    """Per-device link traffic of the recorded collectives by kind, and
    their count."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for rec in ops:
        got = _ring_bytes(rec)
        if got is None:
            continue
        out[got[0]] += got[1]
        out["count"] += rec.weight
    return out


def _collective_list(ops) -> list:
    """[kind, ring-model bytes of one call, calls] of each distinct
    collective recorded, in order of kind and bytes."""
    calls: Dict[Tuple[str, int], int] = {}
    for rec in ops:
        got = _ring_bytes(rec)
        if got is not None:
            key = (got[0], got[1] // rec.weight)
            calls[key] = calls.get(key, 0) + rec.weight
    return [[k, b, n] for (k, b), n in sorted(calls.items())]


def _link_of(group) -> str:
    """"nvlink" for a group within one node of ``GPUS_PER_NODE`` ranks
    (or no group), "ib" for one that crosses nodes."""
    if not group:
        return "nvlink"
    return "nvlink" if len({r // mesh_mod.GPUS_PER_NODE
                            for r in group}) == 1 else "ib"


def collective_links(ops) -> Dict[str, int]:
    """The ring-model bytes of the recorded collectives by the links their
    groups cross."""
    out = {k: 0 for k in LINKS}
    for rec in ops:
        got = _ring_bytes(rec)
        if got is not None:
            out[_link_of(rec.group)] += got[1]
    return out


def collective_seconds(links: Dict[str, float]) -> float:
    """Each link's bytes over its per-direction rate."""
    return (links["nvlink"] / mesh_mod.NVLINK_BW_PER_DIRECTION
            + links["ib"] / mesh_mod.IB_BW_PER_DIRECTION)


def _spec_with_layers(spec, n_layers: int, smoke: bool):
    """The ArchSpec with its (backbone's) depth set to ``n_layers``,
    installed as both config and smoke_config."""
    base = spec.smoke_config if smoke else spec.config
    if spec.family == "lm":
        cfg = dataclasses.replace(base, n_layers=n_layers)
    elif spec.family == "colpali":
        bb = dataclasses.replace(base.encoder.backbone, n_layers=n_layers)
        cfg = dataclasses.replace(
            base, encoder=dataclasses.replace(base.encoder, backbone=bb))
    else:
        cfg = base
    return dataclasses.replace(spec, config=cfg, smoke_config=cfg)


def _depths(spec, smoke: bool):
    """(L1, L2, L_full): two depths that are whole periods of the layer
    pattern (chunked-attention archs repeat every ``global_every``), from
    the second period on: the first layer's step holds a different peak
    (nothing is live from an earlier layer), the later ones add a constant
    amount each."""
    base = spec.smoke_config if smoke else spec.config
    bb = base if spec.family == "lm" else base.encoder.backbone
    step = bb.global_every if bb.attn_chunk > 0 else 1
    return (min(2 * step, bb.n_layers), min(3 * step, bb.n_layers),
            bb.n_layers)


def _tree_bytes(tree) -> int:
    """Bytes of the distinct storages this rank holds under one argument
    (a DTensor's local shard's)."""
    seen = {}
    for t in local_leaves(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def trace_cell(spec, cell, mesh=None, *, smoke: bool = False,
               device="cuda", fake: bool = True, seed: int = 0
               ) -> Dict[str, Any]:
    """One cell's step on fake tensors: the raw counts, this rank's. With
    ``fake=False`` the same counts of a real run, on arguments drawn from
    ``seed`` (every rank of a mesh must draw the same), its sweeps run in
    full."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with FakeTensorMode() if fake else contextlib.nullcontext():
        rec = Recorder(compress_loops=fake)
        with rec, torch.no_grad() if cell.kind != "train" else \
                torch.enable_grad():
            built = cells_mod.build_cell(spec, cell, mesh, smoke=smoke,
                                         device=dev, fake=fake, seed=seed)
            each = [_tree_bytes(a) for a in built.args]
            rec.mark()
            fc = LocalFlopCounter(display=False)
            with fc:
                out = built.fn(*built.args)
        outs = local_leaves(out)
        tr = Trace(0, rec.ops, tuple(t.dtype for t in outs),
                   sum(t.numel() * t.element_size() for t in outs),
                   rec.input_bytes, rec.peak_above_inputs, rec.peak_op,
                   False)
        kernels = {}
        for r in rec.ops:
            if r.flops is not None:
                k = kernels.setdefault(r.name[len("kernel:"):],
                                       {"launches": 0, "flops": 0.0,
                                        "bytes": 0.0})
                k["launches"] += r.weight
                k["flops"] += r.flops * r.weight
                k["bytes"] += r.nbytes * r.weight
        meta = dict(built.meta)
        del out, outs, built
    secs = time.perf_counter() - t0
    cost = cost_model.trace_cost(tr)
    counter_flops = float(fc.get_total_flops())
    kernel_flops = sum(k["flops"] for k in kernels.values())
    return {"trace_s": secs,
            "flops": counter_flops + kernel_flops,
            "counter_flops": counter_flops, "kernel_flops": kernel_flops,
            "bytes": float(cost.bytes),
            "coll": collective_bytes(rec.ops),
            "coll_each": _collective_list(rec.ops),
            "links": collective_links(rec.ops),
            "argument_bytes": tr.input_bytes,
            "argument_bytes_each": each,
            "output_bytes": tr.out_bytes,
            "peak_above_args": tr.peak_above_inputs,
            "peak_op": tr.peak_op,
            "kernels": kernels,
            "meta": meta}


_LINEAR = ("flops", "counter_flops", "kernel_flops", "bytes",
           "argument_bytes", "output_bytes", "peak_above_args")


def exact_cost_metrics(spec, cell, mesh=None, *, smoke: bool = False,
                       device="cuda", extrapolate: Optional[bool] = None
                       ) -> Dict[str, Any]:
    """The cell's counts: a full-depth trace, or (``extrapolate``; default
    for the archs in EXTRAPOLATED) traces at two depths L1 < L2 extended
    linearly to the full depth (layers are identical blocks, so every
    count is affine in depth; the peak, where its phase changes between
    the depths, held to at least the traced depths' peaks)."""
    if extrapolate is None:
        extrapolate = spec.arch_id in EXTRAPOLATED
    if not extrapolate or spec.family not in ("lm", "colpali"):
        m = trace_cell(spec, cell, mesh, smoke=smoke, device=device)
        m["source"] = m["peak_source"] = "full depth"
        return m
    l1, l2, full = _depths(spec, smoke)
    if l1 == l2:
        m = trace_cell(_spec_with_layers(spec, l1, smoke), cell, mesh,
                       smoke=smoke, device=device)
        m["source"] = m["peak_source"] = f"full depth L={l1}"
        return m
    m1 = trace_cell(_spec_with_layers(spec, l1, smoke), cell, mesh,
                    smoke=smoke, device=device)
    m2 = trace_cell(_spec_with_layers(spec, l2, smoke), cell, mesh,
                    smoke=smoke, device=device)

    def extr(a, b):
        return a + (b - a) * (full - l1) / (l2 - l1)

    out = dict(m2)
    for key in _LINEAR:
        out[key] = extr(m1[key], m2[key])
    # more layers hold no fewer bytes: where the phase that holds the
    # peak changes between L1 and L2 the line can fall below them
    out["peak_above_args"] = max(out["peak_above_args"],
                                 m1["peak_above_args"],
                                 m2["peak_above_args"])
    out["argument_bytes_each"] = [extr(a, b) for a, b in zip(
        m1["argument_bytes_each"], m2["argument_bytes_each"])]
    for key in ("coll", "links"):
        out[key] = {k: int(extr(m1[key][k], m2[key][k])) for k in m1[key]}
    calls1 = {(k, b): n for k, b, n in m1["coll_each"]}
    calls2 = {(k, b): n for k, b, n in m2["coll_each"]}
    out["coll_each"] = [[k, b, int(extr(calls1.get((k, b), 0),
                                        calls2.get((k, b), 0)))]
                        for k, b in sorted(set(calls1) | set(calls2))]
    out["kernels"] = {
        name: {f: extr(m1["kernels"].get(name, {}).get(f, 0), v[f])
               for f in v} for name, v in m2["kernels"].items()}
    out["trace_s"] = m1["trace_s"] + m2["trace_s"]
    out["source"] = f"extrapolated from L={l1},{l2} to {full}"
    out["peak_source"] = "extrapolated (exact while one phase holds the " \
        "peak at every depth)"
    if spec.family == "lm":
        out["meta"] = cells_mod.lm_meta(
            spec.smoke_config if smoke else spec.config, cell)
    return out


def _world_mesh(device):
    """A one-rank (1, 1) ("data", "model") mesh on ``device``."""
    mesh_mod.open_local_group(device)
    return mesh_mod.make_host_mesh((1, 1), ("data", "model"), device=device)


def _open_mesh(mesh: str, dev, search: bool):
    """The mesh a cell is traced on: None at world size 1 (a search cell
    gets the one-rank world mesh), else the production mesh on a fake
    group in which this process is rank 0."""
    if mesh == "one":
        return _world_mesh(dev.type) if search else None
    mesh_mod.open_fake_group(MESHES[mesh][1])
    return mesh_mod.make_production_mesh(multi_pod=mesh == "multi",
                                         device=dev.type)


def run_cell(arch_id: str, shape_name: str, *, smoke: bool = False,
             device="cuda", mesh: str = "one",
             extrapolate: Optional[bool] = None) -> Dict[str, Any]:
    """One cell's record (see the module docstring) on ``mesh``: "one"
    (world size 1), "single" or "multi" (rank 0 of the production mesh).
    A process group this call opens it closes again."""
    spec = registry.get(arch_id)
    cell = next(c for c in spec.shapes if c.name == shape_name)
    if cell.skip:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh,
                "status": "skipped", "reason": cell.skip}
    dev = resolve_device(device)
    opened = not dist.is_initialized()
    try:
        placed = _open_mesh(mesh, dev, spec.family == "colpali"
                            and cell.kind == "search")
        m = exact_cost_metrics(spec, cell, placed, smoke=smoke, device=dev,
                               extrapolate=extrapolate)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()
    chips = MESHES[mesh][1]
    built_meta = m["meta"]
    flops, bytes_acc = m["flops"], m["bytes"]
    coll_total = sum(v for k, v in m["coll"].items() if k != "count")
    compute_t = flops / mesh_mod.PEAK_FLOPS_BF16
    memory_t = bytes_acc / mesh_mod.HBM_BW
    coll_t = collective_seconds(m["links"])
    model_flops = built_meta.get("model_flops", 0.0)
    per_dev = model_flops / chips
    peak = m["argument_bytes"] + m["peak_above_args"]
    hbm = mesh_mod.HBM_BYTES if dev.type == "cuda" \
        else mesh_mod.HBM_BYTES_DATASHEET
    worst = max(compute_t, memory_t, coll_t)
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh, "chips": chips,
        "rank": 0, "mesh_shape": MESHES[mesh][0],
        "device": str(dev), "status": "ok",
        "trace_s": m["trace_s"], "cost_source": m["source"],
        "flops_per_dev": flops,
        "counter_flops": m["counter_flops"],
        "kernel_flops": m["kernel_flops"],
        "hbm_bytes_per_dev": bytes_acc,
        "collective_bytes_per_dev": m["coll"],
        "collective_bytes_by_link": m["links"],
        "kernels": m["kernels"],
        "mem": {"argument_bytes": m["argument_bytes"],
                "argument_bytes_each": m["argument_bytes_each"],
                "output_bytes": m["output_bytes"],
                "temp_bytes": m["peak_above_args"],
                "peak_bytes": peak, "peak_op": m["peak_op"],
                "peak_source": m["peak_source"],
                "hbm_bytes": hbm, "fits": bool(peak <= hbm)},
        "roofline": {
            "compute_s": compute_t, "memory_s": memory_t,
            "collective_s": coll_t,
            "collective_s_all_nvlink":
                coll_total / mesh_mod.NVLINK_BW_PER_DIRECTION,
            "collective_s_all_ib": coll_total / mesh_mod.IB_BW_PER_DIRECTION,
            "dominant": max([("compute", compute_t), ("memory", memory_t),
                             ("collective", coll_t)],
                            key=lambda kv: kv[1])[0],
            "model_flops_total": model_flops,
            "model_flops_per_dev": per_dev,
            "useful_flops_ratio": per_dev / flops if flops else 0.0,
            "roofline_frac": ((per_dev / mesh_mod.PEAK_FLOPS_BF16)
                              / worst) if worst > 0 else 0.0,
        },
        "meta": built_meta,
    }


def _run_one(job) -> Dict[str, Any]:
    arch_id, shape, kw = job
    try:
        return run_cell(arch_id, shape, **kw)
    except Exception as e:  # noqa: BLE001 — reported, the caller decides
        return {"arch": arch_id, "shape": shape,
                "mesh": kw.get("mesh", "one"), "status": "error",
                "error": repr(e), "traceback": traceback.format_exc()}


def run_cells(todo, *, workers: int = 1, **kw) -> list:
    """``run_cell`` for each (arch, shape) or (arch, shape, mesh) of
    ``todo``, in order, in ``workers`` processes (each traces on its own
    CPU core; fake tensors allocate nothing on the card). A production
    mesh's cells run in spawned workers, one at least, when this process
    has a process group open: each opens and closes its own fake group."""
    jobs = [(job[0], job[1], {**kw, "mesh": job[2]} if len(job) > 2
             else kw) for job in todo]
    spawn = workers > 1 or (dist.is_initialized() and any(
        j[2].get("mesh", "one") != "one" for j in jobs))
    if not spawn:
        return [_run_one(j) for j in jobs]
    import concurrent.futures as cf
    import multiprocessing as mp
    # the deep LM steps first, so the pool ends on short cells
    order = sorted(range(len(jobs)),
                   key=lambda i: _long_first(*todo[i][:2]))
    with cf.ProcessPoolExecutor(max_workers=max(1, workers),
                                mp_context=mp.get_context("spawn")) as ex:
        done = dict(zip(order, ex.map(_run_one, [jobs[i] for i in order])))
    return [done[i] for i in range(len(jobs))]


def _long_first(arch_id: str, shape: str) -> int:
    """0 for the cells whose trace takes longest (a deep model's train or
    prefill step), 1 for the rest."""
    spec = registry.get(arch_id)
    kind = next(c.kind for c in spec.shapes if c.name == shape)
    return 0 if spec.family in ("lm", "colpali") and kind in (
        "train", "prefill") else 1


def real_flops(fn) -> Tuple[Any, float]:
    """``fn()`` on real tensors, counted as a fake trace counts it:
    ``LocalFlopCounter`` (this rank's ops) plus the CUDA kernels' recorded
    launches (which it cannot see). Returns (output, FLOPs)."""
    from repro_torch.kernels import vmem
    kernel = []

    def on_launch(geometry, shapes, flops, nbytes):
        kernel.append(flops)

    vmem._recorders.append(on_launch)
    try:
        fc = LocalFlopCounter(display=False)
        with fc:
            out = fn()
    finally:
        vmem._recorders.remove(on_launch)
    return out, float(fc.get_total_flops()) + sum(kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["one", "single", "multi", "both"],
                    default="one",
                    help="one: world size 1 (the one card); single/multi: "
                         "rank 0 of the reference's 256/512-rank meshes on "
                         "a fake process group; both: single, then multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced configs (CPU sanity)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-cost-exact", action="store_true",
                    help="trace every cell at full depth (no two-depth "
                         "extrapolation)")
    ap.add_argument("--workers", type=int, default=1,
                    help="trace the cells in this many processes")
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for arch_id, cell in registry.all_cells(include_skipped=True):
            flag = f"  [SKIP: {cell.skip}]" if cell.skip else ""
            print(f"{arch_id:28s} {cell.name:16s} {cell.kind:10s}{flag}")
        return 0

    if args.all:
        todo = [(a, c.name) for a, c in registry.all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run_cells([(a, s, m) for m in meshes for a, s in todo],
                        workers=args.workers, smoke=args.smoke,
                        device=args.device,
                        extrapolate=False if args.no_cost_exact else None)
    failures = []
    for rec in results:
        tag = f"{rec['arch']}/{rec['shape']}/{rec['mesh']}"
        print(f"=== {tag} ===", flush=True)
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"  ok: {rec['chips']} chips, rank {rec['rank']}: trace "
                  f"{rec['trace_s']:.2f}s | mem/dev "
                  f"{rec['mem']['peak_bytes'] / 2**30:.2f} GiB "
                  f"(fits={rec['mem']['fits']}) | compute "
                  f"{r['compute_s']:.2e}s memory {r['memory_s']:.2e}s "
                  f"collective {r['collective_s']:.2e}s -> "
                  f"{r['dominant']}-bound | roofline_frac "
                  f"{r['roofline_frac']:.3f}", flush=True)
        elif rec["status"] == "skipped":
            print(f"  skipped: {rec['reason']}", flush=True)
        else:
            print(rec.get("traceback", ""), flush=True)
            failures.append((tag, rec["error"]))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        return 1
    print(f"\nall {len(results)} cells ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

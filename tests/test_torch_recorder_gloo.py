"""The analysis recorder over real collectives on gloo ranks (ROADMAP F6).

Gloo's worker thread keeps a collective's tensors until it takes its next
work, after the collective has completed. When one of them was a storage
the ``Recorder`` tracked, it was freed whenever that thread ran, and a
rank's recorded peak moved with the load on the host: the world-4 dry-run
check ``rank 0's peak is the largest`` failed under a loaded suite. The
recorder now hands each gloo collective untracked copies and waits for it
at once. Here two gloo ranks (one process each, a ``file://`` rendezvous
under ``tmp_path``) run the functional and the in-place c10d collectives
under a ``Recorder``: no collective is handed a storage the recorder
tracks (a dispatch mode below it sees what each is handed), the values
equal the same calls without it, the recorded collectives are the same
ops, every tracked storage is freed on the recording thread, and both
ranks record the same peak over repeated runs. Exact.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_RANK = textwrap.dedent('''
    import datetime, json, sys, threading
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.analysis import jaxpr_budget as jb

    rank, world, wd = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{wd}/rdv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    group = dist.group.WORLD
    main_thread = threading.get_ident()
    foreign = []
    real_free = jb.Recorder._free

    def free(self, key):
        if threading.get_ident() != main_thread:
            foreign.append(self._bytes.get(key, 0))
        real_free(self, key)

    jb.Recorder._free = free

    class Spy(TorchDispatchMode):
        """Below the recorder: how many tracked storages the collectives
        (the ops given a process group) are handed."""

        def __init__(self, rec):
            super().__init__()
            self.rec = rec
            self.handed_tracked = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace in jb.COLLECTIVE_NAMESPACES and \
                    jb._group_of(args) is not None:
                self.handed_tracked += sum(
                    t.untyped_storage()._cdata in self.rec._bytes
                    for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor))
            return func(*args, **(kwargs or {}))

    def program():
        base = torch.arange(24.0).reshape(4, 6) * (rank + 1)
        out = []
        for step in range(3):
            x = base + step
            out.append(funcol.all_reduce(x * 2, "sum", group).wait())
            out.append(funcol.all_gather_tensor(x[:, :3].contiguous(), 0,
                                                group).wait())
            out.append(funcol.reduce_scatter_tensor(
                torch.cat([x, x]), "sum", 0, group).wait())
            y = x.clone()
            dist.all_reduce(y)
            out.append(y)
            z = x.clone()
            dist.broadcast(z, src=1)
            out.append(z)
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            out.extend(parts)
            s = torch.empty_like(x)
            dist.scatter(s, [x + 10 * r for r in range(world)]
                         if rank == 0 else None, src=0)
            out.append(s)
        return [t.clone() for t in out]

    plain = program()
    peaks, ops = [], None
    handed_tracked = 0
    for _ in range(3):
        rec = jb.Recorder()
        spy = Spy(rec)
        with spy, rec:
            got = program()
        handed_tracked += spy.handed_tracked
        peaks.append(rec.peak)
        names = [r.name for r in rec.ops if r.group is not None]
        assert ops is None or names == ops
        ops = names
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        del got, rec
    print(json.dumps({"peaks": peaks, "foreign": foreign,
                      "handed_tracked": handed_tracked, "collectives": ops}))
    dist.destroy_process_group()
''')


def test_collectives_on_gloo_leave_the_recorded_peak_steady(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-4000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for o in outs:
        assert o["handed_tracked"] == 0
        assert o["foreign"] == [], o["foreign"]
        assert len(set(o["peaks"])) == 1, o["peaks"]
        # every step's seven collectives are recorded, as their ops
        assert len(o["collectives"]) == 3 * 7, o["collectives"]
    assert outs[0]["peaks"] == outs[1]["peaks"]
    assert outs[0]["collectives"] == outs[1]["collectives"]

"""The memory envelope as a checked contract, over recorded ops.

The counterpart of ``repro.analysis.jaxpr_budget``, which walks the closed
jaxpr of each search entry point. The port's sweeps are Python loops over
doc blocks (``core/scan.py``), so a graph export would unroll up to 4,096
blocks at N = 2^20. The port records instead: a ``Recorder`` is a
``TorchDispatchMode`` that runs under a ``FakeTensorMode`` (tensors with
shapes and dtypes and no data, so a 2^20-document corpus costs nothing)
and keeps, for every aten op, its name, its input shapes, its outputs'
shapes, dtypes and bytes, and whether each output is a view of an existing
storage (``alias``) and of a traced input in particular (``input_view``,
the counterpart of ``VIEW_PRIMS``). It tracks the live bytes per storage
(freed when the storage dies), so it knows the peak, and it records the
CUDA kernels' launches (``kernels.vmem.fake_launch``) with their FLOPs and
bytes.

Loops: the scan's sweeps iterate identical blocks, so under a recorder
with ``compress_loops`` (tensors without data only) a sweep runs two full
blocks, the second weighted by the full blocks after the first, and its
ragged tail once (``kernels.vmem.sweep``): the counterpart of the
reference cost model pricing a ``scan`` body times its length. The output
shapes and the peak are those of the full sweep; with data the sweeps
always run in full.

``analyze_manifest`` traces a manifest's entry point at ``n`` and
``n_alt`` and checks:

  * **block bytes**: an intermediate (a non-view output) larger than
    ``max_block_bytes`` is a violation naming the op, and says whether it
    grows with N (no intermediate of that op and size in the ``n_alt``
    trace) or not;
  * **N-scaling**: the peak live bytes above the inputs may grow at most
    ``max_bytes_per_doc`` per document between the two traces (the op
    that set the peak is named);
  * **dtype**: the outputs' dtypes must equal the manifest's.

An entry point that syncs on data (the HNSW descent) cannot run on fake
tensors; its manifest traces on real CPU tensors drawn from a seed, with
the same recorder and no loop compression (``BudgetManifest.real``).

Ranks: on a mesh, the recorder and ``LocalFlopCounter`` count what this
rank runs. They pass DTensor ops on to DTensor's own dispatch and record
the local ops it issues, the collectives of its redistributions among
them (each with the global ranks of its group, ``OpRecord.group``).
DTensor's metadata computations (each new op run once more on fake
tensors of the global shapes to learn its output's shape, a shard's
offsets reckoned on tensors) are no part of any rank's program and go
unrecorded (``rank_program``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import vmem

__all__ = [
    "BudgetViolation",
    "LocalFlopCounter",
    "OpRecord",
    "Recorder",
    "Trace",
    "analyze_manifest",
    "intermediate_avals",
    "max_intermediate_bytes",
    "rank_program",
    "report",
    "trace_manifest",
]

MiB = 2 ** 20


@dataclasses.dataclass(frozen=True)
class BudgetViolation:
    """One manifest-contract violation."""

    manifest: str
    kind: str        # "block_bytes" | "n_scaling" | "dtype"
    detail: str

    def __str__(self) -> str:
        return f"[{self.manifest}] {self.kind}: {self.detail}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class OpRecord:
    """One recorded op (or kernel launch, named ``kernel:<name>``).

    ``outs``: (shape, dtype, bytes, alias, input_view) per tensor output;
    ``ins``: the shapes of its tensor inputs; ``weight``: how many
    iterations of a compressed sweep it stands for; ``flops``/``nbytes``:
    a kernel launch's own cost (None for aten ops, which the cost model
    prices from their shapes)."""

    name: str
    outs: Tuple[Tuple[Tuple[int, ...], torch.dtype, int, bool, bool], ...]
    ins: Tuple[Tuple[int, ...], ...]
    weight: int = 1
    flops: Optional[float] = None
    nbytes: Optional[float] = None
    in_numel: int = 0
    group: Optional[Tuple[int, ...]] = None

    @property
    def new_bytes(self) -> int:
        """Bytes of the storages this op allocated."""
        return sum(b for _, _, b, alias, _ in self.outs if not alias)


def _leaves(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def local_leaves(x) -> List[torch.Tensor]:
    """The tensors under ``x``, a DTensor as its local shard."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in _leaves(x)]


# collectives' namespaces: the in-place c10d ops (torch.distributed's
# calls) and the functional ones (DTensor's redistributions)
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional",
                         "_c10d_functional_autograd")


def _group_of(args):
    """The process group among a collective's arguments: a
    ``ProcessGroup`` (the c10d ops) or its name (the functional ones)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a)
            except (KeyError, RuntimeError, ValueError):
                continue
        elif isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a)
        elif isinstance(a, dist.ProcessGroup):
            return a
    return None


def _group_ranks(args) -> Optional[Tuple[int, ...]]:
    """The global ranks of a collective's process group."""
    pg = _group_of(args)
    return None if pg is None else tuple(dist.get_process_group_ranks(pg))


def _settled_collective(func, args, kwargs):
    """Run a collective on gloo so that no buffer the recorder tracks
    outlives it on gloo's side. Gloo's worker thread keeps a collective's
    tensors until it comes back for its next work, after the collective
    has completed; a tracked storage it held was then freed whenever that
    thread ran, and a rank's recorded peak moved with the load on the
    host (ROADMAP F6). Here the collective gets untracked copies of its
    tensor arguments and is waited for at once; what it wrote goes back
    into the caller's mutated arguments, and a fresh output is copied
    into a tensor of the caller's own. The values, and the ops recorded,
    are those of the plain call."""
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
    flat, spec = tree_flatten((args, kwargs))
    copies = {}
    given = []
    for a in flat:
        if isinstance(a, torch.Tensor):
            c = a.clone()
            copies[id(c)] = a
            a = c
        given.append(a)
    c_args, c_kwargs = tree_unflatten(given, spec)
    out = func(*c_args, **c_kwargs)
    for o in tree_leaves(out):
        if isinstance(o, torch.ScriptObject):     # the c10d ops' Work
            dist.Work.unbox(o).wait()
    if func.namespace != "c10d":
        for o in tree_leaves(out):
            if isinstance(o, torch.Tensor):
                torch.ops._c10d_functional.wait_tensor(o)
    # the c10d ops write into their tensor arguments with no mark in their
    # schemas; the functional ones mark what they write
    written = {id(t) for i, arg in enumerate(func._schema.arguments)
               if func.namespace == "c10d" or (
                   arg.alias_info is not None and arg.alias_info.is_write)
               for t in tree_leaves(args[i] if i < len(args)
                                    else kwargs.get(arg.name))
               if isinstance(t, torch.Tensor)}
    for c, a in zip(given, flat):
        if id(a) in written:
            a.copy_(c)

    def back(o):
        if not isinstance(o, torch.Tensor):
            return o
        if id(o) in copies:
            return copies[id(o)]
        return o.clone()

    return tree_map(back, out)


def _on_gloo(args) -> bool:
    pg = _group_of(args)
    return pg is not None and dist.get_backend(pg) == "gloo"


# depth of DTensor's metadata computations now running (ops on tensors
# of the global shapes, or index arithmetic, which no rank runs)
_SHADOW = [0]


def _shadow(fn, host: bool = False):
    """``fn`` run as a metadata computation: its ops unrecorded and, with
    ``host``, on real tensors even under a ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def run(*args, **kwargs):
        _SHADOW[0] += 1
        try:
            if host:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        finally:
            _SHADOW[0] -= 1

    return run


@contextlib.contextmanager
def rank_program():
    """For the duration of the block, leave DTensor's metadata
    computations out of what the recorder and ``LocalFlopCounter`` count:
    its sharding propagation runs each new op once on fake tensors of
    the global shapes to learn its output's shape (once per op
    signature, so whether it runs depends on DTensor's cache), and a
    shard's local shape and global offset (a strided shard's local size
    too) are index arithmetic on tensors (run on the host: under a
    ``FakeTensorMode`` their ``int``/``tolist`` have no data). None of it
    is part of a rank's program."""
    from torch.distributed.tensor import _utils, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    patches = []
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if n in ShardingPropagator.__dict__)
    patches.append((ShardingPropagator, name, False))
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and \
            "local_shard_size_and_offset" in strided.__dict__:
        patches.append((strided, "local_shard_size_and_offset", True))
    if "_compute_local_shape_and_global_offset" in _utils.__dict__:
        patches.append((_utils, "_compute_local_shape_and_global_offset",
                        True))
    saved = [(cls, n, cls.__dict__[n]) for cls, n, _ in patches]
    for cls, n, host in patches:
        setattr(cls, n, _shadow(cls.__dict__[n], host))
    try:
        yield
    finally:
        for cls, n, orig in saved:
            setattr(cls, n, orig)


def _is_dtensor_op(types) -> bool:
    return any(issubclass(t, DTensor) for t in types)


class _LocalFlops(flop_counter._FlopCounterMode):
    """FlopCounterMode's dispatch mode, left to DTensor's dispatch for a
    DTensor op (it then sees the local ops) and blind to the shadow ops
    of ``rank_program``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        if _SHADOW[0]:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class LocalFlopCounter(flop_counter.FlopCounterMode):
    """``FlopCounterMode`` counting what this rank runs: a DTensor op at
    its local shards' shapes (the plain counter counts it once at the
    global shapes). Without DTensors the two count alike. It keeps the
    total only: the plain counter's per-module tally hooks every module,
    and its hooks' closures hold the step's tensors in reference cycles
    that only the garbage collector frees, so a recorded peak would
    depend on when the collector runs."""

    def __enter__(self):
        self._program = rank_program()
        self._program.__enter__()
        self.flop_counts.clear()
        self.mode = _LocalFlops(self)
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            out = self.mode.__exit__(*exc)
            self.mode = None
            return out
        finally:
            self._program.__exit__(*exc)


def _op_name(func) -> str:
    name = getattr(func, "__name__", str(func))
    return name.split(".")[0]


class Recorder(TorchDispatchMode):
    """Record every aten op and kernel launch, and the live bytes.

    Enter it inside the ``FakeTensorMode`` (or with real tensors); tensors
    created under it are tracked, ``track`` adds tensors made before it,
    and ``mark`` makes what is live the traced inputs: their bytes are the
    base of ``peak_above_inputs``, views of them are ``input_view`` and the
    op list starts empty again.
    """

    def __init__(self, compress_loops: bool = False):
        super().__init__()
        self.compress_loops = compress_loops
        self.ops: List[OpRecord] = []
        self.live = 0
        self.peak = 0
        self.base = 0
        self.peak_op = "<inputs>"
        self._bytes: Dict[int, int] = {}
        self._inputs: set = set()
        self._weight = [1]

    # -- storage tracking ---------------------------------------------------

    def _add(self, t: torch.Tensor) -> Tuple[bool, bool]:
        """Track ``t``'s storage; returns (alias, input_view)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._bytes:
            return True, key in self._inputs
        nbytes = st.nbytes()
        self._bytes[key] = nbytes
        self.live += nbytes
        weakref.finalize(st, self._free, key)
        return False, False

    def _free(self, key: int) -> None:
        self.live -= self._bytes.pop(key, 0)
        self._inputs.discard(key)

    def track(self, tree) -> None:
        for t in local_leaves(tree):
            self._add(t)

    def mark(self) -> None:
        self.ops = []
        self._inputs = set(self._bytes)
        self.base = self.live
        self.peak = self.live
        self.peak_op = "<inputs>"

    @property
    def input_bytes(self) -> int:
        return self.base

    @property
    def peak_above_inputs(self) -> int:
        return self.peak - self.base

    # -- recording ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):  # its local ops come back here
            return NotImplemented
        if (getattr(func, "namespace", None) in COLLECTIVE_NAMESPACES
                and not _SHADOW[0] and _on_gloo(args)):
            out = _settled_collective(func, args, kwargs or {})
        else:
            out = func(*args, **(kwargs or {}))
        tensors = _leaves(out)
        if not tensors or _SHADOW[0]:   # metadata queries, shadow ops
            return out
        ins = _leaves((args, kwargs))
        outs = []
        for t in tensors:
            alias, in_view = self._add(t)
            outs.append((tuple(t.shape), t.dtype,
                         t.numel() * t.element_size(), alias, in_view))
        group = (_group_ranks(args) if getattr(func, "namespace", None)
                 in COLLECTIVE_NAMESPACES else None)
        rec = OpRecord(_op_name(func), tuple(outs),
                       tuple(tuple(t.shape) for t in ins), self._weight[-1],
                       in_numel=ins[0].numel() if ins else 0, group=group)
        self.ops.append(rec)
        if self.live > self.peak:
            self.peak = self.live
            self.peak_op = rec.name
        return out

    def _launch(self, geometry, shapes, flops, nbytes) -> None:
        outs = tuple((tuple(s), dt, math.prod(s) * dt.itemsize, False,
                      False) for s, dt in geometry.outputs)
        # ins: the launch's geometry arguments (its shapes)
        self.ops.append(OpRecord(f"kernel:{geometry.kernel}", outs,
                                 (tuple(shapes["args"]),), self._weight[-1],
                                 flops=flops, nbytes=nbytes))

    def sweep(self, starts: range, n: int):
        """The starts of a Python sweep over n positions in blocks of
        ``starts.step``: all of them, or (compressing) the first full
        block, the second weighted by the rest of the full blocks (it runs
        with the first's leftovers alive, as every later block does, so
        the peak is the full sweep's), then the ragged tail."""
        if not self.compress_loops or len(starts) <= 3:
            yield from starts
            return
        step = starts.step
        full = len(starts) if starts[-1] + step <= n else len(starts) - 1
        yield starts[0]
        self._weight.append(self._weight[-1] * (full - 1))
        try:
            yield starts[1]
        finally:
            self._weight.pop()
        if full < len(starts):
            yield starts[-1]

    def __enter__(self):
        vmem._recorders.append(self._launch)
        vmem._sweeps.append(self.sweep)
        self._program = rank_program()
        self._program.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        vmem._recorders.remove(self._launch)
        vmem._sweeps.remove(self.sweep)
        try:
            return super().__exit__(*exc)
        finally:
            self._program.__exit__(*exc)


@dataclasses.dataclass
class Trace:
    """One recorded run of an entry point."""

    n: int
    ops: List[OpRecord]
    out_dtypes: Tuple[torch.dtype, ...]
    out_bytes: int
    input_bytes: int
    peak_above_inputs: int
    peak_op: str
    real: bool


_TRACES: Dict[Tuple[str, int], Trace] = {}


def trace_manifest(manifest, n: int, *, device="cpu", cache: bool = True
                   ) -> Trace:
    """Record ``manifest.trace(n)``'s entry point once (cached per process
    and ``(manifest, n, device)``): on fake tensors with loop compression,
    or, for a ``real`` manifest, on real CPU tensors drawn from its seed."""
    key = (manifest.name, n, str(device))
    if cache and key in _TRACES:
        return _TRACES[key]
    real = getattr(manifest, "real", False)
    ctx = contextlib.nullcontext() if real else FakeTensorMode()
    with ctx:
        rec = Recorder(compress_loops=not real)
        with rec, torch.no_grad():
            fn, args = manifest.trace(n, device="cpu" if real else device)
            rec.track(args)
            rec.mark()
            out = fn(*args)
        outs = _leaves(out)
        tr = Trace(n, rec.ops, tuple(t.dtype for t in outs),
                   sum(t.numel() * t.element_size() for t in outs),
                   rec.input_bytes, rec.peak_above_inputs, rec.peak_op, real)
        del fn, args, out, outs
    if cache:
        _TRACES[key] = tr
    return tr


def intermediate_avals(trace: Trace) -> List[Tuple[str, Tuple, bool]]:
    """(op name, (shape, dtype) of each output, is_input_view) per recorded
    op, in order: the counterpart of the reference's per-eqn outputs."""
    return [(r.name, tuple((s, dt) for s, dt, _, _, _ in r.outs),
             any(v for *_, v in r.outs)) for r in trace.ops]


def max_intermediate_bytes(trace: Trace) -> int:
    """The largest single allocation an op made."""
    return max((r.new_bytes for r in trace.ops), default=0)


def _fmt(rec: OpRecord) -> str:
    shapes = ", ".join(f"{str(dt).replace('torch.', '')}{list(s)}"
                       for s, dt, _, alias, _ in rec.outs if not alias)
    return f"{rec.name} -> {shapes} ({rec.new_bytes / MiB:.1f} MiB)"


def analyze_manifest(manifest, *, device="cpu") -> List[BudgetViolation]:
    """Check one ``BudgetManifest`` (see the module docstring); returns the
    violations (empty = clean)."""
    name = manifest.name
    out: List[BudgetViolation] = []
    big = trace_manifest(manifest, manifest.n, device=device)
    small = trace_manifest(manifest, manifest.n_alt, device=device)

    want = manifest.out_dtypes
    if want is not None and tuple(big.out_dtypes) != tuple(want):
        got = tuple(str(d).replace("torch.", "") for d in big.out_dtypes)
        exp = tuple(str(d).replace("torch.", "") for d in want)
        out.append(BudgetViolation(
            name, "dtype", f"output dtypes {got} != declared {exp}"))

    small_sizes: Dict[str, set] = {}
    for r in small.ops:
        small_sizes.setdefault(r.name, set()).add(r.new_bytes)
    for r in big.ops:
        b = r.new_bytes
        if b <= manifest.max_block_bytes:
            continue
        grows = b not in small_sizes.get(r.name, set())
        out.append(BudgetViolation(
            name, "block_bytes",
            f"{'N-scaling' if grows else 'static'} intermediate {_fmt(r)} "
            f"exceeds max_block_bytes="
            f"{manifest.max_block_bytes / MiB:.0f} MiB"))

    dn = manifest.n - manifest.n_alt
    per_doc = (big.peak_above_inputs - small.peak_above_inputs) / dn
    if per_doc > manifest.max_bytes_per_doc:
        out.append(BudgetViolation(
            name, "n_scaling",
            f"peak live bytes above the inputs grow {per_doc:.1f} B/doc > "
            f"max_bytes_per_doc={manifest.max_bytes_per_doc} (peak set by "
            f"{big.peak_op}: an O(N*Mq) score matrix or decoded corpus is "
            "sneaking back in)"))
    return out


def report(manifest, *, device="cpu") -> dict:
    """Machine-readable summary for one manifest (``--json``)."""
    violations = analyze_manifest(manifest, device=device)
    tr = trace_manifest(manifest, manifest.n, device=device)
    small = trace_manifest(manifest, manifest.n_alt, device=device)
    return {
        "manifest": manifest.name,
        "n": manifest.n,
        "traced_on": "real CPU tensors" if tr.real else "fake tensors",
        "max_block_bytes": manifest.max_block_bytes,
        "max_bytes_per_doc": manifest.max_bytes_per_doc,
        "worst_intermediate_bytes": max_intermediate_bytes(tr),
        "peak_above_inputs_bytes": tr.peak_above_inputs,
        "peak_growth_bytes_per_doc": (tr.peak_above_inputs
                                      - small.peak_above_inputs)
        / (manifest.n - manifest.n_alt),
        "n_intermediates": len(tr.ops),
        "violations": [v.to_json() for v in violations],
        "ok": not violations,
    }


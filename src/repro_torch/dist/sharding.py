"""Logical-axis sharding: resolve logical dim names to mesh placements.

The counterpart of ``repro.dist.sharding``. Code names every tensor dim
with a *logical* name ("batch", "mlp", "corpus", ...). ``DEFAULT_RULES``
maps each logical name to an ordered tuple of *physical* mesh axes it may
shard over. ``Sharder.resolve`` turns a logical spec and a concrete shape
into one entry per dim — ``None``, one axis name, or a tuple of axis
names, the entries of the reference's ``PartitionSpec`` — with three
fallbacks, applied per dim in order:

  1. missing axes — rule axes not present in the mesh are skipped (the
     same code runs on a ("data", "model") mesh and a ("pod", "data",
     "model") one);
  2. conflicts — a mesh axis already claimed by an earlier dim of the same
     tensor is dropped (a tensor cannot use one mesh axis twice);
  3. divisibility — axes are dropped from the *right* of the rule until the
     dim size divides the product of the remaining axis sizes (never an
     uneven shard; replicate instead).

The resolver is shape arithmetic: it needs the axis names and sizes only,
so it runs on a ``MeshShape`` as well as on a live ``DeviceMesh``.
``named`` turns a resolved spec into a ``NamedSharding``: the mesh and one
DTensor placement per mesh dim — ``Shard(d)`` on every mesh dim that
tensor dim ``d`` resolves to, ``Replicate()`` elsewhere — and
``distribute`` places a tensor by it.

16-bit integers never cross a collective: gloo rejects them and NCCL has
no such type. ``distribute`` and ``full_tensor`` move them as a uint8
view with a trailing dim of two bytes, which leaves every sharded dim as
it was.

``NULL`` is the no-mesh singleton: ``shd=NULL`` turns every constraint into
a no-op, so the same code runs unsharded.

The model code takes a sharder (``shd=``). Parameters, optimizer state,
caches and batches are placed by their logical specs (``shard_tree``), and
each of the reference's sharding constraints is ``Sharder.constraint`` at
the same place. Where DTensor has no rule for an op, the model writes the
per-rank program itself on the local shards: ``local_partial`` takes a
replicated input into a program that uses it differently on each rank (its
gradient is summed back over those ranks), and ``reduce_partial`` joins
the ranks' partial results with one all-reduce.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)

# Logical dim name -> ordered mesh axes it may shard over. Order matters:
# divisibility drops from the right, so put the "most essential" axis first.
# Only axes that exist in the production meshes may appear here.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # data-parallel-ish dims
    "batch": ("pod", "data"),
    "nodes": ("pod", "data"),
    "edge": ("pod", "data"),
    "tokens": ("pod", "data"),
    # fan-out dims that may take the whole mesh
    "candidate": ("pod", "data", "model"),
    "corpus": ("pod", "data", "model"),
    # tensor-parallel dims
    "mlp": ("model",),
    "vocab": ("model",),
    "qkv_out": ("model",),
    "kv_out": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "seq_sp": ("model",),
    "expert": ("model",),
    "table_rows": ("model",),
    # contracting / replicated dims
    "embed": (),
    "expert_mlp": (),
    "kv_seq": (),
}

# integer types no collective backend takes
SIXTEEN_BIT_INTS = (torch.int16, torch.uint16)


def is_logical_spec(x) -> bool:
    """True for a plain tuple of logical dim names (str) / None.

    Named-tuple nodes (whose fields are themselves specs) and tuples
    holding non-str entries are *not* logical specs: this is the leaf
    test when a spec tree is walked beside a state or param tree.
    """
    return (type(x) is tuple
            and all(e is None or isinstance(e, str) for e in x))



def map_specs(fn, specs, tree):
    """``tree`` with each leaf replaced by ``fn(spec, leaf)``, walking the
    spec tree beside it: dicts, lists, tuples, named tuples and
    dataclasses, a logical spec tuple being a leaf of the spec tree (the
    int fields of dataclasses, a state's knobs, are kept)."""
    if is_logical_spec(specs):
        return fn(specs, tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, specs[k], v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_specs(fn, sp, x) for sp, x in zip(specs, tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_specs(fn, getattr(specs, f.name),
                              getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if not isinstance(getattr(tree, f.name), int)})
    raise TypeError(f"spec {specs!r} does not match a "
                    f"{type(tree).__name__} node")

class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices or process groups:
    enough for ``Sharder.resolve`` and ``num_shards``."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives: a ``DeviceMesh`` and one DTensor placement per
    mesh dim."""
    mesh: object
    placements: Tuple[Placement, ...]


def mesh_device(mesh) -> torch.device:
    """The device a mesh's tensors live on in this process."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, *tensors) -> None:
    """Raise unless every tensor lives on the mesh's device type."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type != mesh.device_type:
            raise ValueError(f"a tensor on {t.device} cannot go on a "
                             f"{mesh.device_type} mesh")


def _bytes_view(x: torch.Tensor) -> torch.Tensor:
    """A 16-bit tensor as uint8 with a trailing dim of its two bytes."""
    return x.unsqueeze(-1).view(torch.uint8)


def _distribute(x: torch.Tensor, mesh, placements) -> DTensor:
    """``distribute_tensor`` from rank 0; on a fake process group (which
    sends nothing and writes no output) each rank takes its own shard of
    the ``x`` it holds, a copy, so ``x`` can go."""
    if dist.get_backend() != "fake":
        return distribute_tensor(x, mesh, placements)
    own = distribute_tensor(x, mesh, placements, src_data_rank=None)
    if not any(isinstance(p, Shard) for p in placements):
        return own
    return DTensor.from_local(own.to_local().clone(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """Place ``x`` (the same values on every rank) on the mesh as a DTensor
    of ``sharding``'s placements; rank 0's values are the ones kept."""
    mesh, placements = sharding.mesh, tuple(sharding.placements)
    check_device(mesh, x)
    x = x.contiguous()
    if x.dtype not in SIXTEEN_BIT_INTS:
        return _distribute(x, mesh, placements)
    wide = _distribute(_bytes_view(x), mesh, placements)
    local = wide.to_local().view(x.dtype).squeeze(-1)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def full_tensor(x) -> torch.Tensor:
    """A DTensor's global value on every rank (16-bit integers through
    their byte view); any other value is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    if x.dtype not in SIXTEEN_BIT_INTS:
        return x.full_tensor()
    local = _bytes_view(x.to_local())
    shape = (*x.shape, 2)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    wide = DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)
    return wide.full_tensor().view(x.dtype).squeeze(-1)


def local(x):
    """A DTensor's shard on this rank; any other value as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def sharded_axes(x: DTensor, dim: int = 0) -> Tuple[str, ...]:
    """The mesh axes a DTensor's ``dim`` is sharded over, in mesh order."""
    names = x.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def shard_index(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's shard, the shard count) of a dim sharded over ``axes``:
    shards in row-major order of the axes' coordinates, as DTensor cuts a
    dim over several mesh dims."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in axes:
        i = names.index(a)
        index = index * mesh.size(i) + coord[i]
        count *= mesh.size(i)
    return index, count


@contextlib.contextmanager
def replicating():
    """DTensor's implicit replication (plain tensors beside DTensors count
    as replicated) for the duration of the block, then the setting it
    found: unlike ``implicit_replication`` it nests, so an entry point
    called inside another's scope leaves the outer one on."""
    disp = DTensor._op_dispatcher
    saved = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = saved


def local_partial(x, over: Sequence[int]) -> torch.Tensor:
    """A DTensor's local shard, taken into a per-rank program that uses it
    differently on the ranks of the mesh dims ``over`` (where ``x`` is
    replicated: each rank reads another slice of it, or applies it to
    other rows): the gradient flowing back is summed over those dims.
    Any other value is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = [Partial() if i in over else p for i, p in enumerate(x.placements)]
    return x.to_local(grad_placements=pl)


def reduce_partial(part: torch.Tensor, mesh, placements, over: Sequence[int],
                   op: str = "sum") -> DTensor:
    """Each rank's ``part`` of a value that is the ``op`` ("sum", "max" or
    "min") of the parts over the mesh dims ``over``: one all-reduce, and
    the result as a DTensor replicated on those dims and placed by
    ``placements`` on the others. Differentiable for "sum" (every part
    gets the gradient of the whole)."""
    pl = list(placements)
    for i in over:
        pl[i] = Partial(op)
    out = DTensor.from_local(part, mesh, pl, run_check=False)
    if not over:
        return out
    return out.redistribute(mesh, [Replicate() if i in over else p
                                   for i, p in enumerate(pl)])


def all_to_all(x: torch.Tensor, mesh, dims: Sequence[int], split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """One all-to-all among the ranks of the mesh dims ``dims`` (their
    shards in ``shard_index`` order): ``x`` is cut into as many equal
    parts along ``split_dim`` as there are ranks, part j goes to rank j,
    and the parts received are joined along ``cat_dim`` in rank order.
    Differentiable (the gradient goes back by the inverse exchange). It
    issues an all-to-all on every backend, where DTensor's own shard-dim
    exchange falls back to an all-gather on gloo."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd, wait_tensor)
    names = tuple(mesh.mesh_dim_names[i] for i in dims)
    sub = mesh[names]
    if len(names) > 1:
        sub = sub._flatten()
    n = sub.size()
    parts = torch.stack(x.chunk(n, dim=split_dim))
    got = wait_tensor(all_to_all_single_autograd(
        parts.reshape(-1, *parts.shape[2:]).contiguous(), None, None, sub))
    got = got.view(parts.shape)
    return torch.cat(got.unbind(0), dim=cat_dim)


def shard_tree(shd, specs, tree):
    """``tree`` (params, optimizer state, caches, a batch) with every
    tensor placed on ``shd``'s mesh by its logical spec in the matching
    ``specs`` tree (``map_specs``; mesh dims of size 1 replicate); a 0-d
    tensor is replicated. With ``NULL`` the tree is returned as it is."""
    if shd.mesh is None:
        return tree

    def place(spec, x):
        if not isinstance(x, torch.Tensor) or isinstance(x, DTensor):
            return x
        return distribute(x, shd.named(spec, tuple(x.shape),
                                       unit_axes=False))

    return map_specs(place, specs, tree)


class Sharder:
    """Resolves logical specs against one mesh (a ``DeviceMesh`` or a
    ``MeshShape``)."""

    def __init__(self, mesh, rules: Optional[Dict[str, Tuple[str, ...]]]
                 = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES if rules is None else rules)
        self._sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))

    # -- core resolution ----------------------------------------------------

    def _axes_for(self, name: Optional[str], dim: int, used: set
                  ) -> Tuple[str, ...]:
        """Mesh axes a single dim shards over, after all three fallbacks."""
        if name is None:
            return ()
        rule = self.rules.get(name, ())
        present = tuple(a for a in rule if a in self._sizes)
        kept = [a for a in present if a not in used]
        # drop from the right until the dim divides the shard product
        while kept:
            prod = 1
            for a in kept:
                prod *= self._sizes[a]
            if dim % prod == 0:
                break
            kept.pop()
        return tuple(kept)

    def resolve(self, spec: Tuple[Optional[str], ...],
                shape: Tuple[int, ...]) -> tuple:
        """Logical spec + shape -> one entry per dim: None, an axis name,
        or a tuple of two or more axis names (the entries of the
        reference's PartitionSpec, which writes one axis as its name)."""
        assert len(spec) == len(shape), (spec, shape)
        used: set = set()
        entries = []
        for name, dim in zip(spec, shape):
            kept = self._axes_for(name, dim, used)
            used.update(kept)
            entries.append(None if not kept else
                           kept[0] if len(kept) == 1 else kept)
        return tuple(entries)

    # -- conveniences -------------------------------------------------------

    def placements(self, spec: Tuple[Optional[str], ...],
                   shape: Tuple[int, ...], unit_axes: bool = True
                   ) -> Tuple[Placement, ...]:
        """The resolved spec as DTensor placements, one per mesh dim.
        ``unit_axes=False`` leaves a mesh dim of size 1 replicated (a
        shard of everything), which keeps the model code's reshapes
        within DTensor's rules."""
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.resolve(spec, shape)):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            if not unit_axes:
                axes = tuple(a for a in axes if self._sizes[a] > 1)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"dim {d} shards over {axes}, out of the mesh's axis "
                    f"order {names}: DTensor cuts a dim over mesh dims in "
                    "mesh order")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def named(self, spec: Tuple[Optional[str], ...],
              shape: Tuple[int, ...], unit_axes: bool = True
              ) -> NamedSharding:
        return NamedSharding(self.mesh,
                             self.placements(spec, shape, unit_axes))

    def constraint(self, x, *spec: Optional[str]):
        """``x`` redistributed to the resolved spec if it is a DTensor
        (mesh dims of size 1 replicated); any other value unchanged."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.placements(
            tuple(spec), tuple(x.shape), unit_axes=False))

    def num_shards(self, name: str, dim: int) -> int:
        """How many ways a dim of this size/logical name actually shards."""
        kept = self._axes_for(name, dim, set())
        prod = 1
        for a in kept:
            prod *= self._sizes[a]
        return prod

    def scope(self):
        """The context the model code runs its sharded steps in: plain
        tensors it makes (masks, positions, zeros) count as replicated
        beside DTensors."""
        return replicating()


class _NullSharder:
    """Mesh-less stand-in: every operation is the identity / replicated,
    so the same code runs unsharded on one device."""

    mesh = None
    rules: Dict[str, Tuple[str, ...]] = {}

    def resolve(self, spec, shape) -> tuple:
        return (None,) * len(spec)

    def named(self, spec, shape):
        raise ValueError("NULL sharder has no mesh — use a real Sharder")

    def constraint(self, x, *spec):
        return x

    def num_shards(self, name, dim) -> int:
        return 1

    def scope(self):
        return contextlib.nullcontext()


NULL = _NullSharder()

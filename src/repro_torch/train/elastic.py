"""Elastic scaling: resume a run on another device count or mesh.

The counterpart of ``repro.train.elastic``. Checkpoints store whole
leaves (``ckpt/checkpoint.py``), so elasticity is: build the new mesh,
resolve every logical spec against it (the divisibility fallback absorbs
axis-size changes), and restore with the new placements. ``reshard_plan``
reports which tensors change their layout — at scale, the plan of the
resharding transfer.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.ckpt import checkpoint as ck
from repro_torch.dist.sharding import Sharder, is_logical_spec, map_specs

PyTree = Any


def _spec_leaves(spec_tree: PyTree) -> Iterator[tuple]:
    """The logical specs of a spec tree in flatten order (dict keys
    sorted, as ``jax.tree_util`` flattens them)."""
    if is_logical_spec(spec_tree):
        yield spec_tree
    elif isinstance(spec_tree, dict):
        for k in sorted(spec_tree):
            yield from _spec_leaves(spec_tree[k])
    else:
        for s in spec_tree:
            yield from _spec_leaves(s)


def resolve_shardings(sharder: Sharder, spec_tree: PyTree,
                      template: PyTree) -> PyTree:
    """Logical specs + template shapes -> NamedShardings on sharder.mesh."""
    return map_specs(
        lambda spec, leaf: sharder.named(tuple(spec), tuple(leaf.shape)),
        spec_tree, template)


def restore_elastic(directory: str, template: PyTree, spec_tree: PyTree,
                    mesh, rules: Optional[Dict] = None
                    ) -> Optional[Tuple[int, PyTree]]:
    """Restore the latest checkpoint under ``directory`` placed onto
    ``mesh``: (step, tree of DTensors), or None without a checkpoint."""
    sharder = Sharder(mesh, rules) if rules else Sharder(mesh)
    shardings = resolve_shardings(sharder, spec_tree, template)
    mgr = ck.CheckpointManager(directory)
    return mgr.restore_latest(template, shardings)


def reshard_plan(old_sharder: Sharder, new_sharder: Sharder,
                 spec_tree: PyTree, template: PyTree) -> Dict[str, tuple]:
    """Which leaves change their resolved spec between two meshes:
    {path: (old, new)}, paths as ``jax.tree_util.keystr`` writes them."""
    changes = {}
    for (path, leaf), spec in zip(ck.leaves_with_paths(template),
                                  _spec_leaves(spec_tree)):
        old = old_sharder.resolve(tuple(spec), tuple(leaf.shape))
        new = new_sharder.resolve(tuple(spec), tuple(leaf.shape))
        if old != new:
            changes[path] = (old, new)
    return changes

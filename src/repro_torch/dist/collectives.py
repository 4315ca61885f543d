"""Hand-scheduled collectives on ``torch.distributed``.

The counterpart of ``repro.dist.collectives``. ``ring_allgather_matmul``
overlaps an all-gather of the weight shards with the partial matmuls that
consume them: the ring schedule, where at step i every rank multiplies
against the weight block it holds and passes that block to its left
neighbour (``batch_isend_irecv`` on the axis' group), so no rank ever holds
the whole weight.

``all_gather_axes``, ``all_reduce_axes`` and ``broadcast_axes`` run one
collective over several mesh axes, one axis' group after another; 16-bit
integers cross as uint8 views (``dist.sharding.SIXTEEN_BIT_INTS``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist import sharding


def _groups(mesh, axes: Sequence[str]):
    return [(mesh.get_group(a), mesh.size(mesh.mesh_dim_names.index(a)))
            for a in axes]


def all_gather_axes(t: torch.Tensor, mesh, axes: Sequence[str],
                    dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` over the ranks of ``axes``, concatenated along
    ``dim`` in shard order (row-major over the axes' coordinates, as
    ``sharding.shard_index`` counts them)."""
    wide = t.dtype in sharding.SIXTEEN_BIT_INTS
    out = sharding._bytes_view(t) if wide else t.contiguous()
    for group, n in reversed(_groups(mesh, axes)):   # minor axis first
        if n == 1:
            continue
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, dim=dim)
    return out.view(t.dtype).squeeze(-1) if wide else out


def all_reduce_axes(t: torch.Tensor, mesh, axes: Sequence[str],
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the ranks of ``axes``; returns it."""
    for group, n in _groups(mesh, axes):
        if n > 1:
            dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_axes(t: torch.Tensor, mesh, axes: Sequence[str]
                   ) -> torch.Tensor:
    """The values of the rank at coordinate 0 of every axis in ``axes``,
    in place on every rank of them; returns ``t``."""
    for group, n in _groups(mesh, axes):
        if n > 1:
            dist.broadcast(t, src=dist.get_global_rank(group, 0),
                           group=group)
    return t


def _block(t, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axis``: a DTensor's
    local shard, or the slice of a tensor every rank holds whole."""
    if isinstance(t, DTensor):
        return t.to_local()
    i = mesh.mesh_dim_names.index(axis)
    n = mesh.size(i)
    return t.chunk(n, dim=dim)[mesh.get_coordinate()[i]]


def ring_allgather_matmul(mesh, axis_name: str):
    """Build f(x, w) = x @ w with a ring-pipelined weight all-gather.

    x (M, K) is sharded over rows and w (K, N) over columns of
    ``axis_name`` (DTensors, or tensors every rank holds whole); each of
    the n steps computes one (M/n, N/n) output block while the w block
    moves one hop around the ring. The result is a DTensor of (M, N)
    sharded over rows of ``axis_name``. Falls back to the plain ``x @ w``
    (on whole tensors) when n == 1 or M or N don't tile over the axis.
    """
    ax = mesh.mesh_dim_names.index(axis_name)
    n = mesh.size(ax)
    group = mesh.get_group(axis_name)

    def f(x, w):
        m, _ = x.shape
        _, p = w.shape
        if n == 1 or m % n != 0 or p % n != 0:
            return sharding.full_tensor(x) @ sharding.full_tensor(w)
        sharding.check_device(mesh, x, w)
        x_blk = _block(x, mesh, axis_name, 0)
        w_cur = _block(w, mesh, axis_name, 1).contiguous()
        blk_p = p // n
        out_dtype = torch.result_type(x_blk, w_cur)
        my = mesh.get_coordinate()[ax]
        left = dist.get_global_rank(group, (my - 1) % n)
        right = dist.get_global_rank(group, (my + 1) % n)
        out = torch.empty((x_blk.shape[0], p), dtype=out_dtype,
                          device=x_blk.device)
        # after i hops, rank d holds w block (d + i) % n
        for i in range(n):
            col = (my + i) % n
            out[:, col * blk_p:(col + 1) * blk_p] = x_blk @ w_cur
            if i == n - 1:
                break
            w_next = torch.empty_like(w_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w_cur, left, group),
                dist.P2POp(dist.irecv, w_next, right, group)])
            for req in reqs:
                req.wait()
            w_cur = w_next
        placements = [Replicate()] * mesh.ndim
        placements[ax] = Shard(0)
        return DTensor.from_local(out, mesh, placements, run_check=False,
                                  shape=torch.Size((m, p)),
                                  stride=(p, 1))

    return f


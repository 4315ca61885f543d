"""The fault-tolerant training loop.

The counterpart of ``repro.train.loop``:

  * checkpoint/restart: ``CheckpointManager`` (atomic, async) in the
    reference's format, auto-resume from the latest committed step;
  * non-finite guard: ``guard_nonfinite`` rolls a step back when its loss
    is not finite (params and the whole optimizer state, ``step``
    included, by ``torch.where`` over the new and the old tensors, with no
    host sync) and counts it as skipped;
  * straggler watchdog: a step slower than ``straggler_factor`` x the
    trailing median is counted and logged.

A step function maps (params, opt_state, batch) -> (params, opt_state,
metrics) with 0-d tensor metrics including ``loss``; params are a dict of
named tensors and opt_state an ``optim.optimizer.AdamWState`` (what
``transformer.train_step`` and ``colpali.train_step`` take). The loop
reads the metrics once per step, in one device-to-host copy: its only
sync.

``make_pipelined_fn`` is GPipe pipeline parallelism over a mesh axis: one
stage per rank, activations passed to the next stage point to point.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import convert
from repro_torch.ckpt.checkpoint import (CheckpointManager, leaves_with_paths,
                                        map_with_paths)

PyTree = Any


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


def _select(ok: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """``new`` where ``ok``, else ``old``, leaf by leaf (same structure),
    written into ``new``'s tensors: a step's outputs are its own, and the
    select then needs no third copy of the state."""
    old_leaves = dict(leaves_with_paths(old))
    return map_with_paths(
        lambda k, x: torch.where(ok, x, old_leaves[k], out=x), new)


def guard_nonfinite(step_fn: Callable) -> Callable:
    """Wrap (params, opt_state, batch) -> (params, opt_state, metrics) with
    a functional non-finite rollback. Adds metrics["skipped"] (0-d int32)."""

    def guarded(params, opt_state, batch):
        new_p, new_o, metrics = step_fn(params, opt_state, batch)
        ok = torch.isfinite(metrics["loss"])
        params = _select(ok, new_p, params)
        opt_state = _select(ok, new_o, opt_state)
        metrics = dict(metrics)
        metrics["skipped"] = (~ok).to(torch.int32)
        return params, opt_state, metrics

    return guarded


def run(step_fn: Callable, params: Dict[str, torch.Tensor], opt_state,
        batches: Iterator[Dict[str, Any]], cfg: LoopConfig,
        start_step: int = 0, manager: Optional[CheckpointManager] = None,
        log_fn: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run the guarded training loop from ``start_step`` (or the latest
    checkpoint under ``cfg.ckpt_dir``) to ``cfg.total_steps``, saving
    every ``cfg.ckpt_every`` steps (async) and at the end.

    Returns {params, opt_state, step, history, stats, checkpoint}: history
    has one entry per step (step, loss, the other metrics as floats and
    the step's seconds, the step function and its one sync), stats the
    straggler and skipped counts, checkpoint the final save's step, path,
    bytes and seconds."""
    if manager is None:
        manager = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)

    restored = manager.restore_latest(convert.train_template(params,
                                                             opt_state))
    if restored is not None:
        start_step, tree = restored
        params, opt_state = convert.train_state_from_tree(tree, params)
        log_fn(f"[loop] resumed from step {start_step}")

    history = []
    step_times = []
    n_skipped = 0
    stats = {"stragglers": 0, "skipped": 0}
    step = start_step - 1
    guarded = guard_nonfinite(step_fn)

    for step in range(start_step, cfg.total_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt_state, metrics = guarded(params, opt_state, batch)
        names = list(metrics)
        values = torch.stack([metrics[k].detach().to(torch.float64)
                              for k in names]).tolist()   # the one sync
        dt = time.perf_counter() - t0
        m = dict(zip(names, values))
        loss = m.pop("loss")
        step_times.append(dt)
        n_skipped += int(m["skipped"])
        if len(step_times) > 10:
            med = float(np.median(step_times[-50:]))
            if dt > cfg.straggler_factor * med:
                stats["stragglers"] += 1
                log_fn(f"[loop] straggler step {step}: {dt:.3f}s "
                       f"(median {med:.3f}s)")
        history.append({"step": step, "loss": loss, **m, "seconds": dt})
        if cfg.log_every and step % cfg.log_every == 0:
            log_fn(f"[loop] step {step} loss {loss:.4f} ({dt*1e3:.1f} ms)")
        if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
            manager.save_async(step + 1, convert.train_tree(params,
                                                            opt_state))

    manager.wait()
    manager.save(cfg.total_steps, convert.train_tree(params, opt_state))
    stats["skipped"] = n_skipped
    return {"params": params, "opt_state": opt_state, "step": step + 1,
            "history": history, "stats": stats,
            "checkpoint": manager.last_save}


# ---------------------------------------------------------------------------
# GPipe pipeline parallelism (one stage per rank, point-to-point rotation)
# ---------------------------------------------------------------------------

def make_pipelined_fn(mesh, stage_fn: Callable, n_microbatches: int,
                      axis: str = "pipe") -> Callable:
    """Build f(stage_params, x) running ``stage_fn`` depth-sharded over
    ``axis``: rank s of the axis runs stage s.

    stage_params: a tree (dicts, lists, tuples) whose leaves have a leading
    dim of n_stages (DTensors sharded over ``axis`` on it, or tensors every
    rank holds whole); ``stage_fn(sp, x_mb)`` gets the stage's slice.
    x: (n_microbatches * mb, ...) activations entering stage 0, the same
    on every rank. Schedule: GPipe fill/flush, T = n_micro + n_stages - 1
    ticks; at each tick every stage runs the microbatch it holds (a stage
    without one computes on its stale buffer, which is never committed),
    then passes the output and its microbatch tag to the next stage
    (``batch_isend_irecv`` on the axis' group). The last stage commits
    finished microbatches; an all-reduce SUM over the axis gives every
    rank the output. Bubble fraction (n_stages - 1) / T.
    """
    ax = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(ax)
    group = mesh.get_group(axis)

    def pipelined(stage_params, x: torch.Tensor) -> torch.Tensor:
        stage = mesh.get_coordinate()[ax]
        sp = map_with_paths(
            lambda _, a: a.to_local()[0] if isinstance(a, DTensor)
            else a[stage], stage_params)
        mb = x.shape[0] // n_microbatches
        mbs = x.reshape(n_microbatches, mb, *x.shape[1:])
        out = torch.zeros_like(mbs)
        buf = torch.zeros_like(mbs[0])
        tag = torch.full((1,), -1, dtype=torch.int32, device=x.device)
        nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
        prv = dist.get_global_rank(group, (stage - 1) % n_stages)
        for t in range(n_microbatches + n_stages - 1):
            if stage == 0 and t < n_microbatches:    # stage 0 injects
                buf = mbs[t]
                tag = torch.full_like(tag, t)
            y = stage_fn(sp, buf)
            if stage == n_stages - 1:                # the last commits
                slot = torch.clamp(tag, min=0).to(torch.int64)
                out.index_copy_(0, slot, torch.where(
                    tag >= 0, y, out.index_select(0, slot)[0])[None])
            if n_stages == 1:
                buf, tag = y, torch.full_like(tag, -1)
                continue
            y = y.contiguous()
            buf, new_tag = torch.empty_like(y), torch.empty_like(tag)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y, nxt, group),
                    dist.P2POp(dist.isend, tag, nxt, group, tag=1),
                    dist.P2POp(dist.irecv, buf, prv, group),
                    dist.P2POp(dist.irecv, new_tag, prv, group, tag=1)]):
                req.wait()
            # stage 0 receives from the last stage: that buffer is done
            tag = torch.full_like(tag, -1) if stage == 0 else new_tag
        if stage != n_stages - 1:
            out.zero_()
        if n_stages > 1:
            dist.all_reduce(out, group=group)
        return out.reshape(x.shape)

    return pipelined

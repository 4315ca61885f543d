"""Training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

Runs the family's train step (``transformer.train_step`` for the lm
archs, dense and MoE, ``colpali.train_step`` for colpali-hpc,
``gnn.train_step`` for pna, ``recsys.train_step`` for dlrm-mlperf,
dcn-v2, din and dien) through the fault-tolerant loop (checkpoint/restart
in the reference's format, the non-finite guard, the straggler watchdog).
The counterpart of ``repro.launch.train``: pna trains on one community
graph of 512 nodes and 2048 edges, every step; recsys archs on fresh
batches of ``--batch`` from ``data.synthetic.make_recsys_batch``.

Batches are drawn on the host from a generator seeded by ``--seed`` and
reach the device through ``PrefetchPipeline`` (a pinned, non-blocking
copy). The device defaults to ``cuda`` and the CLI raises on a host
without a card unless given ``--device cpu``. Weights are drawn from the
seed by the reference's distributions.
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile

import torch

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.data.pipeline import PrefetchPipeline, device_put_batch
from repro_torch.device import resolve_device
from repro_torch.models import colpali as colpali_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt
from repro_torch.train import loop as train_loop


def batch_stream(make_batch, seed: int = 0):
    """Endless batches ``make_batch(generator)`` from one host generator."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield make_batch(gen)


def colpali_batch(gen: torch.Generator, enc, batch: int):
    """Random query tokens and page patches, every position valid (the
    reference CLI's batch)."""
    bb = enc.backbone
    return {
        "query_tokens": torch.randint(0, bb.vocab, (batch, enc.query_len),
                                      generator=gen, dtype=torch.int32),
        "query_mask": torch.ones((batch, enc.query_len), dtype=torch.bool),
        "doc_patches": torch.randn((batch, enc.n_patches, enc.d_patch),
                                   generator=gen),
        "doc_mask": torch.ones((batch, enc.n_patches), dtype=torch.bool),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    spec = registry.get(args.arch)
    dev = resolve_device(args.device)
    cfg = spec.smoke_config if args.smoke else spec.config
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(1, args.steps // 10))
    init_gen = torch.Generator(dev).manual_seed(args.seed)

    if spec.family == "lm":
        model = T.init(cfg, generator=init_gen, device=dev)
        step = functools.partial(T.train_step, model, opt_cfg=ocfg)
        mk = functools.partial(synthetic.make_lm_batch, vocab=cfg.vocab,
                               batch=args.batch, seq=args.seq)
    elif spec.family == "colpali":
        model = colpali_mod.init(cfg.encoder, generator=init_gen, device=dev)
        step = functools.partial(colpali_mod.train_step, model,
                                 opt_cfg=ocfg)
        mk = functools.partial(colpali_batch, enc=cfg.encoder,
                               batch=args.batch)
    elif spec.family == "gnn":
        model = gnn_mod.init(cfg, generator=init_gen, device=dev)
        step = functools.partial(gnn_mod.train_step, cfg=cfg, opt_cfg=ocfg)
        graph = synthetic.make_graph(
            torch.Generator().manual_seed(args.seed + 1), 512, 2048,
            cfg.d_feat, cfg.n_classes)
        mk = lambda gen: graph                          # noqa: E731
    elif spec.family == "recsys":
        model = recsys_mod.init(cfg, generator=init_gen, device=dev)
        step = functools.partial(recsys_mod.train_step, cfg=cfg,
                                 opt_cfg=ocfg)
        mk = functools.partial(synthetic.make_recsys_batch, batch=args.batch,
                               n_dense=cfg.n_dense,
                               table_rows=cfg.table_rows,
                               seq_len=cfg.seq_len, family=cfg.family)
    else:
        raise ValueError(f"family {spec.family!r}")
    params = T.params_of(model)

    pipe = PrefetchPipeline(batch_stream(mk, args.seed + 1),
                            put_fn=functools.partial(device_put_batch,
                                                     target=dev), depth=2)
    loop_cfg = train_loop.LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=max(1, args.steps // 10))
    try:
        # the initial moments are made in the call: no reference to them
        # outlives the first step
        out = train_loop.run(step, params, opt.init(ocfg, params), pipe,
                             loop_cfg)
    finally:
        pipe.close()
    out["model"] = model
    out["pipeline"] = dict(pipe.stats)
    print(f"final loss {out['history'][-1]['loss']:.4f} | "
          f"stats {out['stats']} | pipeline {pipe.stats}")
    return out


if __name__ == "__main__":
    main()

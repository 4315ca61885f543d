"""Cell builder: (arch x shape) -> a step function and its arguments.

The counterpart of ``repro.launch.cells``. For each family it builds:

  * the step function of the cell kind (LM train / prefill / decode, PNA
    train, recsys train / serve / candidates, ColPali train / encode /
    search — search through ``core.distributed.sharded_search_fn``, as the
    reference's);
  * its arguments, params and optimizer state included, as tensors
    without data when called under a ``FakeTensorMode`` (the dry run's):
    modules are constructed but their weights not drawn, so nothing is
    allocated; outside one (``fake=False``) the same arguments as real
    tensors on ``device``, with index inputs inside their tables;
  * the placements: with a mesh, ``Sharder(mesh)`` resolves every
    argument's logical spec (the model's ``param_specs``, the optimizer's
    ``state_specs``, ``transformer.cache_specs``, the batches' "batch",
    "nodes", "edge" and "candidate" dims), the params, the optimizer
    state, the caches and the batches are placed by them
    (``dist.sharding.shard_tree``; a module's own weights by
    ``transformer.shard_module``) and the step gets ``shd=``; without one
    (the dry run's world-size-1 cells) everything stays whole and the
    step runs with ``NULL``. ``placements`` records the resolved specs;
  * ``meta["model_flops"]``, the reference's MODEL_FLOPS conventions,
    carried across unchanged: 6 N D train / 2 N_active D forward for LMs
    and ColPali, the analytic PNA formula, the recsys dense-MLP formulas
    and the ADC search's table product plus its compares.

``launch/dryrun.py`` calls ``build_cell`` and records the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import NULL, Sharder, map_specs, shard_tree
from repro_torch.models import colpali as colpali_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt


@dataclasses.dataclass
class BuiltCell:
    arch_id: str
    cell: ShapeCell
    fn: Callable                 # positional args
    args: Tuple[Any, ...]
    placements: Dict[str, Any]
    meta: Dict[str, Any]


def _opt_cfg_for(arch_id: str) -> opt.AdamWConfig:
    if arch_id.startswith("kimi"):
        # 1T params: bf16 params + int8 moments (docs/design.md §6)
        return opt.AdamWConfig(moment_dtype="int8")
    return opt.AdamWConfig()


def _sharder(mesh):
    return NULL if mesh is None else Sharder(mesh)


def _record(shd, dev: torch.device, **trees) -> Dict[str, Any]:
    """The mesh, the device and, for each ``name=(specs, tree)``, the tree
    of its resolved specs (one entry per dim: None, an axis or axes)."""
    rec = {"mesh": tuple(shd.mesh.shape) if shd.mesh is not None else (1,),
           "device": str(dev)}
    for name, (specs, tree) in trees.items():
        rec[name] = map_specs(lambda sp, x: shd.resolve(sp, tuple(x.shape))
                              if isinstance(x, torch.Tensor) else x,
                              specs, tree)
    return rec


def _ints(shape, high: int, dev, dtype=torch.int32, fake: bool = True,
          gen=None):
    """An index input: empty (fake) or drawn in [0, high)."""
    if fake:
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.randint(0, max(1, high), shape, dtype=dtype, device=dev,
                         generator=gen)


def _floats(shape, dev, dtype=torch.float32, fake: bool = True, gen=None):
    if fake:
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.randn(shape, dtype=dtype, device=dev, generator=gen)


def _bools(shape, dev, fake: bool = True):
    if fake:
        return torch.empty(shape, dtype=torch.bool, device=dev)
    return torch.ones(shape, dtype=torch.bool, device=dev)


def _draw(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Real weights for a real run: normal / sqrt(fan-in), norms left."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=torch.float32).mul_(
                    p.shape[-2] ** -0.5).to(p.dtype))


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _lm_model_flops(cfg: T.LMConfig, cell: ShapeCell) -> float:
    n_active = cfg.active_param_count()
    d = cell.dims
    if cell.kind == "train":
        tokens = d["global_batch"] * d["seq_len"]
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = d["global_batch"] * d["seq_len"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * d["global_batch"]


def lm_meta(cfg: T.LMConfig, cell: ShapeCell) -> Dict[str, Any]:
    return {"model_flops": _lm_model_flops(cfg, cell),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}


def build_lm_cell(spec: ArchSpec, cell: ShapeCell, mesh, *, smoke: bool,
                  dev: torch.device, fake: bool = True,
                  gen=None) -> BuiltCell:
    cfg = spec.smoke_config if smoke else spec.config
    dims = cell.dims
    gb, seq = dims["global_batch"], dims["seq_len"]
    model = T.Transformer(cfg, device=dev)
    if not fake:
        _draw(model, gen)
    shd = _sharder(mesh)
    specs = T.param_specs(cfg)
    T.shard_module(model, shd, specs)
    params = T.params_of(model)
    meta = lm_meta(cfg, cell)

    if cell.kind == "train":
        ocfg = _opt_cfg_for(spec.arch_id)
        state = opt.init(ocfg, params)
        batch = {"tokens": _ints((gb, seq), cfg.vocab, dev, fake=fake,
                                 gen=gen),
                 "targets": _ints((gb, seq), cfg.vocab, dev, fake=fake,
                                  gen=gen)}
        sspecs = opt.state_specs(specs, ocfg)
        state = shard_tree(shd, sspecs, state)
        batch = shard_tree(shd, T.batch_specs(), batch)
        place = _record(shd, dev, params=(specs, params),
                        opt_state=(sspecs, state),
                        batch=(T.batch_specs(), batch))

        def fn(p, o, b):
            return T.train_step(model, p, o, b, ocfg, shd=shd)
        return BuiltCell(spec.arch_id, cell, fn, (params, state, batch),
                         place, meta)

    if cell.kind == "prefill":
        tok = _ints((gb, seq), cfg.vocab, dev, fake=fake, gen=gen)
        tok = shard_tree(shd, ("batch", None), tok)
        place = _record(shd, dev, params=(specs, params),
                        tokens=(("batch", None), tok))

        def fn(p, tok):
            return T.prefill(model, tok, max_len=seq, shd=shd)
        return BuiltCell(spec.arch_id, cell, fn, (params, tok), place, meta)

    # decode: one token against a seq-length cache
    tok = _ints((gb,), cfg.vocab, dev, fake=fake, gen=gen)
    shape = (cfg.n_layers, gb, seq, cfg.n_kv_heads, cfg.hd)
    cache = T.KVCache(_floats(shape, dev, cfg.adtype, fake, gen),
                      _floats(shape, dev, cfg.adtype, fake, gen))
    tok = shard_tree(shd, ("batch",), tok)
    cache = shard_tree(shd, T.cache_specs(), cache)
    place = _record(shd, dev, params=(specs, params), tokens=(("batch",), tok),
                    cache=(T.cache_specs(), cache))

    def fn(p, tok, cache):
        return T.decode_step(model, tok, cache, seq - 1, shd=shd)
    return BuiltCell(spec.arch_id, cell, fn, (params, tok, cache), place,
                     meta)


# ---------------------------------------------------------------------------
# GNN family (PNA)
# ---------------------------------------------------------------------------

def _gnn_model_flops(cfg: gnn_mod.PNAConfig, dims: Dict[str, int]) -> float:
    """Analytic PNA step flops: encoder N*2*f*d; per layer: pre-MLP
    E*2*(2d*d), post-MLP N*2*(13d*d); head N*2*d*c. x3 for fwd+bwd."""
    n, e, d = dims["n_nodes"], dims["n_edges"], cfg.d_hidden
    f, c = dims["d_feat"], dims["n_classes"]
    fwd = (2 * n * f * d
           + cfg.n_layers * (2 * e * 2 * d * d + 2 * n * 13 * d * d)
           + 2 * n * d * c)
    return 3.0 * fwd


def pna_config(spec: ArchSpec, cell: ShapeCell, smoke: bool = False):
    base = spec.smoke_config if smoke else spec.config
    dims = cell.dims
    return dataclasses.replace(
        base, d_feat=dims["d_feat"], n_classes=dims["n_classes"],
        task="graph" if "n_graphs" in dims else "node")


def build_gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh, *, smoke: bool,
                   dev: torch.device, fake: bool = True,
                   gen=None) -> BuiltCell:
    cfg = pna_config(spec, cell, smoke)
    dims = cell.dims
    n, e = dims["n_nodes"], dims["n_edges"]
    model = gnn_mod.PNAModel(cfg, device=dev)
    if not fake:
        _draw(model, gen)
    params = T.params_of(model)
    batch = {"feats": _floats((n, dims["d_feat"]), dev, fake=fake, gen=gen),
             "edge_index": _ints((2, e), n, dev, fake=fake, gen=gen)}
    if "n_graphs" in dims:
        batch["graph_ids"] = _ints((n,), dims["n_graphs"], dev, fake=fake,
                                   gen=gen)
        batch["graph_labels"] = _ints((dims["n_graphs"],),
                                      dims["n_classes"], dev, fake=fake,
                                      gen=gen)
    else:
        batch["labels"] = _ints((n,), dims["n_classes"], dev, fake=fake,
                                gen=gen)
    meta = {"model_flops": _gnn_model_flops(cfg, dims),
            "params": cfg.param_count()}
    ocfg = opt.AdamWConfig()
    state = opt.init(ocfg, params)
    shd = _sharder(mesh)
    specs = gnn_mod.param_specs(cfg)
    sspecs = opt.state_specs(specs, ocfg)
    bspecs = gnn_mod.batch_specs(batch)
    params = shard_tree(shd, specs, params)
    state = shard_tree(shd, sspecs, state)
    batch = shard_tree(shd, bspecs, batch)
    place = _record(shd, dev, params=(specs, params),
                    opt_state=(sspecs, state), batch=(bspecs, batch))

    def fn(p, o, b):
        return gnn_mod.train_step(p, o, b, cfg, ocfg, shd=shd)
    return BuiltCell(spec.arch_id, cell, fn, (params, state, batch), place,
                     meta)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def _recsys_dense_params(params: Dict[str, torch.Tensor]) -> int:
    """Parameters outside the embedding tables (MLPs, cross, GRUs)."""
    return sum(p.numel() for name, p in params.items()
               if not name.startswith("tables"))


def _recsys_batch(cfg: recsys_mod.RecsysConfig, b: int, dev, fake, gen,
                  label: bool = True):
    rows = min(cfg.table_rows) if cfg.table_rows else 1
    if cfg.family in ("din", "dien"):
        out = {"hist_ids": _ints((b, cfg.seq_len), cfg.table_rows[0], dev,
                                 fake=fake, gen=gen),
               "hist_mask": _bools((b, cfg.seq_len), dev, fake),
               "target_ids": _ints((b,), cfg.table_rows[0], dev, fake=fake,
                                   gen=gen)}
    else:
        out = {"dense": _floats((b, cfg.n_dense), dev, fake=fake, gen=gen),
               "sparse_ids": _ints((b, cfg.n_sparse), rows, dev, fake=fake,
                                   gen=gen)}
    if label:
        out["label"] = (torch.empty((b,), dtype=torch.float32, device=dev)
                        if fake else (torch.rand((b,), generator=gen,
                                                 device=dev) < 0.5).float())
    return out


def build_recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh, *, smoke: bool,
                      dev: torch.device, fake: bool = True,
                      gen=None) -> BuiltCell:
    cfg = spec.smoke_config if smoke else spec.config
    dims = cell.dims
    model = recsys_mod.RecsysModel(cfg, device=dev)
    if not fake:
        _draw(model, gen)
    params = T.params_of(model)
    dense_p = _recsys_dense_params(params)
    emb_p = sum(cfg.table_rows) * cfg.embed_dim
    seq_mult = cfg.seq_len if cfg.family in ("din", "dien") else 1
    shd = _sharder(mesh)
    specs = recsys_mod.param_specs(cfg)
    bspecs = recsys_mod.batch_specs(cfg)
    params = shard_tree(shd, specs, params)

    if cell.kind == "candidates":
        nc = dims["n_candidates"]
        one = _recsys_batch(cfg, 1, dev, fake, gen, label=False)
        one.pop("target_ids", None)      # the candidates are the targets
        cand = _ints((nc,), cfg.table_rows[-1], dev, fake=fake, gen=gen)
        # hist per candidate: attention MLP over seq_len; dense: top MLP
        meta = {"model_flops": 2.0 * dense_p * nc * seq_mult,
                "params": dense_p + emb_p}
        cand = shard_tree(shd, ("candidate",), cand)
        place = _record(shd, dev, params=(specs, params),
                        candidates=(("candidate",), cand))

        def fn(p, b, c):
            return recsys_mod.score_candidates(p, b, c, cfg, shd=shd)
        return BuiltCell(spec.arch_id, cell, fn, (params, one, cand), place,
                         meta)

    b = dims["batch"]
    if cell.kind == "serve":
        batch = _recsys_batch(cfg, b, dev, fake, gen, label=False)
        meta = {"model_flops": 2.0 * dense_p * b * seq_mult,
                "params": dense_p + emb_p}
        sb = {k: bspecs[k] for k in batch}
        batch = shard_tree(shd, sb, batch)
        place = _record(shd, dev, params=(specs, params), batch=(sb, batch))

        def fn(p, bb):
            return recsys_mod.serve_step(p, bb, cfg, shd=shd)
        return BuiltCell(spec.arch_id, cell, fn, (params, batch), place,
                         meta)

    batch = _recsys_batch(cfg, b, dev, fake, gen)
    ocfg = opt.AdamWConfig()
    state = opt.init(ocfg, params)
    meta = {"model_flops": 6.0 * dense_p * b * seq_mult,
            "params": dense_p + emb_p}
    sspecs = opt.state_specs(specs, ocfg)
    state = shard_tree(shd, sspecs, state)
    batch = shard_tree(shd, bspecs, batch)
    place = _record(shd, dev, params=(specs, params),
                    opt_state=(sspecs, state), batch=(bspecs, batch))

    def fn(p, o, bb):
        return recsys_mod.train_step(p, o, bb, cfg, ocfg, shd=shd)
    return BuiltCell(spec.arch_id, cell, fn, (params, state, batch), place,
                     meta)


# ---------------------------------------------------------------------------
# ColPali family (the paper's system)
# ---------------------------------------------------------------------------

def build_colpali_cell(spec: ArchSpec, cell: ShapeCell, mesh, *,
                       smoke: bool, dev: torch.device, fake: bool = True,
                       gen=None) -> BuiltCell:
    arch = spec.smoke_config if smoke else spec.config
    enc = arch.encoder
    dims = cell.dims

    if cell.kind in ("train", "encode"):
        model = colpali_mod.ColPaliEncoder(enc, device=dev)
        if not fake:
            _draw(model, gen)
        shd = _sharder(mesh)
        specs = colpali_mod.param_specs(enc)
        T.shard_module(model, shd, specs)
        params = T.params_of(model)
        n_active = enc.param_count()
        gb = dims["global_batch"]
        if cell.kind == "train":
            batch = {
                "query_tokens": _ints((gb, enc.query_len),
                                      enc.backbone.vocab, dev, fake=fake,
                                      gen=gen),
                "query_mask": _bools((gb, enc.query_len), dev, fake),
                "doc_patches": _floats((gb, enc.n_patches, enc.d_patch), dev,
                                       fake=fake, gen=gen),
                "doc_mask": _bools((gb, enc.n_patches), dev, fake)}
            ocfg = opt.AdamWConfig()
            state = opt.init(ocfg, params)
            tokens = gb * (enc.query_len + enc.n_patches)
            meta = {"model_flops": 6.0 * n_active * tokens,
                    "params": n_active}
            sspecs = opt.state_specs(specs, ocfg)
            bspecs = colpali_mod.batch_specs()
            state = shard_tree(shd, sspecs, state)
            batch = shard_tree(shd, bspecs, batch)
            place = _record(shd, dev, params=(specs, params),
                            opt_state=(sspecs, state), batch=(bspecs, batch))

            def fn(p, o, bb):
                return colpali_mod.train_step(model, p, o, bb, ocfg,
                                              shd=shd)
            return BuiltCell(spec.arch_id, cell, fn, (params, state, batch),
                             place, meta)

        pat = _floats((gb, enc.n_patches, enc.d_patch), dev, fake=fake,
                      gen=gen)
        msk = _bools((gb, enc.n_patches), dev, fake)
        meta = {"model_flops": 2.0 * n_active * gb * enc.n_patches,
                "params": n_active}
        pat = shard_tree(shd, ("batch", None, None), pat)
        msk = shard_tree(shd, ("batch", None), msk)
        place = _record(shd, dev, params=(specs, params),
                        patches=(("batch", None, None), pat),
                        mask=(("batch", None), msk))

        def fn(p, pat, m):
            return model.encode_doc(pat, m, shd=shd)
        return BuiltCell(spec.arch_id, cell, fn, (params, pat, msk), place,
                         meta)

    # search: the corpus-sharded ADC scan over the quantized corpus, at
    # the port's storage (uint8 codes, bool masks); codes, masks and ids
    # placed by the "corpus" rule, so each rank holds its own documents
    from repro_torch.core import distributed as dist_core
    from repro_torch.retrieval.base import code_dtype
    q_n, n_docs = dims["queries"], dims["corpus"]
    md, mq, k = arch.kept_patches, enc.query_len, arch.hpc.k
    shd = _sharder(mesh)
    axes = dist_core.corpus_data_axes(mesh, n_docs) \
        if mesh is not None else ()
    search = dist_core.sharded_search_fn(mesh, axes, k=arch.top_k)
    q = _floats((q_n, mq, enc.proj_dim), dev, fake=fake, gen=gen)
    qm = _bools((q_n, mq), dev, fake)
    codes = _ints((n_docs, md), k, dev, dtype=code_dtype(k), fake=fake,
                  gen=gen)
    dm = _bools((n_docs, md), dev, fake)
    ids = (torch.empty((n_docs,), dtype=torch.int32, device=dev) if fake
           else torch.arange(n_docs, dtype=torch.int32, device=dev))
    cb = _floats((k, enc.proj_dim), dev, fake=fake, gen=gen)
    # the table build is the only product; the scan's compares
    meta = {"model_flops": 2.0 * q_n * mq * k * enc.proj_dim
            + 1.0 * q_n * mq * n_docs * md,
            "params": k * enc.proj_dim}
    cspecs = (("corpus", None), ("corpus", None), ("corpus",))
    codes, dm, ids = shard_tree(shd, cspecs, (codes, dm, ids))
    place = _record(shd, dev, corpus=(cspecs, (codes, dm, ids)))
    place["placed_by"] = "core.distributed.sharded_search_fn"
    return BuiltCell(spec.arch_id, cell, search, (q, qm, codes, dm, ids, cb),
                     place, meta)


FAMILY_BUILDERS = {
    "lm": build_lm_cell,
    "gnn": build_gnn_cell,
    "recsys": build_recsys_cell,
    "colpali": build_colpali_cell,
}


def build_cell(spec: ArchSpec, cell: ShapeCell, mesh=None, *,
               smoke: bool = False, device="cuda", fake: bool = True,
               seed: int = 0) -> BuiltCell:
    """The cell's step and arguments on ``device`` (default the card). With
    ``fake`` (the default) call it under a ``FakeTensorMode``: nothing is
    allocated. ``fake=False`` allocates and draws real arguments from
    ``seed``. ``mesh``: a DeviceMesh whose axes the placements resolve
    against (any world size; None keeps every argument whole)."""
    dev = resolve_device(device)
    gen = None if fake else torch.Generator(dev).manual_seed(seed)
    return FAMILY_BUILDERS[spec.family](spec, cell, mesh, smoke=smoke,
                                        dev=dev, fake=fake, gen=gen)

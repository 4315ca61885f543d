"""The paper's own architecture: HPC-ColPali over a ColQwen2.5-class
backbone (qwen2-1.5b config) + the retrieval pipeline knobs.

The reference's ``repro.configs.colpali_hpc``, copied over the port's
``ColPaliConfig``, ``LMConfig`` and ``HPCConfig``.

Shape cells (beyond the 40 assigned cells — these are the paper's system):
  train_256     — contrastive late-interaction training step, batch 256
  encode_corpus — offline indexing throughput: encode 1024 pages/step
  serve_query   — 64 queries against a 4.19M-doc quantized corpus sharded
                  over the full mesh (ADC MaxSim scan + global top-k merge)
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.configs.lm_archs import QWEN2_1_5B
from repro_torch.core.pipeline import HPCConfig
from repro_torch.models.colpali import ColPaliConfig
from repro_torch.models.transformer import LMConfig


@dataclasses.dataclass(frozen=True)
class HPCColPaliArch:
    encoder: ColPaliConfig
    hpc: HPCConfig
    corpus_docs: int = 4_194_304     # serve-cell corpus size (2^22 pages)
    kept_patches: int = 616          # ceil(1024 * 0.6) rounded to mult of 8
    serve_queries: int = 64
    top_k: int = 128

    @property
    def name(self) -> str:
        return "colpali-hpc"


COLPALI_SHAPES = (
    ShapeCell("train_256", "train", {"global_batch": 256}),
    ShapeCell("encode_corpus", "encode", {"global_batch": 1024}),
    ShapeCell("serve_query", "search",
              {"queries": 64, "corpus": 4_194_304}),
)

COLPALI_HPC = ArchSpec(
    arch_id="colpali-hpc",
    family="colpali",
    config=HPCColPaliArch(
        encoder=ColPaliConfig(
            name="colpali-hpc",
            backbone=QWEN2_1_5B.config,
            d_patch=1536,            # frozen vision-tower dim (stub frontend)
            proj_dim=128,            # paper: D=128
            n_patches=1024,          # 32x32 page grid (ColPali)
            query_len=32),
        hpc=HPCConfig(k=256, p=60.0, prune_side="doc", backend="flat",
                      rerank=32,
                      # corpus-scale codebook training: best-of-8 restarts,
                      # 16k-point k-means++ seeding. kmeans_minibatch is
                      # stochastic mini-batch Lloyd on a single host; on a
                      # sharded build (mesh=...) it instead bounds the
                      # streamed E-step to (65536, K) row blocks per device
                      # (full-batch statistics, bounded memory)
                      kmeans_restarts=8, kmeans_seed_batch=16384,
                      kmeans_minibatch=65536)),
    smoke_config=HPCColPaliArch(
        encoder=ColPaliConfig(
            name="colpali-smoke",
            backbone=LMConfig(
                name="colpali-smoke-bb", n_layers=2, d_model=48, n_heads=3,
                n_kv_heads=1, d_ff=96, vocab=128, head_dim=16,
                qkv_bias=True, q_chunk=16, loss_chunk=16),
            d_patch=24, proj_dim=16, n_patches=16, query_len=8),
        hpc=HPCConfig(k=16, p=60.0, prune_side="doc", backend="flat",
                      rerank=8, kmeans_iters=5, kmeans_restarts=2),
        corpus_docs=256, kept_patches=10, serve_queries=8, top_k=8),
    shapes=COLPALI_SHAPES,
    source="[this paper; ColQwen2.5 backbone = qwen2-1.5b family]",
    notes="the paper's system: K-Means K=256, p=60% doc-side pruning, "
          "quantized ADC scan + rerank 32",
)

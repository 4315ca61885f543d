#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a host with a CUDA card. Phases, in order;
any failure exits non-zero, and no phase's error is swallowed:

  1. device: the card's name and count, ``nvidia-smi`` name and power
     limit, the TF32 flags (both set False: the paths are float32);
  2. build: compile every kernel from ``src/repro_torch/kernels/csrc``
     with nvcc for sm_90a (time and ``-Xptxas -v`` lines);
  3. check: each kernel against its plain PyTorch version on the card at
     the main paths' shapes and at edge shapes (atol = rtol = 1e-4 for
     quantized_maxsim and maxsim; hamming_maxsim bit for bit; agreement
     >= 0.9999 for kmeans_assign with every disagreement a near-tie, the
     two distances within 1e-4 in float64); quantized_maxsim's per-range
     top-k lists also with positions equal outside near-ties, at the flat
     sweep's, the rerank's and stage 2's shapes and at ragged, k > R,
     k > N, Mq 5 and 40 and K=512 shapes; maxsim also over candidate rows
     read through their ids (stage 3's layout: -1 slots, repeated ids,
     all-masked docs, an id past the corpus scoring NaN; and through a
     segment table of 1, 2 and 5 segments with capacity-8 ones) and with one
     query per block on the shared corpus; kmeans_assign also at a cascade
     batch's query codes (256 x 128);
  4. flat path at full ColPali width: build a flat index over 16384
     synthetic pages (1024 patches of D=128, pruned to 615, K=256), warm
     every ladder rung and serve 64 requests through
     ``AsyncRetrievalServer``; the launch counters prove the kernels ran
     (2 quantized_maxsim launches per batch: the sweep and the rerank),
     and the first batch is repeated on a CPU copy of the state through
     the plain path;
  5. cascade path at full width, on the same corpus and seed: the Hamming
     prefilter over all 16384 docs keeps p1 = 1024, the ADC rescore keeps
     p2 = 64 (1 quantized_maxsim launch), the float rerank returns the
     top 10; warmed and served as in phase 4, with exact launch counts per
     batch, the first batch against the CPU plain path (stage-1 pools
     identical), and its hit@10 held to >= 0.95 x the flat path's;
  6. times with CUDA events after warm-up (CUDA-graph replays of many
     launches, so host overhead is not counted), beside each kernel's
     bound, printed as one ``{"kernels": [...]}`` JSON line
     (quantized_maxsim: the flat sweep, the rerank and stage 2, beside the
     shared-memory load bound as well; maxsim: stage 3's pools read
     through their ids and pre-gathered, and a float_flat block with all
     queries per block and with one; kmeans_assign at the build's shape
     and at 256 x 128; for maxsim and kmeans_assign the f32 FMA and
     3xTF32 bounds beside ``bound_ms``); one cascade batch split into its
     three stages and one flat batch into its sweep and rerank (host wall
     and device time, ``{"cascade_stages_ms": ...}`` and
     ``{"flat_search_ms": ...}`` lines); and kmeans_assign held to its
     plain version again at the build's own shape (16,777,216 x 128, 2^31
     elements);
  7. the live cascade at full width: the cascade built over docs
     0-14335 of the same corpus, served through ``LiveIndexSession``
     (guarded ladder, ``ResilienceConfig``, every rung warmed at every
     degradation level) for 64 requests in rounds of one batch, with an
     add of docs 14336-16383 (ids = corpus positions), 5 upserts and 512
     deletes published between rounds: exact launch counts, no deleted id
     served after its delete, upserts at their new pages' score and
     resolved to the newest segment, hit@10 on the state after the add >=
     0.95 x phase 4's flat hit@10, one batch equal to the CPU plain path
     (stage-1 pools identical), the segmented split by stage beside phase
     6's monolithic one (``{"live_cascade_ms": ...}``) and stage 3's
     ``maxsim`` through the segment table, ``compact`` keeping the
     results, the state signatures and the sentry's rungs x levels; an
     overload drill (256 requests, Poisson arrivals at 4x phase 5's served
     QPS, a quarter with 100 ms deadlines, half of SLO class "batch")
     where every request is served, shed or expired and the level steps
     down and back to 0; an armed compute fault failing its batch; and the
     flat state of phase 4 with 2048 docs added and 512 deleted, held to
     the CPU plain path (S sweep launches + 1 rerank launch);
  8. index files and the ANN routers: (a) phase 7's live cascade before
     its compaction (segments 14336 + 2048 + 8, about 5.2 GB) and phase
     4's flat state saved as index files in a temporary directory under
     build/, loaded onto the card and searched on one batch (ids equal,
     scores within 1e-6 at every stage), with the file's bytes, the save
     and load seconds and crc32's share of each (``{"index_files": ...}``);
     (b) IVF (``IVFConfig()``: n_list 64, cap 512, n_probe 8) built over
     phase 4's codes and served like phase 4 (2 quantized_maxsim launches
     per batch: the probed pool and the rerank), the first batch against
     the CPU plain path, hit@10 and tie-aware recall@10 against the flat
     sweep; (c) HNSW (``HNSWConfig()``) over the first 4096 of those docs,
     served and checked the same way, and the latency of one search of
     HNSW, IVF and the flat sweep over 4096 and 16384 docs (host wall;
     device time of what a CUDA graph can replay; the descent's syncs;
     ``{"ann_latency_ms": ...}``); (d) both routers live through
     ``LiveIndexSession``: 512 docs added, 128 deleted, 64 requests with no
     deleted id served, one batch against the CPU, compaction keeping the
     results, the seconds of each mutation (``{"ann_mutation_s": ...}``).
     Phase 3 also holds quantized_maxsim at the routers' pool shapes and
     kmeans_assign at ivf's K = 64 (and K = 16);
  9. the ColPali encoder and RAG at full width (colpali-hpc: the
     qwen2-1.5b backbone, bf16 activations, bf16 products accumulated in
     float32): (a) a 2-layer cut with float32 activations on the card
     against the CPU, one page and one query (embeddings within 1e-4,
     salience / n_heads within 1e-6, the same kept patches under p = 60
     outside near-ties); (b) 1024 pages of 1024 patches drawn on the card
     micro-batch by micro-batch and encoded (every embedding finite and of
     unit norm, every page's salience summing to n_heads), the flat index
     built from the encoder's embeddings and salience (kmeans_assign
     launched), 64 encoded queries of ragged length searched in 8 batches
     (2 quantized_maxsim launches each), the first batch against the CPU
     plain path, pages/s, peak memory and the executed FLOP rate against
     the BF16 peak (``{"encoder": ...}``); (c) ``rag_pipeline`` over 4096
     fact docs with the qwen2-1.5b generator and the float_flat, flat and
     hamming retrievers (one ``{"rag": ...}`` line each: retrieve and
     generate ms per query and each kernel's launches; the untrained
     generator's ROUGE-L and hallucination under a key that says so), the
     flat retriever's first batch against the CPU plain path, and cached
     greedy decoding against an uncached forward at every step;
 10. training on the card: (a) 2-layer full-width cuts (float32) of the
     qwen2-1.5b LM (batch 4 x seq 128) and the colpali-hpc encoder (4 pages
     and 4 queries), two AdamW train steps each on the card against a CPU
     copy (loss within 1e-5, grad norm 1e-4, params as ``_adam_agreement``
     says), and a batch of NaN patches skipped by the guard with every
     param, moment and the step unchanged; (b) ColPali's contrastive step
     through ``launch.train.main`` at 64 pages of 1024 patches for 4 steps
     (first and median step seconds, pages/s, the executed matmul FLOP rate
     against the BF16 peak, peak memory, the final checkpoint's bytes and
     save seconds after a free-space check under build/), then the
     checkpoint restored into a fresh encoder and optimizer state, equal
     bit for bit, and removed (``{"colpali_train": ...}``); (c) qwen2-1.5b
     through the same CLI at batch 8 x seq 128 for 6 steps, the loss
     falling (``{"lm_train": ...}``); (d) rag_bench's generator trained for
     300 steps on the card and scored through the float_flat, flat and
     hamming retrievers (each search held to the CPU plain path) and the
     single-vector one: ROUGE-L, hallucination and answer accuracy
     (``{"rag_trained": ...}``);
 11. the MoE LM family at full width (no kernel on this path: the
     reference's router, dispatch and expert products are plain einsums):
     (a) a 1-layer llama4-scout cut with float32 activations (17.1 GB), a
     prompt of 2 x 64 and 4 decode steps on the card and on a CPU copy:
     the same experts chosen and the same assignments kept, outside
     near-ties of the router's top-k (margin < 1e-4, reported), then the
     logits within 1e-4; and the smoke configs of llama4-scout and kimi-k2
     trained 2 steps on the card against the CPU with float32 and int8
     moments; (b) a 4-layer llama4-scout cut, one iRoPE period (43.5 GB,
     float32 weights, bf16 activations): a prefill of 1 x 12288 (1.5
     windows of 8192) into a cache of 16384 and 8 decode steps, with
     tokens/s, a decode step's host wall and device time, the MoE layer's
     split (router + top-k + sort, dispatch, expert products, combine),
     the dropped share per layer at the config's capacity factor 1.25,
     peak memory and the executed FLOP rate against the BF16 peak
     (``{"moe_scout": ...}``); prefill and decode held to the
     teacher-forced forward at the no-drop capacity factor E / k, and a
     chunked layer's attention at S = 12288 held in float32 to one masked
     softmax per head with the explicit iRoPE mask; (c) a 1-layer kimi-k2
     cut (bf16, 384 experts top-8, 38.8 GB): a prefill of 4 x 64 and 4
     decode steps, the same readings (``{"moe_kimi": ...}``) and the
     no-drop check;
 12. the recsys and GNN families at full width: (a) DCN-v2, DIN (history
     pruning off and at 50%), DIEN and DLRM-MLPerf with each table cut to
     524,288 rows, on the card against a CPU copy at serve_p99's batch of
     512 (logits, loss and every grad leaf within 1e-5 relative), PNA at
     full_graph_sm within the larger of 1e-4 and 4 x what shuffling its
     edges moves on the CPU (atomic segment sums), and ``quantize`` at
     D=16 and D=18 against ``kmeans_assign_plain``; (b) each recsys cell:
     4 train steps at 65,536 (DCN-v2, DIN and DIEN through
     ``launch.train.main``), serve_p99, serve_bulk and retrieval_cand (1
     user x 10^6 candidates, held to ``forward`` on its first 512 rows;
     DIN's and DIEN's in passes of 262,144), host wall, device time,
     samples/s and peak memory each (``{"recsys_<arch>": ...}``);
     DLRM-MLPerf serving its full 187.8M rows in bf16, training on the
     row cut; ``quantize_tables`` over the 26 tables of DCN-v2 and of the
     DLRM cut (seconds, bytes, lookup error; each table's codes held to
     the plain version), 52 ``kmeans_assign`` launches; DIEN's kernels per
     train step and serve call; kmeans_assign's times at the tables'
     shapes; (c) PNA's full_graph_sm and molecule cells and minibatch_lg
     (a 232,965-node, 114.6M-edge graph made and its CSR built on the
     host, 3 steps on sampled subgraphs of 1024 seeds, fanout 15-10, the
     sampler's host ms beside each step's device ms; ``{"pna": ...}``);
 13. distribution at world size 1 (a one-rank NCCL group on an in-memory
     store, a (1, 1) ("data", "model") mesh): (a) the reference's
     serve_query cell, 64 queries of 32 patches against 4,194,304 docs of
     616 uint8 codes, 615 of them valid as doc-side top-p leaves a full
     page (5.2 GB drawn on the card), top 128, through
     ``core.distributed.sharded_search_fn``: the quantized_maxsim
     launches counted, the answer equal to ``core/scan`` without the mesh,
     one whole launch's range lists equal to the plain version's outside
     near-ties, the returned docs' scores within 1e-4 of it, no doc of
     a seeded sample of 65,536 others above the 128th score, host wall
     (median of 5), device time (CUDA events), the kernel's time beside
     its bound; (b) phase 4's corpus through ``Retriever.build(mesh=)``
     (the sharded k-means, full-batch Lloyd in 65,536-row E-step blocks;
     ``sharded_quantize`` through kmeans_assign, 1 launch), ``shard`` and
     its 64 queries searched: codes equal to ``quantize`` under the
     codebook, mean inertia at most 5% above phase 4's codebook's, hit@10
     >= 0.95 x phase 4's, a batch equal to the unsharded search; (c) a
     checkpoint (float32, uint16, bfloat16 leaves) restored onto the mesh
     by ``restore_elastic`` bit for bit, GPipe and the ring matmul; one
     ``{"sharded": ...}`` line each; (d), run right after phase 8 while
     its states live, in a one-rank NCCL group of its own: the flat,
     cascade and ivf states (16384 docs), hnsw (4096), the live cascade
     (segments 14336 + 2048 + 8) and the cascade's hamming and float_flat
     members as backends of their own, each placed by
     ``Retriever.shard`` and its 64 requests searched in batches of 8
     (the cascades through every ``search_degraded`` rung too), with the
     launches equal to the unsharded search's and every batch held to it
     (a sweep's answer and the floor bit for bit, a pool scored by a
     full-score kernel within 1e-4 with ids outside near-ties); one
     batch's host wall and device time sharded beside unsharded (one
     ``{"sharded_backends": ...}`` line); (g), right after (d) in its
     one-rank NCCL group: phase 7's base cascade (kept from phase 7)
     placed by ``Retriever.shard`` and served through
     ``LiveIndexSession`` with phase 7's schedule (64 requests in 8
     rounds; the add of docs 14336-16383, 5 upserts and 512 deletes
     between rounds; then ``compact``): every response held to phase 7's
     (scores within 1e-4, ids outside near-ties), the launches equal to
     what the batches imply and one batch's to the unplaced state's, every
     tensor still placed; phase 4's flat state placed, 2048 docs added and
     512 deleted, then compacted, each batch held to the same mutations
     unplaced (the sweep bit for bit) with equal launches; phase 5's
     cascade served as phase 5 serves it, unplaced, placed, placed,
     unplaced: QPS and p50/p99 of each (one ``{"placed_live": ...}``
     line); (f), started in the background after (g) and read after 13e:
     fault F5, attention with kv heads sharded at model = 2 (qwen2-1.5b's
     12/2 heads and llama4-scout's 40/8 at smoke widths on a (1, 2)
     mesh), two gloo ranks on the host's CPU running
     ``tests/_torch_dist_ranks.py``'s ``f5`` suite against the port's own
     unplaced run (2e-5 forward, 5e-5 grads): the host's PyTorch is under
     test, not the card (one ``{"f5": ...}`` line);
 13e. model-internal sharding at world size 1, after phase 12, in a
     one-rank NCCL group of its own: the full-width qwen2-1.5b ColPali
     encoder over 16 pages and 8 queries with its weights and inputs
     placed by their specs (the placed embeddings, taken whole, indexed
     by the flat backend and searched: kmeans_assign and quantized_maxsim
     launched on the sharded path's output), phase 11a's 1-layer
     llama4-scout cut (prefill of 2 x 64 and 4 decode steps with placed
     caches), and dcn-v2's train_batch and PNA's full_graph_sm steps from
     ``launch.cells.build_cell`` with the mesh, each held to the same run
     unsharded (forward values within 2e-5, train steps' grad norms
     within 2e-4 and params within 5e-5, the largest difference of each
     reported) with host wall and device time for both; one
     ``{"model_sharding": ...}`` line;
 14. the analysis engines and the dry run: (a) every lint rule
     (E9/F401/F811/F541, TORCH01/02/04/05) over ``src/repro_torch`` and
     this script: no finding; (b) the four kernels' launch geometry at
     every distinct shape phases 3-13 launched, the Python mirror
     (``kernels.vmem``) equal to the library's ``hpc_*_geometry``; PAL01-04
     against the card's opt-in shared memory and a fresh build's register
     counts (held equal to ``csrc/registers.json``), at every registered
     site and every launched shape; PAL03 again on the card at every
     site, outputs filled with a sentinel and launched once, none left
     (one ``{"launch_check": [...]}`` line); (c) the dry run of every
     non-skipped cell on fake CUDA tensors at world size 1, in worker
     processes (one ``{"dryrun": [...]}`` line), held to the card: each
     cell phases 12-13 ran at its registry shape has its predicted peak
     within 10% or 256 MiB of the measured one (what phase 12-13 held
     accounted for as ``_HELD`` says) and its FLOPs equal to the real
     run's (``{"dryrun_vs_card": [...]}``); (d) the cost model of every
     manifest on the h100 roofline, held to ``COST_baseline_torch.json``
     (one ``{"cost": ...}`` line);
 14e. the dry run at the production meshes: (a) qwen2-1.5b train_4k,
     llama4-scout decode_32k, dlrm-mlperf train_batch, pna ogb_products,
     dien retrieval_cand and colpali-hpc serve_query traced as rank 0 of
     a fake 256-rank process group on the (16, 16) mesh, serve_query also
     of a 512-rank one on (2, 16, 16), on fake CUDA tensors in worker
     processes: every record ok, its per-device peak, ``fits``, FLOPs,
     collective bytes by kind and link, dominant term and trace seconds
     (one ``{"dryrun_meshes": [...]}`` line); (b) in a worker process of
     its own fake 256-rank group over a "cuda" mesh, rank 0's programs run
     for real: serve_query over its 16,384 docs (drawn as 13a draws the
     corpus; one real quantized_maxsim launch, the all-gathers the fake
     group's no-ops) and dcn-v2's train_batch step on its shards, each
     peak above what was held within 10% or 256 MiB of the dry run's, its
     FLOPs and launches equal (``{"dryrun_meshes_vs_card": [...]}``); the
     fake group writes no collective's output, so no result is compared.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The main path's widths and knobs: src/repro/configs/colpali_hpc.py:46-62
# (proj_dim=128, n_patches=1024, query_len=32; HPCConfig(k=256, p=60.0,
# prune_side="doc", backend="flat", rerank=32, kmeans_restarts=8,
# kmeans_seed_batch=16384, kmeans_minibatch=65536)). Copied, not imported.
# The cascade's budgets are CascadeConfig's defaults
# (src/repro/retrieval/config.py:80-81).
N_DOCS = 16384          # 8 GiB float corpus + an 8 GiB k-means training copy
N_PATCHES = 1024
N_Q_PATCHES = 32
DIM = 128
K = 256
P = 60.0
RERANK = 32
KMEANS_RESTARTS = 8
KMEANS_SEED_BATCH = 16384
KMEANS_MINIBATCH = 65536
MAX_BATCH = 8
TOP_K = 10
N_REQUESTS = 64
BLOCK_DOCS = 256
P1, P2 = 1024, 64
BITS = 8                # ceil(log2 K)

# NVIDIA H100 SXM data sheet (at the full 700 W): f32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# dense TF32 on the tensor cores; 3xTF32 issues three products per
# f32 product (tf32x3.cuh), so its bound is 3 x FLOPs at this rate
PEAK_TF32_FLOPS = 495e12
# Shared memory serves 32 four-byte loads per clock per SM (128 B/clk):
# the rate that limits quantized_maxsim's table gather, one load per
# masked max-lookup. Times the SM count and the card's max SM clock.
LDS_PER_CLK_PER_SM = 32
# 32-bit population counts per clock per SM at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic-instruction throughput table):
# the rate that bounds hamming_maxsim. Times the SM count and max SM clock.
POPC_PER_CLK_PER_SM = 16

# phase 7, the live cascade: a base build of the first N_BASE docs, the
# rest added as one capacity-2048 segment, 5 upserts of existing ids, 512
# deletes, then an overload drill at 4x phase 5's served QPS. Upserted id
# UPSERT_IDS[j] gets a new page made of query UPSERT_QUERY + j's own
# patches, so that query must find it, at the new page's score
N_BASE = 14336
UPSERT_IDS = (128, 132, 136, 140, 144)
UPSERT_QUERY = 32
N_DEAD = 512
LIVE_RESILIENCE = dict(max_queue=64, shed_batch_frac=0.5,
                       degrade_high_frac=0.25, degrade_low_frac=0.05,
                       degrade_hold=2, watchdog_interval_s=0.05)
DRILL_REQUESTS = 256
DRILL_LOAD = 4.0

# phase 8, the ANN routers: IVFConfig() and HNSWConfig() defaults
# (src/repro/core/index.py:166-175, src/repro/core/graph.py:46-51); ivf's
# cap is twice the mean load, 2 x 16384 / 64 = 512, so n_probe x cap =
# 4096 slots (25% of the corpus) per query. The graph is built over the
# first N_HNSW docs only: its insertion is sequential numpy on the host
# (3.9-8.7 ms a document on an H100 machine's host: 15.8-35.6 s for 4096),
# so 16384 docs would add at least 48-107 s to the build and as much again
# to 8d's compaction, which rebuilds the graph: 1.5-3.5 minutes a run. 8d
# adds N_ANN_ADD docs to each router and deletes N_ANN_DEAD.
IVF_N_LIST, IVF_N_PROBE, IVF_CAP = 64, 8, 512
HNSW_EF = 64
N_HNSW = 4096
N_ANN_ADD, N_ANN_DEAD = 512, 128
SAVE_TOL = 1e-6         # a reloaded state's scores against the in-memory

# phase 9, the encoder and RAG at full width: the port's copies of
# COLPALI_HPC.config (src/repro/configs/colpali_hpc.py:43-62: the
# qwen2-1.5b backbone, d_patch 1536, proj_dim 128, 1024 patches, query_len
# 32) and QWEN2_1_5B.config (src/repro/configs/lm_archs.py:34-41) as the
# generator, with weights drawn from the seed. The encoder takes the
# reference's encode_corpus cell, 1024 pages a step
# (src/repro/configs/colpali_hpc.py:36), in micro-batches: the pages
# (6.4 GB) never sit on the card whole. 9a checks a 2-layer cut of the
# same widths with float32 activations on the card against the CPU. RAG
# runs over the fact corpus with the three retrievers of
# benchmarks/rag_bench.py:62-69.
ENC_PAGES = 1024
ENC_MICRO_BATCH = 16
ENC_QUERIES = 64
ENC_CUT_LAYERS = 2
RAG_DOCS, RAG_FACTS, RAG_FPD, RAG_QUERIES, RAG_SEQ = 4096, 1024, 4, 64, 32
RAG_TOP_K_DOCS, RAG_MAX_ANSWER = 2, 4
RAG_Q_PATCHES = 4       # make_fact_corpus's patches per query
RAG_CHECK_PROMPTS = 8
RAG_RETRIEVERS = (
    ("float_flat", dict(backend="float_flat", prune_side="none")),
    ("flat", dict(k=256, p=60.0, backend="flat", prune_side="doc",
                  rerank=8)),
    ("hamming", dict(k=512, p=60.0, backend="hamming", prune_side="doc")))
# dense BF16 on the tensor cores (H100 SXM data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
CUT_EMB_TOL = 1e-4      # 9a: embeddings, card against CPU
CUT_SAL_TOL = 1e-6      # 9a: salience / n_heads, card against CPU
SAL_SUM_TOL = 1e-3      # a page's salience sums to n_heads, relative
# a bf16 embedding's norm: the norm is rounded to bf16 before the division
# and each component after it, 2^-8 relative each; two steps
NORM_TOL = 2 * 2.0 ** -8
LOGIT_TIE_TOL = 1e-4    # cached vs uncached greedy: a near-tie of logits

QMAXSIM_TOL = 1e-4
MAXSIM_TOL = 1e-4
# each retriever's scores against the CPU plain path (hamming's are integers)
RAG_TOLS = {"float_flat": MAXSIM_TOL, "flat": QMAXSIM_TOL, "hamming": 0}
KMEANS_AGREE = 0.9999
KMEANS_TIE_TOL = 1e-4

# phase 10, training on the card. 10a: 2-layer cuts of the qwen2-1.5b LM
# and the colpali-hpc encoder at full width with float32 activations, two
# steps each on the card and on a CPU copy (TF32 off: both sides multiply
# in float32, so the loss agrees to about 1e-6 and the grad norm to about
# 1e-5, the sums running in other orders; params as _adam_agreement says).
# 10b: the reference's train_256 cell (src/repro/configs/colpali_hpc.py:37)
# with its batch cut to 64 pages (256 needs about 86 GB: PERF.md §4).
# 10c: qwen2-1.5b at batch 8 x seq 128. 10d: benchmarks/rag_bench.py's
# generator set-up (:20-48): the fact corpus, a 3-layer d-96 LM, 300 steps
# of batch 32 x seq 24 at lr 2e-3, 20 warm-up steps, weight decay 0.01.
TRAIN_CUT_LAYERS = 2
TRAIN_CUT_STEPS = 2
TRAIN_CUT_LR = 3e-4
TRAIN_CUT_LM_BATCH = (4, 128)   # batch, seq
TRAIN_CUT_PAGES = 4             # and as many queries of query_len tokens
TRAIN_LOSS_TOL = 1e-5           # relative to the loss (or its scores)
TRAIN_GNORM_TOL = 1e-4          # relative
TRAIN_PARAM_TOL = 1e-5
TRAIN_PAGES = 64
TRAIN_STEPS = 4
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 128, 6
RAG_GEN_DOCS, RAG_GEN_FACTS, RAG_GEN_FPD = 96, 400, 3
RAG_GEN_DIM, RAG_GEN_PATCHES, RAG_GEN_QUERIES = 64, 12, 64
RAG_GEN_LM = dict(n_layers=3, d_model=96, n_heads=4, n_kv_heads=2, d_ff=192,
                  q_chunk=8, loss_chunk=24, tie_embeddings=True)
RAG_GEN_OPT = dict(lr=2e-3, warmup_steps=20, weight_decay=0.01)
RAG_GEN_STEPS, RAG_GEN_BATCH, RAG_GEN_SEQ = 300, 32, 24
# the trained generator's ROUGE-L with the float retriever: the reference
# reaches 0.73-0.86 over seeds 0-3 on the CPU (tools/rag_quality_seeds.py)
RAG_TRAINED_ROUGE_FLOOR = 0.5

# phase 11, the MoE LM family at full width: the port's copies of
# LLAMA4_SCOUT.config and KIMI_K2.config (src/repro/configs/lm_archs.py:
# 70-110), cut in depth only, weights drawn from the seed. 11a: a 1-layer
# llama4-scout cut with float32 activations (17.1 GB) on the card against
# a CPU copy, and the smoke configs' train steps; 11b: a 4-layer cut, one
# iRoPE period (layers 0-2 chunked, layer 3 global; 43.5 GB), in the
# config's dtypes, a prompt of 1.5 windows and decode steps in the second;
# 11c: a 1-layer kimi-k2 cut (bf16, 384 experts top-8; 38.8 GB). A
# prefill or decode is held against the teacher-forced forward at the
# no-drop capacity factor E / k (the reference's own check,
# tests/test_models_lm.py:49-80), in expert blocks that keep the dispatch
# buffers small.
MOE_CUT_PROMPT = (2, 64)        # batch, tokens
MOE_CUT_DECODE = 4
MOE_LOGIT_TOL = 1e-4            # 11a, float32 card against CPU: atol, rtol
MOE_TIE_TOL = 1e-4              # a router top-k margin under this: near-tie
MOE_SMOKE_BATCH = (4, 32)
SCOUT_LAYERS = 4
SCOUT_PROMPT = 12288            # 1.5 windows of attn_chunk 8192
SCOUT_MAX_LEN = 16384
SCOUT_DECODE = 8
SCOUT_CHECK_CHUNKS = 4          # expert blocks of the no-drop check
KIMI_PROMPT = (4, 64)
KIMI_DECODE = 4
KIMI_CHECK_CHUNKS = 8
# bf16 activations: prefill or decode logits against the no-drop forward.
# The two run the same products at other shapes (other rows in the expert
# products, other key counts in the global layer), so a bf16 rounding can
# land a step apart and carry through the layers: relative L2 within 2%
# and each logit within 8 bf16 steps of the largest
NO_DROP_RMS_TOL = 0.02
NO_DROP_STEPS = 8
CHUNK_ATTN_TOL = 1e-4           # float32 chunked layer vs the explicit mask

# phase 12, the recsys and GNN families at full width: the port's copies of
# the reference's configs (src/repro/configs/recsys_archs.py, gnn_archs.py)
# and cells (src/repro/configs/base.py RECSYS_SHAPES, GNN_SHAPES), weights
# drawn from the seed. 12a holds each family on the card to a CPU copy at
# serve_p99's batch, DLRM-MLPerf with each table cut to DLRM_CUT_ROWS rows
# (2.15 GB of tables). 12b runs the recsys cells at full width: DLRM-MLPerf
# serves at its full 187.8M rows in bfloat16, the config's own dtype field
# (48.1 GB of tables; float32 needs 96.1 GB) and trains and quantizes on the
# row cut; DIN's and DIEN's retrieval_cand runs in passes of CAND_PASS
# candidates (one pass of 10^6 candidates x 100 history items holds ~68 GB
# of DIN's attention-MLP inputs and activations, and 43 GB of DIEN's
# interest states, 86 GB while they are stacked). 12c runs PNA's full_graph_sm, molecule and
# minibatch_lg cells; ogb_products (2,449,408 nodes, 61,865,984 edges) needs
# over 80 GB for one layer's edge tensors and waits for sharding.
DLRM_CUT_ROWS = 524_288
RECSYS_TOL = 1e-5       # 12a: logits, loss and each grad leaf, relative
# 12a, PNA: its segment sums are atomics on the card, in an order that
# changes from run to run, and a node without in-edges scales its
# aggregates by delta / 1e-5 = 2.5e5 (the std's sqrt(1e-5) among them), so
# the order shows in the grads: held to the larger of PNA_TOL and
# PNA_REORDER x what shuffling the edges moves on the CPU
PNA_TOL = 1e-4
PNA_REORDER = 4.0
CAND_TOL = 1e-5         # score_candidates against forward on the same rows
CAND_TOL_BF16 = 2.0 ** -5
CAND_CHECK = 512
RECSYS_TRAIN_STEPS = 4
QT_K, QT_ITERS, QT_RESTARTS = 256, 10, 2
CAND_PASS = 262_144
PNA_STEPS = 3


# phase 13, distribution at world size 1 (one card: a one-rank NCCL group
# and a (1, 1) ("data", "model") mesh). 13a is the reference's serve_query
# cell (src/repro/configs/colpali_hpc.py:8-11, 22-26, 36-39: 64 queries
# of query_len 32 against 4,194,304 docs of kept_patches 616, top_k 128)
# through sharded_search_fn, on codes drawn on the card (no build: the
# cell's input is codes). Each doc's codes are drawn from a window of
# SERVE_WINDOW consecutive codebook entries; its mask holds the 615 of 616
# slots that doc-side top-p (p 60) keeps of a full 1024-patch page, and
# every query's 32 patches are valid. 13b is phase 4's build
# through Retriever.build(mesh=): full-batch Lloyd over all 16.7M patches
# with kmeans_minibatch = 65536 as the E-step's row block (phase 4 runs
# mini-batch Lloyd, so the codebooks differ by design). 13c: a checkpoint
# restored onto the mesh, GPipe over a one-stage "pipe" axis and the ring
# matmul over a one-rank "model" axis.
SERVE_DOCS = 4_194_304
SERVE_MD = 616
SERVE_QUERIES = 64
SERVE_TOP_K = 128
SERVE_WINDOW = 64
SERVE_SAMPLE = 65_536       # docs outside the top-k held to its last score
SERVE_WALLS = 5
SERVE_PLAIN_DOCS = 16_384   # the plain version's time is taken over these
INERTIA_TOL = 0.05          # 13b: mean inertia at most 5% above phase 4's
GPIPE_MICRO = 8

# phase 13f: the F5 ranks' wait (they take about 20-45 s on a card's host)
F5_TIMEOUT = 600.0

# phase 13e, model-internal sharding at world size 1 (a one-rank NCCL group
# and a (1, 1) mesh, as 13d's): each model run unsharded, then with its
# weights, optimizer state, caches and batches placed by their specs and
# the step given the sharder. The encoder is the full qwen2-1.5b ColPali
# encoder over MS_PAGES pages (phase 9b's micro-batch), its placed output
# indexed (flat) and searched; the scout cut is phase 11a's 1-layer
# full-width llama4-scout in float32, prefilling MOE_CUT_PROMPT and
# decoding MOE_CUT_DECODE steps; dcn-v2's train_batch and PNA's
# full_graph_sm are built by launch.cells.build_cell with and without the
# mesh from one seed. Forward values within MS_TOL (atol and rtol); a train
# step's loss within MS_TOL and its grad norm within MS_GNORM_TOL (PNA's
# segment sums and the tables' grads are float atomics on the card: their
# order changes from run to run), its new params within MS_PARAM_TOL.
MS_PAGES = 16
MS_QUERIES = 8
MS_TOL = 2e-5
MS_GNORM_TOL = 5e-5 * PNA_REORDER
MS_PARAM_TOL = 5e-5


# phase 14: the analysis engines and the dry run. The dry run's predicted
# peak is held to the card's within PEAK_BAND of the measured peak or
# PEAK_FLOOR, whichever is larger (the caching allocator rounds blocks to
# 512 B; cuBLAS's workspace is held before the measured calls; the
# kernels take no scratch).
DRYRUN_WORKERS = 6
PEAK_BAND = 0.10
PEAK_FLOOR = 256 * 2 ** 20
PREFETCH_BATCHES = 3    # launch.train's pipeline: 2 queued + 1 in hand

# phase 14e: the dry run at the production meshes, rank 0 of a fake
# process group of 256 ("single", (16, 16)) or 512 ranks ("multi", (2, 16,
# 16)). (a) these cells traced on fake CUDA tensors in worker processes;
# (b) rank 0's program of MESH_HELD run for real on the card in a worker
# process of its own fake 256-rank group, its peak above what it held and
# its FLOPs held to (a)'s trace of the same cell as phase 14c holds them
MESH_CELLS = (("qwen2-1.5b", "train_4k", "single"),
              ("llama4-scout-17b-a16e", "decode_32k", "single"),
              ("dlrm-mlperf", "train_batch", "single"),
              ("pna", "ogb_products", "single"),
              ("dien", "retrieval_cand", "single"),
              ("colpali-hpc", "serve_query", "single"),
              ("colpali-hpc", "serve_query", "multi"))
MESH_HELD = (("colpali-hpc", "serve_query"), ("dcn-v2", "train_batch"))
MESH_RANKS = 256


def _phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _bound(n_bytes: float, n_ops: float, ops_per_s: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _gemm_bounds(n_bytes: float, flops: float):
    """The bounds of a kernel whose operations are f32 products:
    (bound_ms, bound_by, f32_fma_bound_ms, tf32x3_bound_ms), where
    ``bound_ms`` is the larger of the bytes bound and the smaller of the
    two compute bounds."""
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    t_x3 = 3.0 * flops / PEAK_TF32_FLOPS * 1e3
    t_ops = min(t_f32, t_x3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_f32, t_x3)


def _time_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph, replayed between two CUDA events after a warm replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def _split(torch, fns, walls_of: int = 9):
    """Host wall and device time of each search part in ``fns``: the wall
    is the median of ``walls_of`` calls, each ending in a synchronize; the
    device time is the same part's kernels, merges and gathers replayed
    from a CUDA graph (so no host time). Prints and returns
    {name: {"host_wall": ms, "device": ms}}."""
    import numpy as np
    out = {}
    for name, fn in fns.items():
        walls = []
        for _ in range(walls_of):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        out[name] = {"host_wall": float(np.median(walls)),
                     "device": _time_ms(torch, fn, 3)}
        print(f"{name}: host wall {out[name]['host_wall']:.3f} ms, device "
              f"{out[name]['device']:.3f} ms")
    return out


def _qmaxsim_cost(table, q_mask, codes, mask, io_bytes):
    """(bytes, masked max-lookups) one quantized_maxsim call needs: every
    input read once, the output written once (``io_bytes``: the output and
    any input besides table, q_mask, codes and mask); a lookup per valid
    query patch and valid doc slot of that query's docs."""
    b, mq, _ = table.shape
    n_bytes = (table.numel() * 4 + b * mq * 4
               + codes.numel() * codes.element_size()
               + mask.numel() * mask.element_size() + io_bytes)
    q_valid = (q_mask != 0).reshape(b, mq).sum(dim=1)          # (B,)
    if codes.dim() == 3:                           # per-query pools
        d_valid = (mask != 0).reshape(b, -1).sum(dim=1)
        return n_bytes, int((q_valid * d_valid).sum())
    return n_bytes, int(q_valid.sum()) * int((mask != 0).sum())


def _hamming_cost(q_codes, codes, mask):
    """(bytes, popcounts) one hamming_maxsim call needs: every input read
    once, the output written once; a popcount per query patch and valid
    doc patch."""
    b, mq = q_codes.shape
    n = codes.shape[-2]
    n_bytes = (2 * b * mq * 4 + codes.numel() * codes.element_size()
               + mask.numel() * mask.element_size() + b * n * 4)
    return n_bytes, mq * int(mask.sum()) * (1 if codes.dim() == 3 else b)


def _maxsim_cost(q, docs, mask, rows=None):
    """(bytes, FLOPs) one maxsim call needs: every input read once, the
    output written once; 2*D FLOPs per query patch and valid doc patch.
    With ``rows`` (B, P) the input is the rows and the candidates' patches
    and masks, each distinct candidate read once; the FLOPs are per
    (query, candidate)."""
    b, mq, d = q.shape
    if rows is not None:
        live = rows[rows >= 0].long()
        uniq = live.unique()
        md = docs.shape[1]
        n_bytes = (q.numel() * 4 + b * mq * 4 + rows.numel() * 4
                   + uniq.numel() * md * (d * 4 + mask.element_size())
                   + rows.numel() * 4)
        return n_bytes, 2 * d * mq * int(mask[live].sum())
    n = docs.shape[-3]
    n_bytes = (q.numel() * 4 + b * mq * 4 + docs.numel() * 4
               + mask.numel() * mask.element_size() + b * n * 4)
    return n_bytes, 2 * d * mq * int(mask.sum()) * (1 if docs.dim() == 4
                                                     else b)


def _check_assign(torch, x, codebook, got, want) -> float:
    """Hold kmeans_assign's codes ``got`` to its plain version's ``want``:
    agreement >= KMEANS_AGREE, and every disagreement a near-tie whose two
    distances c2 - 2 x.c differ by <= KMEANS_TIE_TOL in float64. Returns
    the largest such gap."""
    got, want = got.long(), want.long()
    n = got.numel()
    rows = torch.nonzero(got != want)[:, 0]
    agree = 1.0 - rows.numel() / n
    xd, cd = x[rows].double(), codebook.double()
    c2 = (cd * cd).sum(-1)

    def dist(kk):
        return c2[kk] - 2.0 * (xd * cd[kk]).sum(-1)

    gap = (dist(got[rows]) - dist(want[rows])).abs()
    max_gap = float(gap.max()) if rows.numel() else 0.0
    print(f"kmeans_assign {n}x{x.shape[1]} K={codebook.shape[0]}: agreement "
          f"{agree:.7f}, {rows.numel()} near-ties, max distance gap "
          f"{max_gap:.3e}")
    assert agree >= KMEANS_AGREE, f"kmeans_assign agreement {agree}"
    assert max_gap <= KMEANS_TIE_TOL, f"kmeans_assign gap {max_gap}"
    return max_gap


def _check_first_batch(torch, np, run, cpu_state, tol) -> int:
    """The first served batch against the same search over a CPU copy of
    the state (the plain path): ids outside near-ties, scores within
    ``tol``. Returns how many ids differ at all (ties included)."""
    from repro_torch.parity import topk_mismatches
    from repro_torch.retrieval import Query
    q, q_m, q_s = (torch.from_numpy(a[:MAX_BATCH]) for a in run.queries)
    cpu_s, cpu_i = (t.numpy() for t in run.retriever.search(
        cpu_state, Query(q, q_m, q_s), k=TOP_K))
    srv_s = np.stack([r[0] for r in run.results[:MAX_BATCH]])
    srv_i = np.stack([r[1] for r in run.results[:MAX_BATCH]])
    assert np.isfinite(srv_s).all() and srv_i.shape == (MAX_BATCH, TOP_K)
    np.testing.assert_allclose(srv_s, cpu_s, atol=tol, rtol=tol)
    bad = topk_mismatches(srv_i, srv_s, cpu_i, cpu_s, tol)
    assert not bad, f"served ids differ from the CPU plain path at {bad}"
    return int((srv_i != cpu_i).sum())


def _casc_per_batch(r, state):
    """Kernel launches of one cascade search of a batch on ``state``."""
    seg = r.backend._segmented(state)
    return {"hamming_maxsim": sum(math.ceil(lv.shape[0] / BLOCK_DOCS)
                                  for lv in seg.live),
            "quantized_maxsim": 1, "maxsim": math.ceil(P2 / BLOCK_DOCS),
            "kmeans_assign": 1}


def _live_rounds(torch, np, r, sess, queries, delta, upsert, dead,
                 kernel_mods):
    """Phase 7's schedule on a cascade's LiveIndexSession: N_REQUESTS
    requests in rounds of one batch, with the add of docs N_BASE-N_DOCS
    (ids = corpus positions) after round 1, the upserts after round 3 and
    the deletes after round 5, the launch counters at 0 just before.
    Returns the responses (round, query, Served), the launches and those
    the batches served imply, each mutation's and round's seconds, the
    window's stats, the state after the add and the batches served."""
    def submit_round(lo, hi):
        reqs = [(qi, sess.submit(*(a[qi] for a in queries)))
                for qi in range(lo, hi)]
        out = []
        for qi, req in reqs:
            assert req.event.wait(300.0), "a request hung"
            if req.error is not None:
                raise req.error
            out.append((qi, req.result))
        return out

    for mod in kernel_mods.values():
        mod.launches = 0
    sess.server.reset_stats()
    responses, round_s, mut_s, expect = [], [], {}, {}
    state_a = None
    n_batches_seen = 0
    for rnd in range(N_REQUESTS // MAX_BATCH):
        per_batch = _casc_per_batch(r, sess.state)
        t1 = time.perf_counter()
        responses += [(rnd, qi, out) for qi, out in submit_round(
            rnd * MAX_BATCH, (rnd + 1) * MAX_BATCH)]
        round_s.append(time.perf_counter() - t1)
        n_now = sum(v["batches"] for v in sess.stats()["rungs"].values())
        for name, n in per_batch.items():
            expect[name] = expect.get(name, 0) + n * (n_now - n_batches_seen)
        n_batches_seen = n_now
        t1 = time.perf_counter()
        if rnd == 1:        # (a) the remaining docs, ids = corpus positions
            sess.add(delta, doc_ids=np.arange(N_BASE, N_DOCS))
            state_a = sess.state
        elif rnd == 3:      # (b) upserts: the newest segment wins
            sess.add(upsert, doc_ids=np.array(UPSERT_IDS))
        elif rnd == 5:      # (c) deletes
            sess.delete(dead)
        else:
            continue
        torch.cuda.synchronize()
        mut_s[{1: "add", 3: "upsert", 5: "delete"}[rnd]] = \
            time.perf_counter() - t1
    # the adds' query-independent launches: each add encodes its delta
    # for the Hamming and the ADC member
    expect["kmeans_assign"] += 2 * 2
    return {"responses": responses, "expect": expect, "mut_s": mut_s,
            "launches": {name: mod.launches
                         for name, mod in kernel_mods.items()},
            "round_s": round_s, "stats": sess.stats(), "state_a": state_a,
            "batches": n_batches_seen}


def _live_phase(args, torch, np, dev, smi, spec, cfg, cfg_c, flat_s,
                flat_retriever, flat_hit, casc_qps, mono_split, kernel_mods):
    """Phase 7: the cascade served live at full width through
    LiveIndexSession while documents are added, upserted, deleted and
    compacted, an overload drill, and the flat path mutated. Returns the
    launch counts of the live window, stage 3's times on the segmented
    state, and for phase 8 the state before its compaction, the
    retriever, the host queries and the added documents."""
    from repro_torch import state_to
    from repro_torch.core import index as index_mod
    from repro_torch.data.synthetic import make_retrieval_corpus
    from repro_torch.kernels import maxsim as ms
    from repro_torch.kernels import quantized_maxsim as qm
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.parity import topk_mismatches
    from repro_torch.retrieval import Corpus, Query, Retriever
    from repro_torch.retrieval.base import encode_delta
    from repro_torch.retrieval.float_flat import pruned_embeddings
    from repro_torch.serving import (DeadlineExceeded, FaultInjected,
                                     LiveIndexSession, Overloaded,
                                     ResilienceConfig, ServeConfig, Served)

    t0 = _phase("live cascade at full width")
    torch.cuda.reset_peak_memory_stats()
    data = make_retrieval_corpus(spec, seed=args.seed, device=dev)
    queries = tuple(a.cpu().numpy() for a in (
        data.query_patches, data.query_mask, data.query_salience))
    relevance = data.relevance.cpu().numpy()
    r = Retriever(cfg_c)
    t1 = time.perf_counter()
    base = r.build(torch.Generator(device=dev).manual_seed(args.seed + 1),
                   Corpus(data.doc_patches[:N_BASE], data.doc_mask[:N_BASE],
                          data.doc_salience[:N_BASE]))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    delta = Corpus(*(a[N_BASE:].clone() for a in (
        data.doc_patches, data.doc_mask, data.doc_salience)))
    n_up = len(UPSERT_IDS)
    q_up = data.query_patches[UPSERT_QUERY:UPSERT_QUERY + n_up]
    reps = N_PATCHES // N_Q_PATCHES
    upsert = Corpus(q_up.repeat(1, reps, 1),
                    torch.ones((n_up, N_PATCHES), dtype=torch.bool,
                               device=dev),
                    torch.linspace(1.0, 0.5, N_PATCHES, device=dev)
                    .repeat(n_up, 1))
    del data
    torch.cuda.empty_cache()
    rng = np.random.default_rng(args.seed)
    # every target of the queries served after the delete (the last two
    # rounds), and random ids; never an upserted id
    targets = np.arange(N_REQUESTS - 2 * MAX_BATCH, N_REQUESTS) * 4
    pool = np.setdiff1d(np.arange(N_DOCS), np.concatenate(
        [targets, np.array(UPSERT_IDS)]))
    dead = np.sort(np.concatenate([targets, rng.choice(
        pool, N_DEAD - targets.size, replace=False)]))

    res = ResilienceConfig(**LIVE_RESILIENCE)
    sess = LiveIndexSession(r, base, ServeConfig(
        max_batch=MAX_BATCH, top_k=TOP_K, guard_recompiles=True,
        resilience=res), device=dev)
    n_levels = 1 + len(sess.degrade_rungs)
    t1 = time.perf_counter()
    sess.warm_shapes(*(a[0] for a in queries))
    warm_s = time.perf_counter() - t1
    print(f"base build over docs 0-{N_BASE - 1} {build_s:.2f}s | ladder "
          f"{sess.server.ladder} x {n_levels} levels (rungs "
          f"{sess.degrade_rungs}) warmed in {warm_s:.3f}s")

    rounds = _live_rounds(torch, np, r, sess, queries, delta, upsert, dead,
                          kernel_mods)
    responses, launches, expect, mut_s, round_s = (rounds[k] for k in (
        "responses", "launches", "expect", "mut_s", "round_s"))
    states = {"a": rounds["state_a"]}
    n_batches_seen = rounds["batches"]
    st = window = rounds["stats"]
    serve_qps = N_REQUESTS / sum(round_s)
    print(f"live window: {st['n']} requests in {n_batches_seen} batches, "
          f"window QPS {st['qps']:.1f} (mutations included), serving QPS "
          f"{serve_qps:.1f} (rounds only), p50 {st['p50_ms']:.2f} ms, p99 "
          f"{st['p99_ms']:.2f} ms | mutations {mut_s} s")
    print(f"launches in the live window: {launches}; expected {expect}")
    assert launches == expect, "live cascade launches off"
    assert st["n"] == N_REQUESTS and all(
        isinstance(o, Served) and o.level == 0 for _, _, o in responses)

    # deleted ids never served after the delete; each upserted id at most
    # once per response, carrying its new document's score
    up_emb, up_mask = pruned_embeddings(upsert, cfg_c)
    n_up_seen = 0
    for rnd, qi, (scores, ids) in responses:
        live_ids = ids[ids >= 0]
        assert len(set(live_ids.tolist())) == live_ids.size, (qi, ids)
        if rnd >= 6:
            assert not set(live_ids.tolist()) & set(dead.tolist()), qi
        if rnd < 4:
            continue
        q = torch.from_numpy(queries[0][qi:qi + 1]).to(dev)
        qmk = torch.from_numpy(queries[1][qi:qi + 1]).to(dev).float()
        new = ms.maxsim_plain(q, qmk, up_emb, up_mask)[0].cpu().numpy()
        for j, doc in enumerate(UPSERT_IDS):
            hit = np.nonzero(ids == doc)[0]
            if hit.size:
                n_up_seen += 1
                np.testing.assert_allclose(scores[hit[0]], new[j],
                                           rtol=MAXSIM_TOL, atol=MAXSIM_TOL)
    print(f"no deleted id in the {2 * MAX_BATCH} responses after the "
          f"delete; upserted ids served {n_up_seen} times, each at most "
          f"once per response and at its new page's score")

    # hit@10 on the state after (a), against phase 4's flat hit@10
    hits = 0
    for lo in range(0, N_REQUESTS, MAX_BATCH):
        q = Query(*(torch.from_numpy(a[lo:lo + MAX_BATCH]).to(dev)
                    for a in queries))
        ids = r.search(states["a"], q, k=TOP_K)[1].cpu().numpy()
        for i, row in enumerate(ids):
            hits += int((relevance[lo + i][row[row >= 0]] > 0).any())
    hit_a = hits / N_REQUESTS
    print(f"hit@{TOP_K} on the state after the add {hit_a:.3f} (flat "
          f"{flat_hit:.3f})")
    assert hit_a >= 0.95 * flat_hit, f"live hit@{TOP_K} {hit_a}"
    del states

    # one batch on the mutated state: exact launches, and equal to the CPU
    # plain path (the stage-1 pools identical)
    cur = sess.state
    q, q_m, q_s = (torch.from_numpy(a[:MAX_BATCH]) for a in queries)
    qg = Query(q.to(dev), q_m.to(dev), q_s.to(dev))
    for mod in kernel_mods.values():
        mod.launches = 0
    got_s, got_i = r.search(cur, qg, k=TOP_K)
    one = {name: mod.launches for name, mod in kernel_mods.items()}
    per_batch = _casc_per_batch(r, cur)
    caps = [lv.shape[0] for lv in r.backend._segmented(cur).live]
    print(f"one batch on segments {caps}: launches {one}, expected "
          f"{per_batch} (hamming: sum of ceil(cap / {BLOCK_DOCS}))")
    assert one == per_batch, "segmented launches off"
    t1 = time.perf_counter()
    cpu_state = state_to(cur, "cpu")
    cq = Query(q, q_m, q_s)
    (ham_b, ham_v), (flat_b, flat_v), (ff_b, ff_v) = r.backend._views(cur)
    (_, cpu_ham_v), _, _ = r.backend._views(cpu_state)
    # the upserts resolve to their newest segment on the card: stage 3
    # with each upserted id as its page's query's only candidate scores
    # the new page; and where those pages stand in the stage-1 and
    # stage-2 pools (an appended page loses ties to earlier positions)
    qu = Query(*(torch.from_numpy(a[UPSERT_QUERY:UPSERT_QUERY + n_up])
                 .to(dev) for a in queries))
    cand = torch.tensor(UPSERT_IDS, dtype=torch.int32, device=dev)[:, None]
    s_new, i_new = ff_b.search_candidates(ff_v, qu, cand, k=1)
    want_new = torch.diagonal(ms.maxsim_plain(
        qu.embeddings, qu.mask.float(), up_emb, up_mask))
    assert i_new[:, 0].tolist() == list(UPSERT_IDS), i_new
    torch.testing.assert_close(s_new[:, 0], want_new, atol=MAXSIM_TOL,
                               rtol=MAXSIM_TOL)
    up_s1, up_i1 = ham_b.search(ham_v, qu, k=P1)
    up_s2, up_i2 = flat_b.search_candidates(flat_v, qu, up_i1, k=P2)
    up_col = cand.expand(-1, 1)
    print(f"upserts resolve to the newest segment (stage 3 scores the new "
          f"pages, {s_new[:, 0].tolist()}); in their queries' stage-1 pools "
          f"{(up_i1 == up_col).any(dim=1).tolist()} (p1-th score "
          f"{up_s1[:, -1].tolist()}, max score count "
          f"{(up_s1 == up_s1[:, :1]).sum(dim=1).tolist()}); in the stage-2 "
          f"pools {(up_i2 == up_col).any(dim=1).tolist()}")
    pool_gpu = ham_b.search(ham_v, qg, k=P1)
    pool_cpu = ham_b.search(cpu_ham_v, cq, k=P1)
    assert torch.equal(pool_gpu[0].cpu(), pool_cpu[0]), "stage-1 scores"
    assert torch.equal(pool_gpu[1].cpu(), pool_cpu[1]), "stage-1 pools"
    cpu_s, cpu_i = (t.numpy() for t in r.search(cpu_state, cq, k=TOP_K))
    np.testing.assert_allclose(got_s.cpu().numpy(), cpu_s, atol=MAXSIM_TOL,
                               rtol=MAXSIM_TOL)
    bad = topk_mismatches(got_i.cpu().numpy(), got_s.cpu().numpy(), cpu_i,
                          cpu_s, MAXSIM_TOL)
    assert not bad, f"live cascade ids differ from the CPU plain path {bad}"
    del cpu_state, cpu_ham_v
    print(f"stage-1 pools ({MAX_BATCH} x {P1}) identical on the card and "
          f"the CPU; the batch == CPU plain funnel (ids outside near-ties, "
          f"scores within {MAXSIM_TOL}); CPU {time.perf_counter() - t1:.1f}s")

    # the segmented search split by stage, beside phase 6's monolithic
    # one; stage 3's kernel through the segment table
    _, ids1 = pool_gpu
    _, ids2 = flat_b.search_candidates(flat_v, qg, ids1, k=P2)
    split = _split(torch, {
        "stage 1 (hamming prefilter, p1)": lambda: ham_b.search(
            ham_v, qg, k=P1),
        "stage 2 (ADC rescore, p2)": lambda: flat_b.search_candidates(
            flat_v, qg, ids1, k=P2),
        "stage 3 (float rerank, top-k)": lambda: ff_b.search_candidates(
            ff_v, qg, ids2, k=TOP_K),
        "whole search": lambda: r.search(cur, qg, k=TOP_K)})
    seg_ff = ff_v.backend_state
    pos2 = index_mod._resolve_segmented(seg_ff, ids2)[2]
    segs = tuple(p.embeddings for p in seg_ff.segments)
    masks = tuple(p.mask for p in seg_ff.segments)
    qf = qg.embeddings.float().contiguous()
    qmf = qg.mask.float().contiguous()
    md_kept = segs[0].shape[1]
    rows_ms = _time_ms(torch, lambda: ms.maxsim_cuda(
        qf, qmf, segs, masks, rows=pos2), 100)
    rows_plain_ms = _time_ms(torch, lambda: ms.maxsim_plain(
        qf, qmf, segs, masks, rows=pos2), 20)
    # the segments' masks as one (N, Md) mask of flattened positions
    rows_bound = _gemm_bounds(*_maxsim_cost(qf, segs[0], torch.cat(masks),
                                            rows=pos2))
    print(f"stage 3's maxsim through the {len(segs)}-segment table: "
          f"{rows_ms * 1e3:.1f} us (bound {rows_bound[0] * 1e3:.1f} us, "
          f"plain {rows_plain_ms:.3f} ms)")
    print(json.dumps({"live_cascade_ms": {"segments": caps,
                                          "segmented": split,
                                          "monolithic": mono_split}}))

    # compaction keeps the results; the state registry stayed bounded.
    # The state before it stays for phase 8a's index file
    before = r.search(cur, qg, k=TOP_K)
    pre_compact = cur
    del cur, ff_v, flat_v, ham_v, seg_ff, segs, masks
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sess.compact()
    torch.cuda.synchronize()
    mut_s["compact"] = time.perf_counter() - t1
    after = r.search(sess.state, qg, k=TOP_K)
    torch.testing.assert_close(after[0], before[0], atol=MAXSIM_TOL,
                               rtol=MAXSIM_TOL)
    bad = topk_mismatches(after[1].cpu().numpy(), after[0].cpu().numpy(),
                          before[1].cpu().numpy(), before[0].cpu().numpy(),
                          MAXSIM_TOL)
    assert not bad, f"compaction changed the results at {bad}"
    sigs = sess.state_signatures()
    cap_base, cap_all = N_BASE, index_mod.segment_capacity(N_DOCS - N_DEAD)
    want_sigs = {((cap_base,),), ((cap_base,), (N_DOCS - N_BASE,)),
                 ((cap_base,), (N_DOCS - N_BASE,), (8,)), ((cap_all,),)}
    print(f"compact {mut_s['compact']:.2f}s, results unchanged; state "
          f"signatures {sigs}")
    assert {k[0] for k in sigs} == want_sigs, sigs
    assert {k[1] for k in sigs} == {index_mod.segment_capacity(N_DOCS)}

    # the overload drill: open-loop Poisson arrivals at DRILL_LOAD x phase
    # 5's served QPS; a quarter carry a 100 ms deadline, half are "batch"
    sess.server.reset_stats()
    rate = DRILL_LOAD * casc_qps
    reqs = []
    for i in range(DRILL_REQUESTS):
        qi = i % N_REQUESTS
        reqs.append(sess.submit(
            *(a[qi] for a in queries),
            deadline_ms=100.0 if i % 4 == 0 else None,
            slo="batch" if i % 2 else "interactive"))
        time.sleep(rng.exponential(1.0 / rate))
    outcome = {"Served": 0, "Overloaded": 0, "DeadlineExceeded": 0}
    levels = {}
    for req in reqs:
        assert req.event.wait(300.0), "a drill request hung"
        if req.error is None:
            assert isinstance(req.result, Served)
            outcome["Served"] += 1
            levels[req.result.level] = levels.get(req.result.level, 0) + 1
        else:
            assert isinstance(req.error, (Overloaded, DeadlineExceeded)), \
                repr(req.error)
            outcome[type(req.error).__name__] += 1
    st = sess.stats()
    transitions = len(sess.server._async._degrade.transitions)
    level = st["degrade_level"]
    for _ in range(200):                        # a trickle after the burst
        out = sess.query(*(a[0] for a in queries), timeout=60.0)
        level = sess.stats()["degrade_level"]
        if out.level == 0 and level == 0:
            break
        time.sleep(0.02)
    print(f"overload drill: {DRILL_REQUESTS} requests at {rate:.0f} QPS "
          f"(4 x {casc_qps:.1f}): {outcome}; served by level {levels}; "
          f"{transitions} level transitions; shed {st['shed']} (batch "
          f"{st['shed_batch']}); deadline expired {st['deadline_expired']};"
          f" level after the burst {level}")
    assert sum(outcome.values()) == DRILL_REQUESTS
    assert transitions >= 1 and level == 0, (transitions, level)
    sigs = set(sess.server.recompile_sentry.signatures)
    want = {(b, N_Q_PATCHES, "torch.float32", "torch.bool", "torch.float32",
             lv) for b in sess.server.ladder for lv in range(n_levels)}
    assert sigs == want, sigs
    sess.server.fault_injector.arm("compute")
    try:
        sess.query(*(a[1] for a in queries), timeout=60.0)
        raise AssertionError("the armed compute fault did not fire")
    except FaultInjected:
        pass
    out = sess.query(*(a[2] for a in queries), timeout=60.0)
    assert isinstance(out, Served)
    print(f"sentry signatures: exactly {len(sigs)} = rungs x levels; an "
          f"armed compute fault failed its batch with FaultInjected, the "
          f"next batch was served")
    peak = torch.cuda.max_memory_allocated() / 2**30
    sess.close()
    del sess

    # the flat path mutated: phase 4's state, 2048 docs added (fresh ids)
    # and 512 deleted; S sweep launches + 1 rerank launch per batch
    t1 = time.perf_counter()
    enc = encode_delta(flat_s.codebook, delta, cfg)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t1
    x_delta = delta.embeddings.reshape(-1, DIM)
    km_delta_ms = _time_ms(torch, lambda: km.kmeans_assign_cuda(
        x_delta, flat_s.codebook), 3)
    del enc, x_delta
    t1 = time.perf_counter()
    fs = flat_retriever.add(flat_s, delta)
    torch.cuda.synchronize()
    flat_add_s = time.perf_counter() - t1
    fs = flat_retriever.delete(fs, dead)
    n_seg = len(flat_retriever.backend._segmented(fs).live)
    qm.launches = 0
    f_s, f_i = flat_retriever.search(fs, qg, k=TOP_K)
    assert qm.launches == n_seg + 1, qm.launches
    c_s, c_i = (t.numpy() for t in flat_retriever.search(
        state_to(fs, "cpu"), cq, k=TOP_K))
    np.testing.assert_allclose(f_s.cpu().numpy(), c_s, atol=QMAXSIM_TOL,
                               rtol=QMAXSIM_TOL)
    bad = topk_mismatches(f_i.cpu().numpy(), f_s.cpu().numpy(), c_i, c_s,
                          QMAXSIM_TOL)
    assert not bad, f"mutated flat ids differ from the CPU at {bad}"
    assert not set(f_i.cpu().numpy().ravel().tolist()) & set(dead.tolist())
    print(f"flat: add of {N_DOCS - N_BASE} docs {flat_add_s:.3f}s "
          f"(encode_delta {encode_s:.3f}s, of it kmeans_assign "
          f"{km_delta_ms:.3f} ms at {(N_DOCS - N_BASE) * N_PATCHES} x {DIM}) "
          f"| {n_seg} segments: {n_seg} sweep launches + 1 rerank launch, "
          f"the batch == CPU plain path")
    print(f"live phase: mutation seconds {mut_s} | max_memory_allocated "
          f"{peak:.2f} GiB | {smi} | phase {time.perf_counter() - t0:.1f}s")
    return {"launches": launches, "rows_ms": rows_ms,
            "state": pre_compact, "retriever": r, "queries": queries,
            "delta": delta, "base": base, "upsert": upsert, "dead": dead,
            "responses": responses, "expect": expect, "mut_s": mut_s,
            "window": {"qps": serve_qps, "p50_ms": window["p50_ms"],
                       "p99_ms": window["p99_ms"]},
            "rows_plain_ms": rows_plain_ms, "rows_bound_ms": rows_bound[0],
            "rows_shape": f"stage-3 rows through a {len(caps)}-segment "
                          f"table {caps}: B={MAX_BATCH} Mq={N_Q_PATCHES} "
                          f"D={DIM} {P2} candidates x Md={md_kept} per "
                          f"query"}


def _same_results(torch, a, b, what):
    """Two (scores, ids) of a search on a state and on its reloaded copy:
    ids equal, scores within SAVE_TOL (integer scores equal)."""
    assert torch.equal(a[1], b[1]), f"{what}: ids differ after reload"
    if a[0].dtype.is_floating_point:
        err = float((a[0].double() - b[0].double()).abs().max())
        assert err <= SAVE_TOL, f"{what}: scores differ by {err}"
        return err
    assert torch.equal(a[0], b[0]), f"{what}: scores differ after reload"
    return 0.0


def _index_files(torch, dev, live, flat_s, flat_retriever):
    """Phase 8a: phase 7's live cascade (before its compaction: segments
    14336 + 2048 + 8) and phase 4's flat state written as index files in
    a temporary directory under build/, read back onto the card and
    searched on one batch: ids equal and scores within SAVE_TOL at every
    stage. Returns {name: {"bytes", "save_s", "save_crc32_s", "load_s",
    "load_crc32_s"}}."""
    import os
    import shutil
    import tempfile
    from repro_torch.retrieval import Query
    from repro_torch.retrieval import base as base_mod

    t0 = _phase("8a. index files: save, load, search")
    out_dir = ROOT / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    qg = Query(*(torch.from_numpy(a[:MAX_BATCH]).to(dev)
                 for a in live["queries"]))
    report = {}
    with tempfile.TemporaryDirectory(dir=out_dir,
                                     prefix="index_files_") as tmp:
        print(f"free space under build/: "
              f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB")
        for name, ret, state in (
                ("live cascade", live["retriever"], live["state"]),
                ("flat", flat_retriever, flat_s)):
            torch.cuda.synchronize()
            path = ret.save(os.path.join(tmp, name.replace(" ", "_")), state)
            save = dict(base_mod.last_io)
            loaded = ret.load(path, device=dev)
            load = dict(base_mod.last_io)
            errs = []
            if ret.cfg.backend == "cascade":
                va, vb = ret.backend._views(state), ret.backend._views(loaded)
                (hb, ha), (fb, fa), (ffb, ffa) = va
                (_, hl), (_, fl), (_, ffl) = vb
                s1 = [hb.search(v, qg, k=P1) for v in (ha, hl)]
                errs.append(_same_results(torch, *s1, "stage 1"))
                s2 = [fb.search_candidates(v, qg, s1[0][1], k=P2)
                      for v in (fa, fl)]
                errs.append(_same_results(torch, *s2, "stage 2"))
                s3 = [ffb.search_candidates(v, qg, s2[0][1], k=TOP_K)
                      for v in (ffa, ffl)]
                errs.append(_same_results(torch, *s3, "stage 3"))
            else:
                s1 = [ret.backend.search(v, qg, k=RERANK)
                      for v in (state, loaded)]
                errs.append(_same_results(torch, *s1, "sweep"))
            errs.append(_same_results(
                torch, ret.search(state, qg, k=TOP_K),
                ret.search(loaded, qg, k=TOP_K), "served batch"))
            report[name] = {"bytes": save["bytes"], "save_s": save["seconds"],
                            "save_crc32_s": save["crc32_seconds"],
                            "load_s": load["seconds"],
                            "load_crc32_s": load["crc32_seconds"]}
            r = report[name]
            print(f"{name}: {r['bytes'] / 1e9:.3f} GB | save "
                  f"{r['save_s']:.2f}s (crc32 {r['save_crc32_s']:.2f}s, "
                  f"{r['save_crc32_s'] / r['save_s']:.0%}) | load onto the "
                  f"card {r['load_s']:.2f}s (crc32 {r['load_crc32_s']:.2f}s,"
                  f" {r['load_crc32_s'] / r['load_s']:.0%}) | one batch on "
                  f"the loaded state: ids equal, max |score diff| "
                  f"{max(errs):.1e} at every stage")
            os.remove(path)
            del loaded
            torch.cuda.empty_cache()
    print(json.dumps({"index_files": report}))
    print(f"index files phase {time.perf_counter() - t0:.1f}s")
    return report


def _ann_phase(args, torch, np, dev, cfg, flat_s, flat_retriever, queries,
               relevance, delta, kernel_mods, lds_per_s):
    """Phases 8b-8d: IVF over phase 4's codes (16384 docs) and HNSW over
    the first N_HNSW of them, each served through AsyncRetrievalServer
    with exact launch counts, held to the CPU plain path and to the flat
    sweep (tie-aware recall@10); the latency of one search of each router
    and of the flat sweep; then both routers live (an add of N_ANN_ADD
    docs and N_ANN_DEAD deletes through LiveIndexSession, compaction).
    Returns the launch counts by path, the routers' kernel times and
    their monolithic states (phase 13d's)."""
    import dataclasses

    from repro_torch import state_to
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import index as index_mod
    from repro_torch.core import late_interaction as li
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import quantized_maxsim as qm
    from repro_torch.launch.serve import serve_state
    from repro_torch.parity import tie_aware_recall_at_k, topk_mismatches
    from repro_torch.retrieval import (Corpus, HNSWConfig, IVFConfig, Query,
                                       Retriever, RetrieverState)
    from repro_torch.retrieval.hnsw import HNSWState
    from repro_torch.retrieval.ivf import IVFState
    from repro_torch.serving import LiveIndexSession, ServeConfig

    flat = flat_s.backend_state
    codes, mask, cb = flat.codes, flat.mask, flat.codebook
    qs_all = [Query(*(torch.from_numpy(a[lo:lo + MAX_BATCH]).to(dev)
                      for a in queries))
              for lo in range(0, N_REQUESTS, MAX_BATCH)]
    qg = qs_all[0]
    cq = Query(*(torch.from_numpy(a[:MAX_BATCH]) for a in queries))
    f_backend = flat_retriever.backend

    def recall(ret, state, oracle_state):
        """Tie-aware recall@10 of the router's own top-10 (no rerank)
        against the flat sweep's over the same codes, all queries."""
        got_s, got_i, ora = [], [], []
        for qq in qs_all:
            s_, i_ = ret.backend.search(state, qq, k=TOP_K)
            got_s.append(s_.cpu().numpy())
            got_i.append(i_.cpu().numpy())
            ora.append(f_backend.search(oracle_state, qq, k=TOP_K)[0]
                       .cpu().numpy())
        return tie_aware_recall_at_k(np.concatenate(got_s),
                                     np.concatenate(got_i),
                                     np.concatenate(ora), TOP_K)

    def serve(name, ret, state, rel, build_assigns):
        """Serve N_REQUESTS through AsyncRetrievalServer: 2
        quantized_maxsim launches per searched batch (the router's pool
        and the rerank), no kmeans_assign launch past the build's
        ``build_assigns`` (the counters were zeroed before the build); the
        first batch against the CPU plain path."""
        run = serve_state(ret, state, queries, rel, n_requests=N_REQUESTS,
                          max_batch=MAX_BATCH, top_k=TOP_K, device=dev)
        got = {n: mod.launches for n, mod in kernel_mods.items()}
        st = run.stats
        n_b = sum(v["batches"] for v in st["rungs"].values())
        want = {"quantized_maxsim": 2 * (n_b + len(run.ladder)),
                "kmeans_assign": build_assigns, "hamming_maxsim": 0,
                "maxsim": 0}
        print(f"{name}: served {st['n']} requests in {run.serve_s:.3f}s, "
              f"{st['qps']:.1f} QPS, p50 {st['p50_ms']:.2f} ms, p99 "
              f"{st['p99_ms']:.2f} ms over {n_b} batches | hit@{TOP_K} "
              f"{run.hit_rate:.3f} | launches {got}, expected {want}")
        assert got == want, f"{name} launches off"
        assert st["n"] == N_REQUESTS
        t1 = time.perf_counter()
        n_diff = _check_first_batch(torch, np, run, state_to(state, "cpu"),
                                    QMAXSIM_TOL)
        assert n_diff == 0, f"{name}: {n_diff} ids differ from the CPU"
        print(f"{name}: first batch == CPU plain path (ids equal, scores "
              f"within {QMAXSIM_TOL}); CPU {time.perf_counter() - t1:.1f}s")
        return run, got

    def pool_times(tab, c, m, v):
        """quantized_maxsim on a router's pool at the search's k: the
        kernel, its plain version and its bounds."""
        r_len = qm.launch_range_len(MAX_BATCH, c.shape[-2], dev)
        lists = MAX_BATCH * -(-c.shape[-2] // r_len) * min(RERANK, r_len) * 8
        qmf = qg.mask.float().contiguous()
        n_bytes, ops = _qmaxsim_cost(tab, qmf, c, m, v.numel() + lists)
        return {"ms": _time_ms(torch, lambda: qm.quantized_maxsim_topk_cuda(
                    tab, qmf, c, m, v, k=RERANK, range_len=r_len), 50),
                "plain_ms": _time_ms(
                    torch, lambda: qm.quantized_maxsim_topk_plain(
                        tab, qmf, c, m, v, k=RERANK, range_len=r_len), 3),
                "bound_ms": _bound(n_bytes, ops)[0],
                "lds_bound_ms": ops / lds_per_s * 1e3,
                "shape": f"B={MAX_BATCH} Mq={N_Q_PATCHES} K={K} "
                         f"{c.shape[-2]} candidates x Md={c.shape[-1]} per "
                         f"query, top-{RERANK}"}

    out = {"launches": {}}
    table = li.adc_table(qg.embeddings, cb).contiguous()

    # -- 8b. IVF at full width over phase 4's codes ------------------------
    t0 = _phase("8b. ivf at full width")
    ivf_cfg = IVFConfig()
    for mod in kernel_mods.values():
        mod.launches = 0
    t1 = time.perf_counter()
    ivf = index_mod.build_ivf(
        torch.Generator(device=dev).manual_seed(args.seed + 2), codes, mask,
        cb, ivf_cfg)
    torch.cuda.synchronize()
    ivf_build_s = time.perf_counter() - t1
    doc_vec = index_mod.doc_mean_vectors(codes, mask, cb)
    # the realised loads, through the plain assignment (no launch counted)
    loads = torch.bincount(km.kmeans_assign_plain(
        doc_vec, ivf.routing_centroids).long(), minlength=IVF_N_LIST)
    build_assigns = 1                 # the build's routing assignment
    drop = index_mod.ivf_drop_rate(ivf, N_DOCS)
    cap = ivf.bucket_valid.shape[1]
    print(f"ivf build {ivf_build_s:.2f}s (n_list {IVF_N_LIST}, "
          f"{ivf_cfg.iters} iterations x {ivf_cfg.restarts} restarts) | "
          f"drop rate {drop:.4f} at cap {cap} | bucket loads: largest "
          f"{int(loads.max())}, smallest {int(loads.min())}")
    if drop > ivf_cfg.max_drop_rate:
        # the default cap overflows at this corpus: the realised largest
        # load instead, through the same centroids (max_drop_rate stays)
        cap = int(loads.max())
        ivf, _ = index_mod.make_ivf_segment(codes, mask, cb,
                                            ivf.routing_centroids,
                                            flat.doc_ids, cap=cap)
        build_assigns += 1
        drop = index_mod.ivf_drop_rate(ivf, N_DOCS)
        print(f"ivf: cap set to the largest load {cap}: drop rate {drop}")
    assert drop <= ivf_cfg.max_drop_rate
    share = IVF_N_PROBE * cap / N_DOCS
    print(f"ivf: n_probe {IVF_N_PROBE} x cap {cap} = {IVF_N_PROBE * cap} "
          f"slots per query, {share:.1%} of the corpus scanned")
    ret_i = Retriever(dataclasses.replace(cfg, backend="ivf"))
    state_i = RetrieverState(cb, IVFState(ivf, IVF_N_PROBE),
                             flat_s.rerank_codes, flat_s.rerank_mask)
    run_i, out["launches"]["ivf"] = serve("ivf", ret_i, state_i, relevance,
                                          build_assigns)
    rec_i = recall(ret_i, state_i, flat_s)
    print(f"ivf: tie-aware recall@{TOP_K} against the flat sweep "
          f"{rec_i:.3f} | hit@{TOP_K} {run_i.hit_rate:.3f}")
    probe = index_mod._probe(ivf.routing_centroids, qg.embeddings, qg.mask,
                             IVF_N_PROBE)
    pc, pm, pv, _ = index_mod._probed_pool(ivf, ivf.bucket_valid, probe)
    out["ivf_pool"] = pool_times(table, pc, pm, pv)
    del pc, pm, pv
    x = doc_vec.contiguous()
    cents = ivf.routing_centroids.contiguous()
    c2 = (cents * cents).sum(-1)
    out["ivf_assign"] = {
        "ms": _time_ms(torch, lambda: km.kmeans_assign_cuda(x, cents), 50),
        "plain_ms": _time_ms(torch, lambda: km.kmeans_assign_plain(x, cents),
                             20),
        "addmm_ms": _time_ms(torch, lambda: torch.addmm(
            c2, x, cents.t(), alpha=-2.0), 50),
        "bound": _gemm_bounds(N_DOCS * DIM * 4 + IVF_N_LIST * DIM * 4
                              + N_DOCS * 4, 2.0 * N_DOCS * IVF_N_LIST * DIM),
        "shape": f"{N_DOCS} x {DIM} against K={IVF_N_LIST}"}
    print(f"ivf phase {time.perf_counter() - t0:.1f}s")

    # -- 8c. HNSW over the first N_HNSW docs --------------------------------
    t0 = _phase(f"8c. hnsw over the first {N_HNSW} docs")
    h_cfg = HNSWConfig()
    for mod in kernel_mods.values():
        mod.launches = 0
    t1 = time.perf_counter()
    hn = graph_mod.build_hnsw(
        torch.Generator(device=dev).manual_seed(args.seed + 3),
        codes[:N_HNSW], mask[:N_HNSW], cb, h_cfg)
    torch.cuda.synchronize()
    hnsw_build_s = time.perf_counter() - t1
    ret_h = Retriever(dataclasses.replace(cfg, backend="hnsw"))
    state_h = RetrieverState(cb, HNSWState(hn, HNSW_EF),
                             flat_s.rerank_codes[:N_HNSW],
                             flat_s.rerank_mask[:N_HNSW])
    flat_sub = RetrieverState(cb, index_mod.build_flat(
        codes[:N_HNSW], mask[:N_HNSW], cb), flat_s.rerank_codes[:N_HNSW],
        flat_s.rerank_mask[:N_HNSW])
    stats = ret_h.build_stats(state_h)
    print(f"hnsw build {hnsw_build_s:.2f}s (m {h_cfg.m}, ef_construction "
          f"{h_cfg.ef_construction}, {h_cfg.levels} levels, host numpy) | "
          f"mean level-0 degree {stats['mean_degree_l0']:.2f}, entry level "
          f"{stats['entry_level']}")
    run_h, out["launches"]["hnsw"] = serve("hnsw", ret_h, state_h,
                                           relevance[:, :N_HNSW], 0)
    rec_h = recall(ret_h, state_h, flat_sub)
    # at IVF's scanned share of its corpus (an equal budget)
    ef_eq = int(round(share * N_HNSW))
    rec_h_eq = recall(ret_h, RetrieverState(
        cb, HNSWState(hn, ef_eq), state_h.rerank_codes,
        state_h.rerank_mask), flat_sub)
    print(f"hnsw: tie-aware recall@{TOP_K} against the flat sweep over the "
          f"same {N_HNSW} docs {rec_h:.3f} at ef_search {HNSW_EF} "
          f"({HNSW_EF / N_HNSW:.1%} scanned), {rec_h_eq:.3f} at ef_search "
          f"{ef_eq} ({share:.1%}, ivf's share) | hit@{TOP_K} "
          f"{run_h.hit_rate:.3f} (over those docs)")
    q_vec = index_mod.mean_pool(qg.embeddings, qg.mask)
    cand = graph_mod.hnsw_candidates(hn, q_vec, ef_search=HNSW_EF)[1]
    safe = cand.clamp(min=0).long()
    out["hnsw_pool"] = pool_times(table, hn.codes[safe], hn.mask[safe],
                                  cand >= 0)

    # the latency of one search (the facade's, rerank included): host wall
    # (median of 9) for each; device time where the search can be replayed
    # from a CUDA graph (ivf and flat whole; hnsw's beam, pool gather and
    # scan, after its descent, which syncs); the descent's syncs
    lat = {}
    h_name = f"hnsw {N_HNSW}"
    for name, ret, st in ((h_name, ret_h, state_h),
                          (f"ivf {N_DOCS}", ret_i, state_i),
                          (f"flat {N_HNSW}", flat_retriever, flat_sub),
                          (f"flat {N_DOCS}", flat_retriever, flat_s)):
        fn = (lambda ret=ret, st=st: ret.search(st, qg, k=TOP_K))
        ws = []
        for _ in range(9):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ws.append((time.perf_counter() - t1) * 1e3)
        lat[name] = {"host_wall_ms": float(np.median(ws))}
        if not name.startswith("hnsw"):
            lat[name]["device_ms"] = _time_ms(torch, fn, 3)
    syncs0 = graph_mod.SYNCS
    ret_h.search(state_h, qg, k=TOP_K)
    lat[h_name]["descent_syncs"] = graph_mod.SYNCS - syncs0
    cur = torch.full((MAX_BATCH,), hn.entry, dtype=torch.int64, device=dev)
    d0 = ((hn.doc_vecs[cur] - q_vec) ** 2).sum(-1)
    for lev in range(hn.neighbors.shape[0] - 1, 0, -1):
        cur, d0 = graph_mod._greedy_level(hn.doc_vecs, hn.neighbors[lev],
                                          q_vec, cur, d0)

    def beam_and_scan():
        _, c = graph_mod._beam_level0(hn.doc_vecs, hn.neighbors[0], q_vec,
                                      cur, d0, HNSW_EF)
        return graph_mod._score_candidates(hn, qg.embeddings, qg.mask, c,
                                           c >= 0, RERANK, None)

    lat[h_name]["beam_pool_scan_device_ms"] = _time_ms(
        torch, beam_and_scan, 3)
    lat[h_name]["beam_only_device_ms"] = _time_ms(
        torch, lambda: graph_mod._beam_level0(
            hn.doc_vecs, hn.neighbors[0], q_vec, cur, d0, HNSW_EF), 3)
    for name, v in lat.items():
        print(f"one search, {name}: {v}")
    print(json.dumps({"ann_latency_ms": lat}))
    out["latency"] = lat
    out.update(ivf_build_s=ivf_build_s, hnsw_build_s=hnsw_build_s,
               recall={"ivf": rec_i, "hnsw": rec_h,
                       f"hnsw ef {ef_eq}": rec_h_eq},
               hit={"ivf": run_i.hit_rate, "hnsw": run_h.hit_rate},
               ivf_cap=cap, ivf_share=share)
    out["states"] = {"ivf": (ret_i, state_i), "hnsw": (ret_h, state_h)}
    del run_i, run_h
    print(f"hnsw phase {time.perf_counter() - t0:.1f}s")

    # -- 8d. the routers live ---------------------------------------------
    t0 = _phase("8d. a live ANN index")
    rng = np.random.default_rng(args.seed + 4)
    add = Corpus(*(a[:N_ANN_ADD] for a in delta))
    # the served windows' launches, and the mutations' (add, delete and
    # compaction) under their own key; the checks between them launch
    # kernels too, and those are not counted
    live_launches = {n: 0 for n in kernel_mods}
    mut_launches = {n: 0 for n in kernel_mods}
    for name, ret, state, n0 in (("hnsw", ret_h, state_h, N_HNSW),
                                 ("ivf", ret_i, state_i, N_DOCS)):
        sess = LiveIndexSession(ret, state, ServeConfig(
            max_batch=MAX_BATCH, top_k=TOP_K), device=dev)
        sess.warm_shapes(*(a[0] for a in queries))
        for mod in kernel_mods.values():
            mod.launches = 0
        secs = {}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sess.add(add, doc_ids=np.arange(n0, n0 + N_ANN_ADD))
        torch.cuda.synchronize()
        secs["add"] = time.perf_counter() - t1
        dead = np.sort(rng.choice(n0 + N_ANN_ADD, N_ANN_DEAD, replace=False))
        t1 = time.perf_counter()
        sess.delete(dead)
        torch.cuda.synchronize()
        secs["delete"] = time.perf_counter() - t1
        # the served window: one batch per request; per search one
        # quantized_maxsim launch per segment (ivf: base + append; hnsw
        # grows its one segment) and one for the rerank
        for n_, mod in kernel_mods.items():
            mut_launches[n_] += mod.launches
            mod.launches = 0
        served = [sess.query(*(a[qi] for a in queries), timeout=120.0)
                  for qi in range(N_REQUESTS)]
        n_seg = len(ret.backend._segmented(sess.state).live)
        window = {n_: mod.launches for n_, mod in kernel_mods.items()}
        want = {"quantized_maxsim": N_REQUESTS * (n_seg + 1),
                "kmeans_assign": 0, "hamming_maxsim": 0, "maxsim": 0}
        assert window == want, (name, window, want)
        for n_, v in window.items():
            live_launches[n_] += v
        seen = set(int(x) for _, ids in served for x in ids if x >= 0)
        assert not seen & set(dead.tolist()), f"{name}: a deleted id served"
        cur_st = sess.state
        got = ret.search(cur_st, qg, k=TOP_K)
        want = ret.search(state_to(cur_st, "cpu"), cq, k=TOP_K)
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   atol=QMAXSIM_TOL, rtol=QMAXSIM_TOL)
        bad = topk_mismatches(got[1].cpu().numpy(), got[0].cpu().numpy(),
                              want[1].numpy(), want[0].numpy(), QMAXSIM_TOL)
        assert not bad, f"{name}: the live batch differs from the CPU {bad}"
        # the router's own top-10 (no rerank: at the rerank's cut-off,
        # equal ADC scores admit whichever tied docs come first)
        before = [ret.backend.search(cur_st, qq, k=TOP_K) for qq in qs_all]
        del cur_st
        for mod in kernel_mods.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sess.compact()
        torch.cuda.synchronize()
        secs["compact"] = time.perf_counter() - t1
        for n_, mod in kernel_mods.items():
            mut_launches[n_] += mod.launches
        after = [ret.backend.search(sess.state, qq, k=TOP_K)
                 for qq in qs_all]
        b_s, b_i, a_s, a_i = (np.concatenate([x[j].cpu().numpy() for x in xs])
                              for xs, j in ((before, 0), (before, 1),
                                            (after, 0), (after, 1)))
        kept = tie_aware_recall_at_k(a_s, a_i, b_s, TOP_K)
        same = float((a_i == b_i).mean())
        assert not set(a_i.ravel().tolist()) & set(dead.tolist())
        if name == "ivf":
            # the same centroids, so the same probed docs: the results stay
            # (ids may move only within ties, as the buckets re-form)
            np.testing.assert_allclose(a_s, b_s, atol=QMAXSIM_TOL,
                                       rtol=QMAXSIM_TOL)
            assert not topk_mismatches(a_i, a_s, b_i, b_s, QMAXSIM_TOL)
        else:
            # a new graph over the live docs: held to the results before
            assert kept >= 0.95, f"hnsw compaction kept {kept}"
        print(f"live {name}: add of {N_ANN_ADD} {secs['add']:.3f}s, delete "
              f"of {N_ANN_DEAD} {secs['delete']:.4f}s, compact "
              f"{secs['compact']:.3f}s | {N_REQUESTS} requests after the "
              f"delete on {n_seg} segment(s), launches {window}, no deleted "
              f"id served | one batch == CPU plain path "
              f"| after compaction: ids identical {same:.3f}, tie-aware "
              f"recall@{TOP_K} against the results before {kept:.3f} | "
              f"states {sorted(sess.state_signatures())}")
        out.setdefault("mutation_s", {})[name] = secs
        sess.close()
        del sess
    out["launches"]["live ann"] = live_launches
    out["launches"]["live ann mutations"] = mut_launches
    print(f"launches: served windows {live_launches}, mutations "
          f"{mut_launches}")
    print(json.dumps({"ann_mutation_s": out["mutation_s"]}))
    print(f"live ann phase {time.perf_counter() - t0:.1f}s")
    return out


def _encoder_flops(enc_cfg, s: int) -> float:
    """Matmul FLOPs one page (or query) of ``s`` positions executes in the
    encoder, as the reference computes it: the projections, the FFN, the
    full S x S scores and the PV product (no causal skipping) in every
    layer, and the patch and output projections."""
    bb = enc_cfg.backbone
    d, hd, ff = bb.d_model, bb.hd, bb.d_ff
    proj = 2 * s * (d * (bb.n_heads + 2 * bb.n_kv_heads) * hd
                    + bb.n_heads * hd * d + 3 * d * ff)
    attn = 2 * 2 * bb.n_heads * s * s * hd
    return (bb.n_layers * (proj + attn) + 2 * s * enc_cfg.d_patch * d
            + 2 * s * d * enc_cfg.proj_dim)


def _model_phase(args, torch, np, dev, smi, arch, gen_cfg, kernel_mods):
    """Phase 9: the ColPali encoder (a 2-layer cut on the card against the
    CPU, then 1024 pages at full width indexed and searched) and RAG over
    the fact corpus with three retrievers and the qwen2-1.5b generator.
    ``arch`` is the colpali-hpc config (HPCColPaliArch), ``gen_cfg`` the
    generator's LMConfig. Returns the launches by path and the readings."""
    import dataclasses
    from repro_torch import state_to
    from repro_torch.core import pruning, rag
    from repro_torch.data.synthetic import make_fact_corpus
    from repro_torch.models import colpali
    from repro_torch.models import transformer as T
    from repro_torch.parity import topk_mismatches
    from repro_torch.retrieval import Corpus, HPCConfig, Query, Retriever

    enc_cfg = arch.encoder
    bb = enc_cfg.backbone
    heads = bb.n_heads
    # left at PyTorch's default: the models' entry points clear it for
    # their own products (layers.float32_accumulation) and restore it
    caller_flag = torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction
    m_pages = enc_cfg.n_patches
    m_keep = pruning.keep_count(m_pages, arch.hpc.p)
    launches = {}

    def zero():
        for mod in kernel_mods.values():
            mod.launches = 0

    def counts():
        return {n: mod.launches for n, mod in kernel_mods.items()}

    # -- 9a. a 2-layer cut, card against CPU ------------------------------
    t0 = _phase(f"9a. encoder: a {ENC_CUT_LAYERS}-layer cut at full width "
                f"on the card against the CPU")
    cut = dataclasses.replace(enc_cfg, backbone=dataclasses.replace(
        bb, n_layers=ENC_CUT_LAYERS, activation_dtype="float32"))
    enc = colpali.init(cut, generator=torch.Generator(dev).manual_seed(
        args.seed + 90), device=dev)
    cpu = colpali.ColPaliEncoder(cut, device="cpu")
    cpu.load_state_dict(enc.state_dict())
    hg = torch.Generator().manual_seed(args.seed + 91)
    page = torch.randn((1, m_pages, enc_cfg.d_patch), generator=hg)
    pmask = torch.ones((1, m_pages), dtype=torch.bool)
    qtok = torch.randint(0, bb.vocab, (1, enc_cfg.query_len), generator=hg)
    qmask = torch.ones((1, enc_cfg.query_len), dtype=torch.bool)
    cut_err = {}
    for name, fn, inputs in (("page", "encode_doc", (page, pmask)),
                             ("query", "encode_query", (qtok, qmask))):
        e_dev, s_dev = getattr(enc, fn)(*(a.to(dev) for a in inputs))
        e_cpu, s_cpu = getattr(cpu, fn)(*inputs)
        e_err = float((e_dev.cpu() - e_cpu).abs().max())
        s_err = float((s_dev.cpu() - s_cpu).abs().max()) / heads
        cut_err[name] = {"emb_max_abs_err": e_err,
                         "salience_over_heads_max_abs_err": s_err}
        assert e_err <= CUT_EMB_TOL, f"9a {name} embeddings differ: {e_err}"
        assert s_err <= CUT_SAL_TOL, f"9a {name} salience differs: {s_err}"
        if name == "page":
            kept = [set(pruning.prune_topp(e, s, pmask, p=arch.hpc.p)
                        .indices[0].tolist())
                    for e, s in ((e_dev.cpu(), s_dev.cpu()), (e_cpu, s_cpu))]
            s64 = s_cpu[0].double()
            boundary = float(torch.sort(s64, descending=True).values[
                m_keep - 1])
            moved = kept[0] ^ kept[1]
            assert all(abs(float(s64[j]) - boundary) <= 2 * CUT_SAL_TOL
                       * heads for j in moved), \
                f"9a kept sets differ outside near-ties: {sorted(moved)}"
            cut_err["kept_patches"] = len(kept[0])
            cut_err["kept_set_near_tie_swaps"] = len(moved) // 2
    print(f"9a: {json.dumps(cut_err)} in {time.perf_counter() - t0:.1f}s")
    del enc, cpu
    torch.cuda.empty_cache()

    # -- 9b. 1024 pages at full width, indexed and searched -----------------
    t0 = _phase(f"9b. encoder at full width: {ENC_PAGES} pages of "
                f"{m_pages} patches, indexed and searched")
    # memory held by earlier phases, so the peak above it is this phase's
    base = torch.cuda.memory_allocated()
    enc = colpali.init(enc_cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 92), device=dev)
    mb = ENC_MICRO_BATCH
    mask = torch.ones((mb, m_pages), dtype=torch.bool, device=dev)
    warm = torch.randn((mb, m_pages, enc_cfg.d_patch), device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    enc.encode_doc(warm, mask)                    # cuBLAS set-up, untimed
    del warm
    emb = torch.empty((ENC_PAGES, m_pages, enc_cfg.proj_dim), device=dev)
    sal = torch.empty((ENC_PAGES, m_pages), device=dev)
    pgen = torch.Generator(dev).manual_seed(args.seed + 93)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for i in range(0, ENC_PAGES, mb):
        patches = torch.randn((mb, m_pages, enc_cfg.d_patch), device=dev,
                              generator=pgen)
        emb[i:i + mb], sal[i:i + mb] = enc.encode_doc(patches, mask)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t1
    enc_max = torch.cuda.max_memory_allocated()
    enc_peak = (enc_max - base) / 2**30
    norms = torch.linalg.vector_norm(emb, dim=-1)
    sal_sum = sal.sum(dim=-1)
    norm_dev = float((norms - 1.0).abs().max())
    sum_dev = float(((sal_sum - heads) / heads).abs().max())
    assert bool(torch.isfinite(emb).all()), "non-finite page embeddings"
    assert norm_dev <= NORM_TOL, f"page embeddings off unit norm: {norm_dev}"
    assert sum_dev <= SAL_SUM_TOL, f"page salience sums off {heads}: {sum_dev}"

    split = _encoder_split(torch, enc, mb, dev)

    flops = _encoder_flops(enc_cfg, m_pages)
    ref_flops = 2.0 * enc_cfg.param_count() * m_pages
    rate = flops * ENC_PAGES / encode_s
    encoder = {
        "pages": ENC_PAGES, "micro_batch": mb, "encode_s": encode_s,
        "pages_per_s": ENC_PAGES / encode_s,
        "max_memory_allocated_gib": enc_max / 2**30,
        "peak_memory_gib": enc_peak,
        "executed_matmul_tflop_per_page": flops / 1e12,
        "reference_model_tflop_per_page": ref_flops / 1e12,
        "executed_tflop_per_s": rate / 1e12,
        "share_of_bf16_peak": rate / PEAK_BF16_FLOPS,
        "bf16_bound_s": flops * ENC_PAGES / PEAK_BF16_FLOPS,
        "device_ms_per_micro_batch": split,
        "max_unit_norm_dev": norm_dev,
        "max_salience_sum_rel_dev": sum_dev,
        "saved_fraction_p60": pruning.compute_saved_fraction(m_pages,
                                                             arch.hpc.p)}
    print(f"encoded {ENC_PAGES} pages in {encode_s:.2f}s "
          f"({ENC_PAGES / encode_s:.1f} pages/s, {rate / 1e12:.1f} TFLOP/s "
          f"executed, {rate / PEAK_BF16_FLOPS:.3f} of the BF16 peak) | "
          f"peak memory {enc_peak:.2f} GiB (weights, micro-batch, outputs) "
          f"| {smi}")

    # the flat index over the encoder's embeddings and salience
    cfg = arch.hpc
    retriever = Retriever(cfg)
    zero()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = retriever.build(torch.Generator(dev).manual_seed(args.seed + 94),
                            Corpus(emb, torch.ones_like(sal, dtype=torch.bool),
                                   sal))
    torch.cuda.synchronize()
    encoder["build_s"] = time.perf_counter() - t1
    launches["encoder build"] = counts()
    storage = retriever.storage_bytes(state)
    assert storage["payload"] == ENC_PAGES * m_keep, storage
    assert launches["encoder build"]["kmeans_assign"] >= 1, \
        "the encoder's build never launched kmeans_assign"
    del emb, sal
    torch.cuda.empty_cache()

    # 64 queries with ragged token lengths, encoded and searched in batches
    qg = torch.Generator(dev).manual_seed(args.seed + 95)
    q_tok = torch.randint(0, bb.vocab, (ENC_QUERIES, enc_cfg.query_len),
                          generator=qg, device=dev)
    q_len = torch.randint(8, enc_cfg.query_len + 1, (ENC_QUERIES,),
                          generator=qg, device=dev)
    q_mask = torch.arange(enc_cfg.query_len, device=dev)[None] < q_len[:, None]
    q_emb, q_sal = enc.encode_query(q_tok, q_mask)
    assert bool(torch.isfinite(q_emb).all())
    q_sums = q_sal.sum(-1)
    del enc
    torch.cuda.empty_cache()
    zero()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = [retriever.search(state, Query(q_emb[i:i + MAX_BATCH],
                                             q_mask[i:i + MAX_BATCH],
                                             q_sal[i:i + MAX_BATCH]),
                                k=TOP_K)
               for i in range(0, ENC_QUERIES, MAX_BATCH)]
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t1
    launches["encoder search"] = counts()
    n_batches = len(results)
    assert launches["encoder search"]["quantized_maxsim"] == 2 * n_batches, \
        f"encoder searches: {launches['encoder search']}"
    cpu_state = state_to(state, "cpu")
    q0 = Query(*(a[:MAX_BATCH].cpu() for a in (q_emb, q_mask, q_sal)))
    cpu_s, cpu_i = retriever.search(cpu_state, q0, k=TOP_K)
    dev_s, dev_i = (a.cpu() for a in results[0])
    torch.testing.assert_close(dev_s, cpu_s, atol=QMAXSIM_TOL,
                               rtol=QMAXSIM_TOL)
    bad = topk_mismatches(dev_i.numpy(), dev_s.numpy(), cpu_i.numpy(),
                          cpu_s.numpy(), QMAXSIM_TOL)
    assert not bad, f"encoder search ids differ from the CPU at {bad}"
    encoder.update({
        "search_ms_per_batch": search_s / n_batches * 1e3,
        "query_salience_sum_range": [float(q_sums.min()),
                                     float(q_sums.max())],
        "first_batch_ids_differing_at_ties": int((dev_i != cpu_i).sum()),
        "launches": {p: launches[p] for p in ("encoder build",
                                              "encoder search")}})
    print(json.dumps({"encoder": encoder}))
    del state, cpu_state, results, q_emb, q_sal
    torch.cuda.empty_cache()
    print(f"encoder phase {time.perf_counter() - t0:.1f}s")

    # -- 9c. RAG at full width ----------------------------------------------
    t0 = _phase(f"9c. RAG over {RAG_DOCS} fact docs with the "
                f"{gen_cfg.name} generator")
    rag_base = torch.cuda.memory_allocated()
    corpus, vocab = make_fact_corpus(
        seed=args.seed + 96, n_docs=RAG_DOCS, n_facts_vocab=RAG_FACTS,
        facts_per_doc=RAG_FPD, dim=enc_cfg.proj_dim, n_patches=m_pages,
        n_queries=RAG_QUERIES, seq_len=RAG_SEQ, device=dev)
    gen = T.init(gen_cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 97), device=dev)
    docs = Corpus(corpus.doc_patches, corpus.doc_mask, corpus.doc_salience)
    resident = (torch.cuda.memory_allocated() - rag_base) / 2**30
    print(f"generator weights and fact corpus: {resident:.2f} GiB")
    rows = {}
    for name, knobs in RAG_RETRIEVERS:
        rcfg = rag.RAGConfig(retriever=HPCConfig(**knobs),
                             top_k_docs=RAG_TOP_K_DOCS, facts_per_doc=RAG_FPD,
                             fact0=vocab["fact0"], max_answer=RAG_MAX_ANSWER)
        r = Retriever(rcfg.retriever)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = r.build(torch.Generator(dev).manual_seed(args.seed + 98),
                        docs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        launches[f"rag {name} build"] = counts()
        # warm the generator's shapes and the search once, out of the reading
        rag.retrieve_and_generate(state, gen, corpus, rcfg,
                                  slice(0, RAG_QUERIES), device=dev)
        zero()
        run = rag.retrieve_and_generate(state, gen, corpus, rcfg, device=dev)
        launches[f"rag {name}"] = counts()
        m = rag.rag_metrics(run, corpus, rcfg, RAG_FACTS)
        row = {"retriever": name, "build_s": build_s,
               "retrieve_ms": m["retrieve_ms"],
               "generate_ms": m["generate_ms"],
               "latency_ms": m["latency_ms"],
               "launches": launches[f"rag {name}"],
               "build_launches": launches[f"rag {name} build"],
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2**30,
               "peak_memory_gib": (torch.cuda.max_memory_allocated()
                                   - base) / 2**30,
               "untrained_generator_quality": {
                   k: m[k] for k in ("rouge_l", "hallucination",
                                     "answer_acc")}}
        assert run.tokens.shape == (RAG_QUERIES, RAG_MAX_ANSWER)
        assert ((run.ids >= 0) & (run.ids < RAG_DOCS)).all()
        got = launches[f"rag {name}"]
        # the timed search of all RAG_QUERIES queries against the CPU plain
        # path: maxsim at 64 x 4 query patches over 1024-patch docs,
        # hamming_maxsim at 9 bits, quantized_maxsim's sweep and rerank
        row["search_vs_cpu"] = _check_rag_search(
            torch, r, state, corpus, run, RAG_TOLS[name])
        if name == "float_flat":
            assert got["maxsim"] >= 1, got
        elif name == "flat":
            assert got["quantized_maxsim"] == 2, got
            assert launches[f"rag {name} build"]["kmeans_assign"] >= 1
            row["greedy_check"] = _greedy_check(torch, T, gen, gen_cfg,
                                                run.prompt[:RAG_CHECK_PROMPTS])
            row["generate_split_ms"] = _generate_split(torch, T, gen,
                                                       run.prompt)
        elif name == "hamming":
            assert got["hamming_maxsim"] >= 1 and got["kmeans_assign"] == 1, \
                got
        rows[name] = row
        print(json.dumps({"rag": row}))
        del state, run
        torch.cuda.empty_cache()
    del gen, corpus, docs
    torch.cuda.empty_cache()
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            == caller_flag), "a model call left the bf16 flag changed"
    print(f"RAG phase {time.perf_counter() - t0:.1f}s | {smi} | bf16 "
          f"reduced-precision reduction as the caller left it: "
          f"{caller_flag}")
    return {"launches": launches, "encoder": encoder, "rag": rows,
            "cut": cut_err}


def _check_rag_search(torch, r, state, corpus, run, tol):
    """The search ``run`` timed (every query of the fact corpus, one batch)
    against the same search over a CPU copy of ``state`` (the plain path):
    the card's search again gives the run's ids, its scores lie within
    ``tol`` of the CPU's (``tol`` 0: equal) and its ids equal the CPU's
    outside near-ties. Returns the queries, the largest score error and
    how many ids differ at all (ties included)."""
    from repro_torch import state_to
    from repro_torch.parity import topk_mismatches
    from repro_torch.retrieval import Query
    q = Query(corpus.query_patches, corpus.query_mask, corpus.query_salience)
    dev_s, dev_i = (a.cpu() for a in r.search(state, q, k=RAG_TOP_K_DOCS))
    assert torch.equal(run.ids.cpu(), torch.clamp(dev_i, min=0)), \
        "the card's search does not give the timed run's ids"
    cpu_s, cpu_i = r.search(state_to(state, "cpu"),
                            Query(*(a.cpu() for a in q)), k=RAG_TOP_K_DOCS)
    if tol:
        torch.testing.assert_close(dev_s, cpu_s, atol=tol, rtol=tol)
    else:
        assert torch.equal(dev_s, cpu_s), "scores differ from the CPU's"
    bad = topk_mismatches(dev_i.numpy(), dev_s.numpy(), cpu_i.numpy(),
                          cpu_s.numpy(), tol)
    assert not bad, f"RAG ids differ from the CPU plain path at {bad}"
    return {"queries": int(dev_i.shape[0]),
            "max_abs_err": float((dev_s.double() - cpu_s.double()).abs()
                                 .max()),
            "ids_differing_at_ties": int((dev_i != cpu_i).sum())}


def _encoder_split(torch, enc, mb, dev):
    """Device time of one micro-batch of ``mb`` pages through encode_doc,
    and of its parts in one layer (each replayed from a CUDA graph):
    attention without and with the salience mass, the float32 score
    product of one query block alone, the FFN, and PyTorch's
    scaled_dot_product_attention on the same bf16 q, k, v (causal, GQA),
    which returns no probabilities and so no salience: the yardstick for a
    fused attention kernel."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    cfg = enc.cfg
    bb = cfg.backbone
    g = torch.Generator(dev).manual_seed(1)
    x = torch.randn((mb, cfg.n_patches, cfg.d_patch), device=dev, generator=g)
    mask = torch.ones((mb, cfg.n_patches), dtype=torch.bool, device=dev)
    blk = enc.backbone.blocks[0]
    h = blk.ln1((x.to(bb.adtype) @ enc.patch_proj.to(bb.adtype)))
    pos = torch.arange(cfg.n_patches, device=dev)[None].expand(mb, -1)
    dims = dict(n_heads=bb.n_heads, n_kv=bb.n_kv_heads, head_dim=bb.hd,
                theta=bb.rope_theta, q_chunk=bb.q_chunk)
    q, k, v = L._qkv(blk.attn, h, bb.n_heads, bb.n_kv_heads, bb.hd)
    g_ = bb.n_heads // bb.n_kv_heads
    qc = min(bb.q_chunk, cfg.n_patches)
    qf = q[:, :qc].reshape(mb, qc, bb.n_kv_heads, g_, bb.hd).permute(
        0, 2, 3, 1, 4).reshape(mb, bb.n_kv_heads, g_ * qc, bb.hd).float()
    kf = k.permute(0, 2, 3, 1).float().contiguous()
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    parts = {
        "encode_doc": lambda: enc.encode_doc(x, mask),
        "attention_one_layer": lambda: L.attention_kv(
            blk.attn, h, pos, want_salience=False, **dims),
        "attention_with_salience_one_layer": lambda: L.attention_kv(
            blk.attn, h, pos, want_salience=True, **dims),
        "f32_score_product_one_q_block": lambda: torch.matmul(qf, kf),
        "ffn_one_layer": lambda: blk.ffn(h),
        "sdpa_bf16_causal_gqa_one_layer": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
    }
    with torch.no_grad():
        out = {name: _time_ms(torch, fn, 2) for name, fn in parts.items()}
    print(f"encoder split, device ms per micro-batch of {mb} pages: "
          f"{json.dumps(out)}")
    return out


def _generate_split(torch, T, gen, prompt):
    """Host wall and device time of the generation's parts at the RAG
    batch: the prefill of the prompts, one decode step, and the float32
    logits product of one step alone."""
    plen = prompt.shape[1]
    logits, cache = T.prefill(gen, prompt, max_len=plen + RAG_MAX_ANSWER)
    tok = torch.argmax(logits, -1).to(torch.int32)
    h = torch.randn((prompt.shape[0], 1, gen.cfg.d_model), device=prompt.device,
                    generator=torch.Generator(prompt.device).manual_seed(2)
                    ).to(gen.cfg.adtype)
    return _split(torch, {
        "prefill": lambda: T.prefill(gen, prompt, max_len=plen
                                     + RAG_MAX_ANSWER),
        "decode_step": lambda: T.decode_step(gen, tok, cache, plen),
        "logits_one_step": lambda: gen.logits(h)})


def _greedy_check(torch, T, gen, gen_cfg, prompts):
    """Cached greedy decoding (prefill + decode steps) of ``prompts`` with
    float32 activations over ``gen``'s weights, against the argmax of a
    full, uncached forward over the growing sequence at every step; a
    differing token must be a near-tie of the uncached logits. Returns the
    count of steps checked and of near-ties."""
    import dataclasses
    from repro_torch.core import rag
    f32 = T.Transformer(dataclasses.replace(gen_cfg,
                                            activation_dtype="float32"),
                        device=prompts.device)
    f32.load_state_dict(gen.state_dict(), assign=True)
    plen = prompts.shape[1]
    toks = rag.greedy_generate(f32, prompts, RAG_MAX_ANSWER, plen)
    ties = 0
    with torch.no_grad():
        for i in range(RAG_MAX_ANSWER):
            seq = torch.cat([prompts, toks[:, :i].to(prompts.dtype)], dim=1)
            logits = f32.logits(f32(seq)[0][:, -1:])[:, 0]
            best = logits.max(dim=-1).values
            picked = logits.gather(1, toks[:, i:i + 1].long())[:, 0]
            differ = torch.argmax(logits, -1).to(torch.int32) != toks[:, i]
            gap = (best - picked).abs()
            tol = LOGIT_TIE_TOL * torch.clamp(best.abs(), min=1.0)
            assert bool((gap[differ] <= tol[differ]).all()), \
                f"cached greedy token {i} differs from the uncached argmax"
            ties += int(differ.sum())
    del f32
    return {"prompts": int(prompts.shape[0]), "steps": RAG_MAX_ANSWER,
            "near_ties": ties}


def _train_flops(enc_cfg, s: int, page: bool) -> float:
    """Matmul FLOPs one page (``page``) or query of ``s`` positions
    executes in a contrastive train step, counted as phase 9b counts the
    forward: each block's projections and FFN run forward, again in the
    block's recompute and twice over in the backward (4x); its S x S
    scores and PV products once more, in the query block's own recompute
    (5x); a page's patch projection forward and for its weight's grad
    (2x); the output projection 3x. A query's embedding is a gather."""
    bb = enc_cfg.backbone
    d, hd, ff = bb.d_model, bb.hd, bb.d_ff
    proj = 2 * s * (d * (bb.n_heads + 2 * bb.n_kv_heads) * hd
                    + bb.n_heads * hd * d + 3 * d * ff)
    attn = 2 * 2 * bb.n_heads * s * s * hd
    return (bb.n_layers * (4 * proj + 5 * attn)
            + (2 * 2 * s * enc_cfg.d_patch * d if page else 0)
            + 3 * 2 * s * d * enc_cfg.proj_dim)


def _adam_agreement(torch, got, want, sum_lr):
    """Params after Adam steps on the card against the CPU: Adam divides
    each grad entry by its own running scale, so an entry whose grad is
    within rounding of zero can step with the other sign (up to 2 x lr a
    step). Returns the share of entries further apart than
    TRAIN_PARAM_TOL, the largest |difference| and its bound, 2 x the
    summed lr; asserts at most 0.1% beyond the tolerance and none beyond
    the bound."""
    errs = torch.cat([(got[k].detach().cpu().double()
                       - want[k].double()).abs().reshape(-1) for k in want])
    out = {"share_beyond_tol": float((errs > TRAIN_PARAM_TOL).double()
                                     .mean()),
           "tol": TRAIN_PARAM_TOL, "max_abs_err": float(errs.max()),
           "bound": 2 * sum_lr}
    assert out["share_beyond_tol"] <= 1e-3, out
    assert out["max_abs_err"] <= out["bound"], out
    return out


def _train_cut(torch, dev, name, model, cpu, step, batches, ocfg,
               loss_scale=0.0):
    """Two train steps of ``model`` on the card and of its CPU copy on the
    same batches: loss and grad norm each step, params after both. The
    loss is held relative to the larger of itself and ``loss_scale``."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    p_d = T.params_of(model)
    p_c = T.params_of(cpu)
    s_d, s_c = opt.init(ocfg, p_d), opt.init(ocfg, p_c)
    rows, sum_lr = [], 0.0
    for b in batches:
        p_d, s_d, m_d = step(model, p_d, s_d,
                             {k: v.to(dev) for k, v in b.items()}, ocfg)
        p_c, s_c, m_c = step(cpu, p_c, s_c, b, ocfg)
        row = {k: [float(m_d[k]), float(m_c[k])]
               for k in ("loss", "grad_norm")}
        for k, tol, scale in (("loss", TRAIN_LOSS_TOL, loss_scale),
                              ("grad_norm", TRAIN_GNORM_TOL, 0.0)):
            d, c = row[k]
            assert abs(d - c) <= tol * max(abs(c), scale), \
                f"10a {name} {k}: {row}"
        sum_lr += float(m_c["lr"])
        rows.append(row)
    agree = _adam_agreement(torch, p_d, p_c, sum_lr)
    return {"steps": rows, "params": agree}, p_d, s_d


def _check_skip(torch, step_fn, params, state, batch):
    """A non-finite batch through the guarded step: skipped, and params,
    moments and step equal bit for bit to before."""
    from repro_torch.ckpt.checkpoint import leaves_with_paths
    from repro_torch.train.loop import guard_nonfinite
    p2, s2, m = guard_nonfinite(step_fn)(params, state, batch)
    assert int(m["skipped"]) == 1 and not bool(torch.isfinite(m["loss"]))
    same = [torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths((params, state)), leaves_with_paths((p2, s2)))]
    assert all(same), "10a: a skipped step changed the state"
    return len(same)


def _train_split(torch, loss, ocfg, params, state):
    """Host wall of one train step's parts at the trained state, each ended
    by a synchronize, and the peak memory allocated in each: the forward
    (the autograd graph kept), the backward with the checkpoints'
    recomputes, the AdamW update, and the non-finite guard's select (leaf
    by leaf, each result dropped)."""
    from repro_torch.models import layers as L
    from repro_torch.optim import optimizer as opt
    sync = torch.cuda.synchronize
    times, peaks = [], []

    def mark():
        sync()
        times.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()

    mark()
    with L.float32_accumulation():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        value, _ = loss(p)
        mark()
        grads = torch.autograd.grad(value, list(p.values()))
        mark()
    del p
    new_p, new_s, _ = opt.update(ocfg, dict(zip(params, grads)), state,
                                 params)
    del grads
    mark()
    ok = torch.isfinite(value.detach())
    for k in params:
        torch.where(ok, new_p[k], params[k])
        for new, old in ((new_s.m[k], state.m[k]), (new_s.v[k], state.v[k])):
            torch.where(ok, new, old)
    mark()
    parts = ("forward", "backward_with_recompute", "optimizer",
             "guard_select")
    return {**{f"{n}_s": times[i + 1] - times[i]
               for i, n in enumerate(parts)},
            **{f"{n}_peak_gib": peaks[i + 1] for i, n in enumerate(parts)}}


def _train_layer_split(torch, enc, pages, dev):
    """Device time (CUDA events, mean of 3 after a warm-up) of one layer's
    attention and FFN at the training shape, forward and backward: the
    attention with its query blocks checkpointed, so its backward includes
    their recompute, as in a train step; bf16 activations, float32
    accumulation."""
    from repro_torch.models import layers as L
    bb = enc.cfg.backbone
    s = enc.cfg.n_patches
    blk = enc.backbone.blocks[0]
    g = torch.Generator(dev).manual_seed(3)
    h = torch.randn((pages, s, bb.d_model), device=dev, generator=g).to(
        bb.adtype).requires_grad_(True)
    gy = torch.randn((pages, s, bb.d_model), device=dev, generator=g).to(
        bb.adtype)
    pos = torch.arange(s, device=dev)[None].expand(pages, -1)
    dims = dict(n_heads=bb.n_heads, n_kv=bb.n_kv_heads, head_dim=bb.hd,
                theta=bb.rope_theta, q_chunk=bb.q_chunk)
    parts = {
        "attention": lambda: L.attention_kv(blk.attn, h, pos, remat=True,
                                            **dims)[0],
        "ffn": lambda: blk.ffn(h)}
    out = {}
    with L.float32_accumulation():
        for name, fn in parts.items():
            for phase in ("forward", "forward_backward"):
                def run():
                    y = fn()
                    if phase == "forward_backward":
                        y.backward(gy)
                run()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    run()
                end.record()
                torch.cuda.synchronize()
                out[f"{name}_{phase}_ms"] = start.elapsed_time(end) / 3
    for p in blk.parameters():
        p.grad = None
    return out


def _train_cli_run(torch, np, argv, build, need_bytes, what):
    """``launch.train.main(argv)`` on the card with its checkpoint under
    ``build``, after checking the free space there. Returns the run and
    its readings: step seconds, peak memory, the final checkpoint."""
    import shutil
    from repro_torch.launch import train as train_cli
    free = shutil.disk_usage(build).free
    if free < need_bytes:
        raise RuntimeError(f"{what}: {free} bytes free under {build}, the "
                           f"checkpoint needs {need_bytes:.0f}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = train_cli.main(argv)
    torch.cuda.synchronize()
    secs = [h["seconds"] for h in res["history"]]
    losses = [h["loss"] for h in res["history"]]
    assert all(np.isfinite(losses)), f"{what}: losses {losses}"
    peak = torch.cuda.max_memory_allocated()
    return res, {
        "step_s": secs, "first_step_s": secs[0],
        "median_step_s_after_first": float(np.median(secs[1:])),
        "losses": losses,
        "max_memory_allocated_gib": peak / 2**30,
        "peak_memory_gib": (peak - base) / 2**30,
        "held_before_gib": base / 2**30,
        "stragglers": res["stats"]["stragglers"],
        "skipped": res["stats"]["skipped"],
        "pipeline": res["pipeline"],
        "checkpoint_bytes": res["checkpoint"]["bytes"],
        "checkpoint_save_s": res["checkpoint"]["seconds"],
        "free_bytes_before": free}


def _train_phase(args, torch, np, dev, smi, arch, lm_spec, kernel_mods):
    """Phase 10: training on the card. (a) 2-layer full-width cuts of the
    LM and the encoder, two train steps each against a CPU copy, and a
    non-finite batch skipped; (b) ColPali's contrastive step at 64 pages
    through the training CLI, its checkpoint restored bit for bit; (c)
    the qwen2-1.5b LM through the CLI; (d) rag_bench's generator trained
    300 steps and scored through three retrievers and a single-vector
    one. ``arch`` is the colpali-hpc config (HPCColPaliArch), ``lm_spec``
    the qwen2-1.5b ArchSpec. Returns the kernels' launches by path and the
    readings."""
    import dataclasses
    import shutil
    from repro_torch import convert
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core import late_interaction as li
    from repro_torch.core import rag
    from repro_torch.data.synthetic import make_fact_corpus, make_lm_batch
    from repro_torch.launch.train import colpali_batch
    from repro_torch.models import colpali
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    from repro_torch.retrieval import Corpus, HPCConfig, Retriever

    enc_cfg = arch.encoder
    lm_cfg = lm_spec.config
    launches, out = {}, {}
    caller_flag = torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction

    def zero():
        for mod in kernel_mods.values():
            mod.launches = 0

    def counts():
        return {n: mod.launches for n, mod in kernel_mods.items()}

    # -- 10a. 2-layer full-width cuts, card against CPU ---------------------
    t0 = _phase(f"10a. train steps of {TRAIN_CUT_LAYERS}-layer full-width "
                f"cuts (float32) on the card against the CPU")
    ocfg = opt.AdamWConfig(lr=TRAIN_CUT_LR, warmup_steps=1,
                           total_steps=TRAIN_CUT_STEPS)
    lm_cut = dataclasses.replace(lm_cfg, n_layers=TRAIN_CUT_LAYERS,
                                 activation_dtype="float32")
    enc_cut = dataclasses.replace(enc_cfg, backbone=dataclasses.replace(
        enc_cfg.backbone, n_layers=TRAIN_CUT_LAYERS,
        activation_dtype="float32"))
    hg = torch.Generator().manual_seed(args.seed + 100)
    zero()
    cut = {}
    lm = T.init(lm_cut, generator=torch.Generator(dev).manual_seed(
        args.seed + 101), device=dev)
    lm_cpu = T.Transformer(lm_cut, device="cpu")
    lm_cpu.load_state_dict(lm.state_dict())
    cut["lm"] = _train_cut(
        torch, dev, "lm", lm, lm_cpu, T.train_step,
        [make_lm_batch(hg, lm_cut.vocab, *TRAIN_CUT_LM_BATCH)
         for _ in range(TRAIN_CUT_STEPS)], ocfg)[0]
    del lm, lm_cpu
    enc = colpali.init(enc_cut, generator=torch.Generator(dev).manual_seed(
        args.seed + 102), device=dev)
    enc_cpu = colpali.ColPaliEncoder(enc_cut, device="cpu")
    enc_cpu.load_state_dict(enc.state_dict())
    cut["colpali"], p_d, s_d = _train_cut(
        torch, dev, "colpali", enc, enc_cpu, colpali.train_step,
        [colpali_batch(hg, enc_cut, TRAIN_CUT_PAGES)
         for _ in range(TRAIN_CUT_STEPS)], ocfg,
        # the contrastive loss is a difference of scores of up to
        # query_len / temperature (unit-norm embeddings), 1600 here
        enc_cut.query_len / enc_cut.temperature)
    del enc_cpu
    bad = {k: v.to(dev) for k, v in colpali_batch(
        hg, enc_cut, TRAIN_CUT_PAGES).items()}
    bad["doc_patches"][1] = float("nan")
    cut["nan_batch_leaves_unchanged"] = _check_skip(
        torch, lambda p, s, b: colpali.train_step(enc, p, s, b, ocfg),
        p_d, s_d, bad)
    launches["train cuts"] = counts()
    del enc, p_d, s_d, bad
    torch.cuda.empty_cache()
    cut["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train_cuts": cut, "smi": smi}))

    build = ROOT / "build"
    build.mkdir(exist_ok=True)

    # -- 10b. ColPali contrastive training at full width ---------------------
    t0 = _phase(f"10b. ColPali contrastive training at full width: "
                f"{TRAIN_PAGES} pages of {enc_cfg.n_patches} patches, "
                f"{TRAIN_STEPS} steps, through launch.train")
    ckpt_dir = build / "train_ckpt_colpali"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_params = enc_cfg.param_count()
    zero()
    res, cp = _train_cli_run(
        torch, np, ["--arch", "colpali-hpc", "--batch", str(TRAIN_PAGES),
                    "--steps", str(TRAIN_STEPS), "--ckpt-every", "0",
                    "--ckpt-dir", str(ckpt_dir),
                    "--seed", str(args.seed + 103)],
        build, 12 * n_params * 1.01, "10b")
    launches["colpali train"] = counts()
    flops = TRAIN_PAGES * (_train_flops(enc_cfg, enc_cfg.n_patches, True)
                           + _train_flops(enc_cfg, enc_cfg.query_len, False))
    med = cp["median_step_s_after_first"]
    cp.update({
        "pages": TRAIN_PAGES, "params": n_params,
        "pages_per_s": TRAIN_PAGES / med,
        "executed_matmul_tflop_per_step": flops / 1e12,
        "executed_tflop_per_s": flops / med / 1e12,
        "share_of_bf16_peak": flops / med / PEAK_BF16_FLOPS,
        "acc": [h["acc"] for h in res["history"]]})
    enc = res.pop("model")
    sg = torch.Generator().manual_seed(args.seed + 109)
    sb = {k: v.to(dev) for k, v in colpali_batch(sg, enc_cfg,
                                                 TRAIN_PAGES).items()}
    cp["split_s"] = _train_split(
        torch, lambda p: colpali.contrastive_loss(enc, p, sb),
        opt.AdamWConfig(), res["params"], res["opt_state"])
    del sb
    cp["one_layer_ms"] = _train_layer_split(torch, enc, TRAIN_PAGES, dev)
    del enc
    torch.cuda.empty_cache()
    # restore the final checkpoint into a fresh encoder and optimizer state
    fresh = colpali.ColPaliEncoder(enc_cfg, device=dev)
    like = T.params_of(fresh)
    fresh_state = opt.init(opt.AdamWConfig(), like)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tree = ck.restore(res["checkpoint"]["path"],
                      convert.train_template(like, fresh_state))
    p_r, s_r = convert.train_state_from_tree(tree, like)
    T.load_params(fresh, p_r)
    torch.cuda.synchronize()
    cp["restore_s"] = time.perf_counter() - t1
    del tree, fresh_state
    own = dict(fresh.named_parameters())
    same = [torch.equal(own[k], res["params"][k]) for k in like]
    same += [torch.equal(a, b) for (_, a), (_, b) in zip(
        ck.leaves_with_paths(s_r), ck.leaves_with_paths(res["opt_state"]))]
    assert all(same) and len(same) == 3 * len(like) + 1, \
        "10b: the restored state differs from the run's"
    cp["restored_leaves_equal"] = len(same)
    del fresh, like, p_r, s_r, own, res
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()
    cp["seconds"] = time.perf_counter() - t0
    out["colpali_train"] = cp
    print(json.dumps({"colpali_train": cp, "smi": smi}))

    # -- 10c. the LM at full width -------------------------------------------
    t0 = _phase(f"10c. {lm_cfg.name} training at full width: batch "
                f"{LM_TRAIN_BATCH} x seq {LM_TRAIN_SEQ}, {LM_TRAIN_STEPS} "
                f"steps, through PrefetchPipeline and train.loop.run")
    ckpt_dir = build / "train_ckpt_lm"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    zero()
    res, lmr = _train_cli_run(
        torch, np, ["--arch", lm_spec.arch_id, "--batch",
                    str(LM_TRAIN_BATCH),
                    "--seq", str(LM_TRAIN_SEQ), "--steps",
                    str(LM_TRAIN_STEPS), "--ckpt-every", "0", "--ckpt-dir",
                    str(ckpt_dir), "--seed", str(args.seed + 104)],
        build, 12 * lm_cfg.param_count() * 1.01, "10c")
    launches["lm train"] = counts()
    assert lmr["losses"][-1] < lmr["losses"][0], \
        f"10c: the loss did not fall: {lmr['losses']}"
    lmr["tokens_per_s"] = (LM_TRAIN_BATCH * LM_TRAIN_SEQ
                           / lmr["median_step_s_after_first"])
    lmr["params"] = lm_cfg.param_count()
    lb = {k: v.to(dev) for k, v in make_lm_batch(
        torch.Generator().manual_seed(args.seed + 110), lm_cfg.vocab,
        LM_TRAIN_BATCH, LM_TRAIN_SEQ).items()}
    model = res.pop("model")
    lmr["split_s"] = _train_split(
        torch, lambda p: T.loss_fn(model, p, lb["tokens"], lb["targets"]),
        opt.AdamWConfig(), res["params"], res["opt_state"])
    del res, model, lb
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()
    lmr["seconds"] = time.perf_counter() - t0
    out["lm_train"] = lmr
    print(json.dumps({"lm_train": lmr, "smi": smi}))

    # -- 10d. a trained RAG generator ---------------------------------------
    t0 = _phase(f"10d. RAG with a trained generator: rag_bench's set-up, "
                f"{RAG_GEN_STEPS} steps")
    corpus, vocab = make_fact_corpus(
        seed=args.seed + 105, n_docs=RAG_GEN_DOCS,
        n_facts_vocab=RAG_GEN_FACTS, facts_per_doc=RAG_GEN_FPD,
        dim=RAG_GEN_DIM, n_patches=RAG_GEN_PATCHES,
        n_queries=RAG_GEN_QUERIES, seq_len=16, device=dev)
    gen_cfg = T.LMConfig(vocab=vocab["size"], **RAG_GEN_LM)
    rcfg = rag.RAGConfig(top_k_docs=2, facts_per_doc=RAG_GEN_FPD,
                         fact0=vocab["fact0"], max_answer=RAG_GEN_FPD)
    gen = T.init(gen_cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 106), device=dev)
    gocfg = opt.AdamWConfig(**RAG_GEN_OPT, total_steps=RAG_GEN_STEPS)
    p = T.params_of(gen)
    s = opt.init(gocfg, p)
    bgen = torch.Generator(dev).manual_seed(args.seed + 107)
    losses = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(RAG_GEN_STEPS):
        batch = rag.make_rag_train_batch(bgen, corpus, vocab, rcfg,
                                         batch=RAG_GEN_BATCH,
                                         seq_len=RAG_GEN_SEQ,
                                         n_docs=RAG_GEN_DOCS)
        p, s, m = T.train_step(gen, p, s, batch, gocfg)
        if i % 100 == 0 or i == RAG_GEN_STEPS - 1:
            losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    T.load_params(gen, p)
    assert losses[-1] < losses[0] / 2, f"10d: generator losses {losses}"
    rows = {}
    for name, knobs in RAG_RETRIEVERS:
        rc = dataclasses.replace(rcfg, retriever=HPCConfig(**knobs))
        r = Retriever(rc.retriever)
        zero()
        state = r.build(torch.Generator(dev).manual_seed(args.seed + 108),
                        Corpus(corpus.doc_patches, corpus.doc_mask,
                               corpus.doc_salience))
        run = rag.retrieve_and_generate(state, gen, corpus, rc, device=dev)
        launches[f"rag trained {name}"] = counts()
        m = rag.rag_metrics(run, corpus, rc, RAG_GEN_FACTS)
        rows[name] = {k: m[k] for k in ("rouge_l", "hallucination",
                                        "answer_acc", "retrieve_ms",
                                        "generate_ms")}
        rows[name]["search_vs_cpu"] = _check_rag_search(
            torch, r, state, corpus, run, RAG_TOLS[name])
        got = rows[name]["launches"] = launches[f"rag trained {name}"]
        # the build's quantizer and the search's kernels ran
        assert {"float_flat": got["maxsim"] >= 1,
                "flat": got["quantized_maxsim"] == 2
                and got["kmeans_assign"] >= 1,
                "hamming": got["hamming_maxsim"] >= 1
                and got["kmeans_assign"] >= 2}[name], (name, got)
        del state, run
    # the single-vector retriever (rag_bench's DistilCol row)
    scores = li.single_vector_score(corpus.query_patches, corpus.query_mask,
                                    corpus.doc_patches, corpus.doc_mask)
    # top_k_docs <= RAG_DOCS, the corpus the scores cover
    weak = torch.topk(scores, rcfg.top_k_docs, dim=-1).indices  # noqa: TORCH04
    plen = rcfg.top_k_docs * (RAG_GEN_FPD + 1) + corpus.query_tokens.shape[1]
    prompt = rag.build_prompt(corpus.doc_tokens[weak], corpus.query_tokens,
                              rcfg, plen)
    toks = rag.greedy_generate(gen, prompt, RAG_GEN_FPD, plen).cpu().numpy()
    ctx = [set(r.ravel().tolist())
           for r in corpus.doc_facts.cpu().numpy()[weak.cpu().numpy()]]
    gsets = rag.extract_facts(toks, vocab["fact0"], RAG_GEN_FACTS)
    gold = corpus.gold_facts.cpu().numpy()
    rows["single_vector"] = {
        "rouge_l": float(np.mean([rag.rouge_l(sorted(g), sorted(set(
            r.tolist()))) for g, r in zip(gsets, gold)])),
        "hallucination": rag.hallucination_rate(gsets, ctx),
        "answer_acc": float(np.mean([set(r.tolist()) <= g
                                     for g, r in zip(gsets, gold)]))}
    for name, row in rows.items():
        for k in ("rouge_l", "hallucination", "answer_acc"):
            assert 0.0 <= row[k] <= 1.0, (name, row)
    assert rows["float_flat"]["rouge_l"] >= RAG_TRAINED_ROUGE_FLOOR, rows
    out["rag_trained"] = {"train_s": train_s, "losses": losses,
                          "steps": RAG_GEN_STEPS, "rows": rows,
                          "seconds": time.perf_counter() - t0}
    del gen, p, s, corpus
    torch.cuda.empty_cache()
    print(json.dumps({"rag_trained": out["rag_trained"], "smi": smi}))
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            == caller_flag), "a train step left the bf16 flag changed"
    out["cuts"] = cut
    return {"launches": launches, **out}


def _set_moe(model, **changes):
    """Run ``model`` under its config with ``changes`` (the MoE capacity
    factor or expert blocks): the weights stay as they are."""
    import dataclasses
    cfg = dataclasses.replace(model.cfg, **changes)
    model.cfg = cfg
    for blk in model.blocks:
        blk.cfg = cfg


def _record_moe(model):
    """Hooks on every MoE layer of ``model`` that keep each call's (module,
    input tokens, capacity factor); returns (records, handles)."""
    rec = []

    def hook(mod, args, _out):
        rec.append((mod, args[0].detach(), args[1]))
    return rec, [blk.moe.register_forward_hook(hook) for blk in model.blocks]


def _kept_table(torch, r, n_experts):
    """A routing's kept assignments as a (T, E) bool table on the host."""
    t = r.expert.shape[0]
    kept = torch.zeros((t, n_experts), dtype=torch.bool)
    keep = r.keep.cpu()
    kept[r.sorted_token.cpu()[keep], r.sorted_expert.cpu()[keep]] = True
    return kept


def _routing_diff(torch, L, rec_d, rec_c):
    """Each MoE call on the card against the same call on the CPU: the
    chosen experts and the kept (token, expert) set of every token. A token
    whose chosen experts differ must be a near-tie of the CPU router (its
    k-th and (k+1)-th probs within MOE_TIE_TOL); a token whose kept set
    alone differs is allowed only in a call with such a flip (an expert's
    capacity moved). Returns the count of calls and tokens compared and
    the differing (call, token) pairs."""
    flips, shifts, n_tok = [], [], 0
    assert len(rec_d) == len(rec_c), (len(rec_d), len(rec_c))
    for i, ((m_d, x_d, cf), (m_c, x_c, cf_c)) in enumerate(zip(rec_d,
                                                               rec_c)):
        assert cf == cf_c
        r_d = L.moe_route(m_d, x_d, m_d.top_k, cf)
        r_c = L.moe_route(m_c, x_c, m_c.top_k, cf)
        k = m_c.top_k
        e = r_c.probs.shape[1]
        chose_d = torch.sort(r_d.expert.cpu(), -1).values
        chose_c = torch.sort(r_c.expert, -1).values
        flip = (chose_d != chose_c).any(-1)
        shift = (_kept_table(torch, r_d, e)
                 != _kept_table(torch, r_c, e)).any(-1) & ~flip
        top = torch.topk(r_c.probs, min(k + 1, e),  # noqa: TORCH04 (<= e)
                         dim=-1).values
        margin = (top[:, k - 1] - top[:, k] if k < e
                  else torch.full_like(top[:, 0], float("inf")))
        for tok in torch.nonzero(flip).flatten().tolist():
            assert float(margin[tok]) < MOE_TIE_TOL, \
                f"MoE call {i} token {tok}: experts differ, margin " \
                f"{float(margin[tok])}"
            flips.append((i, tok, float(margin[tok])))
        assert not shift.any() or flip.any(), \
            f"MoE call {i}: kept sets differ with no near-tie flip"
        shifts += [(i, t) for t in torch.nonzero(shift).flatten().tolist()]
        n_tok += x_c.shape[0]
    return {"calls": len(rec_c), "tokens": n_tok,
            "near_tie_flips": flips, "capacity_shifts": shifts}


def _moe_logit_check(torch, got, want, skip_rows):
    """float32 logits on the card against the CPU's: atol = rtol =
    MOE_LOGIT_TOL, outside rows whose routing differed at a near-tie.
    Returns the largest |difference|."""
    keep = [r for r in range(want.shape[0]) if r not in skip_rows]
    g, w = got.cpu()[keep], want[keep]
    err = (g - w).abs()
    assert bool((err <= MOE_LOGIT_TOL * (1 + w.abs())).all()), \
        f"11a logits differ: {float(err.max())}"
    return float(err.max())


def _no_drop_check(torch, got, want):
    """bf16 logits (prefill and decode steps, rows stacked) against the
    no-drop forward's: relative L2 within NO_DROP_RMS_TOL and every entry
    within NO_DROP_STEPS bf16 steps of the largest |logit|."""
    got, want = got.double().cpu(), want.double().cpu()
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    steps = float((got - want).abs().max()
                  / (2.0 ** -8 * want.abs().max()))
    same_argmax = float((got.argmax(-1) == want.argmax(-1)).double().mean())
    assert rel <= NO_DROP_RMS_TOL and steps <= NO_DROP_STEPS, (rel, steps)
    return {"rel_l2": rel, "max_err_bf16_steps": steps,
            "argmax_agree": same_argmax}


def _moe_flops(cfg, n_tok, seq, experts_slots, last_logits):
    """Matmul FLOPs a prefill of ``n_tok`` tokens (sequences of ``seq``)
    executes: per layer the projections, the plain attention's score and
    PV products over every key of a query block's window (or of the whole
    sequence in a global layer), the router, the experts over their
    ``experts_slots[l]`` slots (empty slots included) and the shared
    expert; then the last positions' logits."""
    d, hd = cfg.d_model, cfg.hd
    total = 0.0
    for layer, chunked in enumerate(cfg.layer_is_chunked()):
        keys = cfg.attn_chunk if chunked and 0 < cfg.attn_chunk < seq \
            else seq
        total += 2 * n_tok * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                              + cfg.n_heads * hd * d)
        total += 4 * cfg.n_heads * hd * n_tok * keys
        total += 2 * n_tok * d * cfg.n_experts
        total += 6 * experts_slots[layer] * d * cfg.moe_d_ff
        total += 6 * n_tok * d * cfg.moe_d_ff * cfg.n_shared_experts
    return total + 2 * last_logits * d * cfg.vocab


def _moe_split(torch, L, moe, x, cf):
    """Device time of one MoE layer's parts on tokens x (T, D), each
    replayed from a CUDA graph: router + top-k + sort (``moe_route``),
    the dispatch (slot table and gather), the expert products (the
    weights cast to x's dtype in them, as on the path) and the combine;
    and the whole layer."""
    t, d = x.shape
    e = moe.router.shape[1]
    r = L.moe_route(moe, x, moe.top_k, cf)
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    slots = L.moe_slots(r, t)
    xg = x_pad[slots].view(e, r.capacity, d)
    y = L.moe_experts(xg, moe.w_gate, moe.w_up, moe.w_down)

    def combine():
        rows = torch.sort(torch.argsort(r.order).view(t, moe.top_k),
                          dim=-1).values
        return L.moe_combine(y.view(e * r.capacity, d),
                             r.gate.reshape(-1)[r.order], r, rows, 0, e)

    parts = {
        "router_topk_sort": lambda: L.moe_route(moe, x, moe.top_k, cf),
        "dispatch_gather": lambda: x_pad[L.moe_slots(r, t)].view(
            e, r.capacity, d),
        "expert_products": lambda: L.moe_experts(xg, moe.w_gate, moe.w_up,
                                                 moe.w_down),
        "combine": combine,
        "whole_layer": lambda: moe(x, cf, 1)}
    with torch.no_grad(), L.float32_accumulation():
        out = {name: _time_ms(torch, fn, 3) for name, fn in parts.items()}
    out.update({"tokens": t, "capacity": r.capacity,
                "slots": e * r.capacity})
    return out


def _moe_serve(torch, np, T, L, model, prompt, max_len, n_decode, smi,
               what):
    """Prefill ``prompt`` at the config's capacity factor and decode
    ``n_decode`` greedy steps: the prefill's host wall (after a short
    warm-up prefill), tokens/s, peak memory above what was held, each MoE
    layer's dropped share, the decode steps' host walls, one decode
    step's device time (CUDA-graph replay), the MoE split at the prefill's
    and a decode step's shapes, and the executed matmul FLOP rate against
    the dense BF16 peak."""
    cfg = model.cfg
    b, s = prompt.shape
    T.prefill(model, prompt[:, :min(s, 256)], max_len=max_len)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec, hooks = _record_moe(model)
    t1 = time.perf_counter()
    logits, cache = T.prefill(model, prompt, max_len=max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated()
    dropped, slots = [], []
    for mod, x, cf in rec:
        r = L.moe_route(mod, x, mod.top_k, cf)
        dropped.append(float((~r.keep).double().mean()))
        slots.append(cfg.n_experts * r.capacity)
    flops = _moe_flops(cfg, b * s, s, slots, b)
    split_prefill = _moe_split(torch, L, model.blocks[0].moe, rec[0][1],
                               cfg.capacity_factor)
    del rec
    walls, tok = [], torch.argmax(logits, -1).to(torch.int32)
    for i in range(n_decode):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = T.decode_step(model, tok, cache, s + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        tok = torch.argmax(logits, -1).to(torch.int32)
    decode_dev = _time_ms(torch, lambda: T.decode_step(
        model, tok, cache, s + n_decode - 1), 3)
    h = L.rms_norm(model.embed_tokens(tok[:, None]),
                   model.blocks[0].ln2.weight, cfg.norm_eps)[:, 0]
    split_decode = _moe_split(torch, L, model.blocks[0].moe, h, 2.0)
    del cache, logits
    torch.cuda.empty_cache()
    out = {"prompt": [b, s], "prefill_s": prefill_s,
           "prefill_tokens_per_s": b * s / prefill_s,
           "prefill_executed_tflop": flops / 1e12,
           "prefill_tflop_per_s": flops / prefill_s / 1e12,
           "prefill_share_of_bf16_peak": flops / prefill_s / PEAK_BF16_FLOPS,
           "prefill_peak_memory_gib": (peak - base) / 2**30,
           "max_memory_allocated_gib": peak / 2**30,
           "dropped_share_by_layer": dropped,
           "capacity_factor": cfg.capacity_factor,
           "decode_step_host_wall_ms": walls,
           "decode_step_host_wall_median_ms": float(np.median(walls)),
           "decode_step_device_ms": decode_dev,
           "moe_split_prefill_ms": split_prefill,
           "moe_split_decode_ms": split_decode}
    print(json.dumps({what: out, "smi": smi}))
    return out


def _no_drop_run(torch, T, model, prompt, max_len, n_decode, filler, gen):
    """Prefill and ``n_decode`` greedy decode steps at the model's current
    (no-drop) capacity, then one teacher-forced forward over the prompt,
    the decoded tokens and ``filler`` more (so the query blocks keep their
    size; positions after the last compared one cannot reach it: causal
    attention, and no token drops). Returns (the prefill's and steps'
    logits, the forward's at the same positions), rows ordered (step,
    batch row)."""
    b, s = prompt.shape
    logits, cache = T.prefill(model, prompt, max_len=max_len)
    got, toks = [logits], []
    for i in range(n_decode):
        nxt = torch.argmax(logits, -1).to(torch.int32)
        toks.append(nxt)
        logits, cache = T.decode_step(model, nxt, cache, s + i)
        got.append(logits)
    del cache
    extra = torch.randint(0, model.cfg.vocab, (b, filler), generator=gen,
                          device=prompt.device, dtype=prompt.dtype)
    seq = torch.cat([prompt, torch.stack(toks, 1).to(prompt.dtype), extra],
                    1)
    with torch.no_grad():
        h, _, _ = model(seq)
        want = model.logits(h[:, s - 1:s + n_decode])      # (B, n+1, V)
    del h
    return (torch.stack(got, 1).reshape(-1, want.shape[-1]),
            want.reshape(-1, want.shape[-1]))


def _chunk_attn_check(torch, L, blk, cfg, h):
    """One chunked layer's attention at S = h.shape[1], float32, against
    an independent form on the card: per head one (S, S) softmax with the
    explicit iRoPE mask (j <= i, same window of ``attn_chunk``). Returns
    the largest |difference| over the largest |output|."""
    import math
    s = h.shape[1]
    hf = h.float()
    pos = torch.arange(s, device=h.device)[None]
    with torch.no_grad():
        got, _, _, _ = L.attention_kv(
            blk.attn, hf, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, theta=cfg.rope_theta, chunk=cfg.attn_chunk,
            q_chunk=cfg.q_chunk)
        a = blk.attn
        q = L.apply_rope((hf @ a.wq.float()).view(1, s, cfg.n_heads, cfg.hd),
                         pos, cfg.rope_theta)
        k = L.apply_rope((hf @ a.wk.float()).view(1, s, cfg.n_kv_heads,
                                                  cfg.hd), pos,
                         cfg.rope_theta)
        v = (hf @ a.wv.float()).view(1, s, cfg.n_kv_heads, cfg.hd)
        i = torch.arange(s, device=h.device)
        mask = (i[None] <= i[:, None]) & (i[None] // cfg.attn_chunk
                                          == i[:, None] // cfg.attn_chunk)
        g = cfg.n_heads // cfg.n_kv_heads
        outs = []
        for head in range(cfg.n_heads):
            sc = (q[0, :, head] @ k[0, :, head // g].t()) / math.sqrt(cfg.hd)
            sc.masked_fill_(~mask, float("-inf"))
            outs.append(torch.softmax(sc, -1) @ v[0, :, head // g])
            del sc
        want = torch.stack(outs, 1).reshape(1, s, -1) @ a.wo.float()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= CHUNK_ATTN_TOL, f"11b chunked attention differs: {err}"
    return err


def _moe_train_int8(torch, dev, name, model, cpu, batches, ocfg):
    """Two int8-moment train steps: the first from the same weights on
    both devices (held as 10a holds its cuts); the second on the card
    from the CPU's state after the first, copied over. The reference's
    int8 codec rounds a second moment below half a code to 0, so an entry
    with a near-zero grad then steps by lr x m / (sqrt(v) + eps) with
    sqrt(v) near eps and follows its grad's rounding (ROADMAP.md caveat
    C8): step two is held from one state, each param within 2 x lr + 2%
    of the CPU's step, at most 0.1% beyond TRAIN_PARAM_TOL, and the new
    codes equal for 99.99% of entries, within one code."""
    from repro_torch.ckpt.checkpoint import leaves_with_paths
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt
    p_d, p_c = T.params_of(model), T.params_of(cpu)
    s_d, s_c = opt.init(ocfg, p_d), opt.init(ocfg, p_c)
    rows = []

    def step(b, p_d, s_d, p_c, s_c):
        p_d, s_d, m_d = T.train_step(model, p_d, s_d,
                                     {k: v.to(dev) for k, v in b.items()},
                                     ocfg)
        p_c2, s_c2, m_c = T.train_step(cpu, p_c, s_c, b, ocfg)
        row = {k: [float(m_d[k]), float(m_c[k])]
               for k in ("loss", "aux", "grad_norm")}
        for k, tol in (("loss", TRAIN_LOSS_TOL), ("aux", TRAIN_LOSS_TOL),
                       ("grad_norm", TRAIN_GNORM_TOL)):
            d, c = row[k]
            assert abs(d - c) <= tol * abs(c), f"11a {name} {k}: {row}"
        rows.append(row)
        return p_d, s_d, p_c2, s_c2, float(m_c["lr"])

    p_d, s_d, p_c1, s_c1, lr = step(batches[0], p_d, s_d, p_c, s_c)
    first = _adam_agreement(torch, p_d, p_c1, lr)
    p_d = {k: v.to(dev) for k, v in p_c1.items()}
    s_d = opt.AdamWState(s_c1.step.to(dev),
                         *({k: opt.QMoment(q.q.to(dev), q.scale.to(dev))
                            for k, q in mom.items()}
                           for mom in (s_c1.m, s_c1.v)))
    p_d, s_d, p_c2, s_c2, lr = step(batches[1], p_d, s_d, p_c1, s_c1)
    err = torch.cat([(p_d[k].cpu().double() - p_c2[k].double()).abs()
                     .reshape(-1) for k in p_c2])
    stp = torch.cat([(p_c2[k].double() - p_c1[k].double()).abs()
                     .reshape(-1) for k in p_c2])
    share = float((err > TRAIN_PARAM_TOL).double().mean())
    assert share <= 1e-3, (name, share)
    assert bool((err <= 2 * lr + 0.02 * stp).all()), \
        f"11a {name}: int8 step two differs by {float(err.max())}"
    codes = [(a, b) for (ka, a), (_, b) in zip(
        leaves_with_paths((s_d.m, s_d.v)), leaves_with_paths((s_c2.m,
                                                             s_c2.v)))
             if a.dtype == torch.int8]
    differ = sum(int((a.cpu() != b).sum()) for a, b in codes)
    n = sum(b.numel() for _, b in codes)
    assert differ <= 1e-4 * n, (name, differ, n)
    assert all(int((a.cpu().int() - b.int()).abs().max()) <= 1
               for a, b in codes)
    return {"steps": rows, "first_step_params": first,
            "second_step": {"share_beyond_tol": share,
                            "max_abs_err": float(err.max()),
                            "largest_step": float(stp.max()),
                            "codes_differ": differ, "codes": n}}


def _moe_phase(args, torch, np, dev, smi, scout_spec, kimi_spec,
               kernel_mods):
    """Phase 11: the MoE LM family. (a) a 1-layer full-width llama4-scout
    cut (float32) on the card against a CPU copy: routing, then logits;
    and the smoke configs' train steps against the CPU; (b) a 4-layer
    llama4-scout cut in its own dtypes: prefill of 1.5 windows, decode in
    the second, readings, the no-drop check and a chunked layer against
    its explicit mask; (c) a 1-layer kimi-k2 cut: readings and the no-drop
    check. Returns the launches (none: no kernel is on this path) and the
    readings."""
    import dataclasses
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt

    out = {}
    for mod in kernel_mods.values():
        mod.launches = 0
    torch.cuda.empty_cache()
    print(f"phase 11 starts with {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated on the card")

    # -- 11a. a 1-layer full-width llama4-scout cut, card against CPU --------
    t0 = _phase("11a. MoE: a 1-layer full-width llama4-scout cut (float32) "
                "on the card against the CPU; smoke train steps")
    cfg = dataclasses.replace(scout_spec.config, n_layers=1,
                              activation_dtype="float32")
    model = T.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 110), device=dev)
    cpu = T.Transformer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    hg = torch.Generator().manual_seed(args.seed + 111)
    b, s = MOE_CUT_PROMPT
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=hg)
    rec_d, hooks_d = _record_moe(model)
    rec_c, hooks_c = _record_moe(cpu)
    got, cache = T.prefill(model, prompt.to(dev), max_len=s + MOE_CUT_DECODE)
    want, cache_c = T.prefill(cpu, prompt, max_len=s + MOE_CUT_DECODE)
    pairs = [(got, want)]
    for i in range(MOE_CUT_DECODE):
        nxt = torch.argmax(want, -1).to(torch.int32)
        got, cache = T.decode_step(model, nxt.to(dev), cache, s + i)
        want, cache_c = T.decode_step(cpu, nxt, cache_c, s + i)
        pairs.append((got, want))
    for h in hooks_d + hooks_c:
        h.remove()
    routing = _routing_diff(torch, L, rec_d, rec_c)
    # the logits of a row whose last token routed otherwise are not held
    flipped = {(c, t) for c, t, _ in routing["near_tie_flips"]}
    skip = [{r for r in range(b) if (0, r * s + s - 1) in flipped}]
    skip += [{r for r in range(b) if (1 + i, r) in flipped}
             for i in range(MOE_CUT_DECODE)]
    errs = [_moe_logit_check(torch, g, w, sk)
            for (g, w), sk in zip(pairs, skip)]
    cut = {"routing": routing, "logits_max_abs_err": errs,
           "skipped_rows": [sorted(x) for x in skip]}
    del model, cpu, cache, cache_c, rec_d, rec_c, pairs, got, want
    torch.cuda.empty_cache()
    smoke = {}
    for spec in (scout_spec, kimi_spec):
        for md in ("fp32", "int8"):
            scfg = spec.smoke_config
            m = T.init(scfg, generator=torch.Generator(dev).manual_seed(
                args.seed + 112), device=dev)
            c = T.Transformer(scfg, device="cpu")
            c.load_state_dict(m.state_dict())
            ocfg = opt.AdamWConfig(lr=TRAIN_CUT_LR, warmup_steps=1,
                                   total_steps=TRAIN_CUT_STEPS,
                                   moment_dtype=md)
            batches = [make_lm_batch(hg, scfg.vocab, *MOE_SMOKE_BATCH)
                       for _ in range(TRAIN_CUT_STEPS)]
            name = f"{spec.arch_id} {md}"
            smoke[name] = (
                _train_cut(torch, dev, name, m, c, T.train_step, batches,
                           ocfg)[0]
                if md == "fp32" else
                _moe_train_int8(torch, dev, name, m, c, batches, ocfg))
            del m, c
    cut["smoke_train"] = smoke
    cut["seconds"] = time.perf_counter() - t0
    out["cut"] = cut
    print(json.dumps({"moe_cut": cut, "smi": smi}))

    # -- 11b. llama4-scout, one iRoPE period at full width -------------------
    cfg = dataclasses.replace(scout_spec.config, n_layers=SCOUT_LAYERS)
    t0 = _phase(f"11b. llama4-scout at full width, {SCOUT_LAYERS} layers "
                f"(chunked {cfg.layer_is_chunked()}): prefill 1 x "
                f"{SCOUT_PROMPT} into {SCOUT_MAX_LEN}, {SCOUT_DECODE} "
                f"decode steps")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = T.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 113), device=dev)
    weights_gib = (torch.cuda.memory_allocated() - base) / 2**30
    g = torch.Generator(dev).manual_seed(args.seed + 114)
    prompt = torch.randint(0, cfg.vocab, (1, SCOUT_PROMPT), generator=g,
                           device=dev, dtype=torch.int32)
    scout = _moe_serve(torch, np, T, L, model, prompt, SCOUT_MAX_LEN,
                       SCOUT_DECODE, smi, "moe_scout")
    scout["weights_gib"] = weights_gib
    cf = cfg.n_experts / cfg.moe_top_k
    _set_moe(model, capacity_factor=cf, moe_expert_chunks=SCOUT_CHECK_CHUNKS)
    t1 = time.perf_counter()
    got, want = _no_drop_run(torch, T, model, prompt, SCOUT_MAX_LEN,
                             SCOUT_DECODE,
                             -(SCOUT_PROMPT + SCOUT_DECODE) % cfg.q_chunk,
                             g)
    scout["no_drop"] = _no_drop_check(torch, got, want)
    scout["no_drop"].update(capacity_factor=cf,
                            expert_chunks=SCOUT_CHECK_CHUNKS,
                            seconds=time.perf_counter() - t1)
    del got, want
    _set_moe(model, capacity_factor=cfg.capacity_factor,
             moe_expert_chunks=cfg.moe_expert_chunks)
    torch.cuda.empty_cache()
    blk = model.blocks[0]
    assert blk.chunked
    with torch.no_grad():
        h = blk.ln1(model.embed_tokens(prompt))
    scout["chunked_layer_rel_err"] = _chunk_attn_check(torch, L, blk, cfg, h)
    del h, model, prompt
    torch.cuda.empty_cache()
    scout["seconds"] = time.perf_counter() - t0
    out["scout"] = scout
    print(json.dumps({"moe_scout_checks": {
        k: scout[k] for k in ("no_drop", "chunked_layer_rel_err",
                              "weights_gib", "seconds")}, "smi": smi}))

    # -- 11c. kimi-k2, one layer at full width --------------------------------
    cfg = dataclasses.replace(kimi_spec.config, n_layers=1)
    b, s = KIMI_PROMPT
    t0 = _phase(f"11c. kimi-k2 at full width, 1 layer ({cfg.n_experts} "
                f"experts top-{cfg.moe_top_k}, bf16): prefill {b} x {s}, "
                f"{KIMI_DECODE} decode steps")
    base = torch.cuda.memory_allocated()
    model = T.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 115), device=dev)
    weights_gib = (torch.cuda.memory_allocated() - base) / 2**30
    g = torch.Generator(dev).manual_seed(args.seed + 116)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev,
                           dtype=torch.int32)
    kimi = _moe_serve(torch, np, T, L, model, prompt, s + KIMI_DECODE,
                      KIMI_DECODE, smi, "moe_kimi")
    kimi["weights_gib"] = weights_gib
    cf = cfg.n_experts / cfg.moe_top_k
    _set_moe(model, capacity_factor=cf, moe_expert_chunks=KIMI_CHECK_CHUNKS)
    got, want = _no_drop_run(torch, T, model, prompt, s + KIMI_DECODE,
                             KIMI_DECODE, 0, g)
    kimi["no_drop"] = _no_drop_check(torch, got, want)
    kimi["no_drop"].update(capacity_factor=cf,
                           expert_chunks=KIMI_CHECK_CHUNKS)
    del got, want, model, prompt
    torch.cuda.empty_cache()
    kimi["seconds"] = time.perf_counter() - t0
    out["kimi"] = kimi
    print(json.dumps({"moe_kimi_checks": {
        k: kimi[k] for k in ("no_drop", "weights_gib", "seconds")},
        "smi": smi}))
    launches = {"moe": {n: mod.launches for n, mod in kernel_mods.items()}}
    assert not any(launches["moe"].values()), launches
    return {"launches": launches, **out}


def _rel(torch, got, want) -> float:
    """max |got - want| / max |want|, ``want`` on the CPU."""
    w = want.detach().double()
    d = (got.detach().cpu().double() - w).abs().max()
    return float(d / w.abs().max().clamp_min(1e-30))


def _errors(torch, mod, logits_fn, cfg, model, batch, ref, ref_batch):
    """``model`` on ``batch`` against ``ref`` (on the CPU) on ``ref_batch``:
    the logits', the loss's and the grads' relative errors (a grad leaf to
    its largest entry, floored at 1e-3 x the tree's largest), and the
    worst leaf."""
    from repro_torch.models import transformer as T
    p_d, p_c = T.params_of(model), T.params_of(ref)
    with torch.no_grad():
        lg_d, lg_c = logits_fn(p_d, batch), logits_fn(p_c, ref_batch)
    l_d, _, g_d = T.value_and_grad(lambda p: mod.loss_fn(p, batch, cfg), p_d)
    l_c, _, g_c = T.value_and_grad(lambda p: mod.loss_fn(p, ref_batch, cfg),
                                   p_c)
    assert bool(torch.isfinite(lg_c).all()) and bool(torch.isfinite(l_c))
    top = max(float(g.abs().max()) for g in g_c.values())
    grads = {k: float((g_d[k].cpu() - g).abs().max())
             / max(float(g.abs().max()), 1e-3 * top, 1e-30)
             for k, g in g_c.items()}
    worst = max(grads, key=grads.get)
    return {"logits": _rel(torch, lg_d, lg_c),
            "loss": abs(float(l_d) - float(l_c)) / abs(float(l_c)),
            "grad": grads[worst], "grad_worst_leaf": worst,
            "grad_leaves": len(grads)}


def _card_vs_cpu(torch, name, mod, logits_fn, model, cpu, cfg, batch, dev,
                 tol):
    """``model`` on the card against ``cpu`` (the same params, through
    ``convert``) on one batch: the logits, the loss and the grads, each
    within ``tol`` relative (a float, or one per key). Returns the
    errors."""
    bd = {k: v.to(dev) for k, v in batch.items()}
    out = _errors(torch, mod, logits_fn, cfg, model, bd, cpu, batch)
    tols = tol if isinstance(tol, dict) else dict.fromkeys(
        ("logits", "loss", "grad"), tol)
    out["tol"] = tols
    print(f"12a {name}: logits {out['logits']:.2e}, loss {out['loss']:.2e}, "
          f"grads {out['grad']:.2e} (worst leaf {out['grad_worst_leaf']} of "
          f"{out['grad_leaves']}), relative; tolerance {tols}")
    for key, t in tols.items():
        assert out[key] <= t, f"12a {name} {key}: {out}"
    return out


def _event_ms(torch, fn, reps: int) -> float:
    """Device time of one call: CUDA events around ``reps`` calls after a
    warm one (launch gaps included)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _serve_readings(torch, np, fn, n, graph: bool):
    """One cell's readings: the peak memory of a call above what was held,
    the host wall (median of 9 calls, each ended by a synchronize),
    samples/s from it, and the device time, from a CUDA-graph replay when
    ``graph`` (small calls, so host time is not counted) or CUDA events
    around 3 calls. Returns (readings, the first call's output)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first, flops = _real_flops(fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    walls = []
    for _ in range(9):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    wall = float(np.median(walls))
    torch.cuda.empty_cache()
    dev_ms = _time_ms(torch, fn, 3) if graph else _event_ms(torch, fn, 3)
    return {"batch": n, "host_wall_ms": wall, "device_ms": dev_ms,
            "device_time_from": "cuda graph" if graph else "cuda events",
            "samples_per_s": n / wall * 1e3,
            "device_samples_per_s": n / dev_ms * 1e3,
            "peak_gib": peak / 2**30, "peak_bytes": peak,
            "flops": flops}, first


def _real_flops(fn):
    """(fn(), its FLOPs as the dry run counts them: FlopCounterMode plus
    the kernels' recorded launches) for phase 14's comparison."""
    from repro_torch.launch.dryrun import real_flops
    return real_flops(fn)


def _flops_of(fn) -> float:
    """The FLOPs of one extra call of ``fn`` (its output dropped at once,
    so no step's params or moments outlive it)."""
    return _real_flops(fn)[1]


def _count_kernels(torch, fn) -> int:
    """Kernels the card ran in one call of ``fn``, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if str(e.device_type).endswith("CUDA"))


def _recsys_cells(torch, np, cfg, params, dev, seed, cand_pass=None):
    """serve_p99, serve_bulk and retrieval_cand (1 user x 10^6 candidates,
    ids below the last table's rows) of one recsys config: readings, every
    output finite and of its shape, and ``score_candidates`` against
    ``forward`` on its first CAND_CHECK candidates' explicit rows."""
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models import recsys
    dims = {c.name: c.dims for c in RECSYS_SHAPES}
    g = torch.Generator().manual_seed(seed)

    def batch(n):
        b = make_recsys_batch(g, n, cfg.n_dense, cfg.table_rows,
                              seq_len=cfg.seq_len, family=cfg.family)
        return {k: v.to(dev) for k, v in b.items() if k != "label"}

    out = {}
    for cell in ("serve_p99", "serve_bulk"):
        n = dims[cell]["batch"]
        b = batch(n)
        out[cell], probs = _serve_readings(
            torch, np, lambda: recsys.serve_step(params, b, cfg), n,
            graph=cell == "serve_p99")
        assert probs.shape == (n,) and bool(torch.isfinite(probs).all())
        assert bool(((probs >= 0) & (probs <= 1)).all())
        del b, probs
    n_c = dims["retrieval_cand"]["n_candidates"]
    user = {k: v[:1] for k, v in batch(1).items()}
    cands = torch.randint(0, cfg.table_rows[-1], (n_c,), generator=g,
                          dtype=torch.int32).to(dev)
    step = cand_pass or n_c

    def score():
        return torch.cat([recsys.score_candidates(params, user,
                                                   cands[i:i + step], cfg)
                          for i in range(0, n_c, step)])

    out["retrieval_cand"], logits = _serve_readings(torch, np, score, n_c,
                                                    graph=False)
    out["retrieval_cand"]["passes"] = -(-n_c // step)
    assert logits.shape == (n_c,) and bool(torch.isfinite(logits).all())
    c = cands[:CAND_CHECK]
    if cfg.family in ("din", "dien"):
        rows = {"hist_ids": user["hist_ids"].expand(CAND_CHECK, -1),
                "hist_mask": user["hist_mask"].expand(CAND_CHECK, -1),
                "target_ids": c}
    else:
        sparse = user["sparse_ids"].expand(CAND_CHECK, -1).clone()
        sparse[:, -1] = c
        rows = {"dense": user["dense"].expand(CAND_CHECK, -1),
                "sparse_ids": sparse}
    with torch.no_grad():
        want = recsys.forward(params, rows, cfg)
    err = _rel(torch, logits[:CAND_CHECK], want.cpu())
    tol = CAND_TOL_BF16 if cfg.param_dtype == "bfloat16" else CAND_TOL
    out["retrieval_cand"]["vs_forward_rel_err"] = err
    assert err <= tol, f"{cfg.name} retrieval_cand vs forward: {err}"
    for cell, r in out.items():
        print(f"{cfg.name} {cell}: host wall {r['host_wall_ms']:.3f} ms "
              f"({r['samples_per_s']:.0f} samples/s), device "
              f"{r['device_ms']:.3f} ms ({r['device_time_from']}), peak "
              f"{r['peak_gib']:.2f} GiB")
    return out


def _recsys_train(torch, np, cfg, params, dev, seed, steps, batch):
    """``steps`` AdamW steps of ``recsys.train_step`` at ``batch`` from
    ``params`` (fresh moments) on batches drawn on the host: per-step
    seconds (each ended by a synchronize), samples/s from the median after
    the first, peak memory, the losses. Returns (readings, params,
    state)."""
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models import recsys
    from repro_torch.optim import optimizer as opt
    ocfg = opt.AdamWConfig(total_steps=steps,
                           warmup_steps=max(1, steps // 10))
    state = opt.init(ocfg, params)
    g = torch.Generator().manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for _ in range(steps):
        b = {k: v.to(dev) for k, v in make_recsys_batch(
            g, batch, cfg.n_dense, cfg.table_rows, seq_len=cfg.seq_len,
            family=cfg.family).items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, m = recsys.train_step(params, state, b, cfg, ocfg)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t1)
    assert all(np.isfinite(losses)), f"{cfg.name} losses {losses}"
    med = float(np.median(secs[1:]))
    return {"step_s": secs, "median_step_s_after_first": med,
            "samples_per_s": batch / med, "losses": losses,
            "peak_memory_gib": (torch.cuda.max_memory_allocated() - base)
            / 2**30}, params, state


def _quantize_cell(torch, np, cfg, params, dev, seed):
    """``quantize_tables`` over every table of ``cfg`` (k=QT_K,
    iters=QT_ITERS, restarts=QT_RESTARTS): seconds, bytes against the
    float tables, ``quantized_lookup``'s relative reconstruction error
    over a serve_bulk batch of ids, and each table's codes held to
    ``kmeans_assign_plain`` (a comparison, not the path's launches)."""
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models import recsys
    tables = recsys.tables_of(params, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qt = recsys.quantize_tables(torch.Generator(dev).manual_seed(seed),
                                tables, k=QT_K, iters=QT_ITERS,
                                restarts=QT_RESTARTS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    from repro_torch.configs.base import RECSYS_SHAPES
    n = {c.name: c.dims for c in RECSYS_SHAPES}["serve_bulk"]["batch"]
    # a CPU Mersenne Twister for the ids, the card's Philox for k-means:
    # one seed, two unrelated streams
    ids = make_recsys_batch(torch.Generator().manual_seed(seed), n,  # noqa: TORCH01
                            cfg.n_dense, cfg.table_rows,
                            family=cfg.family)["sparse_ids"].to(dev)
    with torch.no_grad():
        full = recsys.lookup(tables, ids).float()
        approx = recsys.quantized_lookup(qt, ids).float()
    rel = float(((approx - full) ** 2).mean() / (full ** 2).mean())
    del full, approx
    return {"seconds": secs, "tables": len(tables),
            "tables_nbytes": recsys.tables_nbytes(tables),
            "qtables_nbytes": recsys.qtables_nbytes(qt),
            "compression": recsys.tables_nbytes(tables)
            / recsys.qtables_nbytes(qt),
            "lookup_rel_sq_err": rel}, list(zip(tables, qt["codebooks"],
                                                qt["codes"]))


def _check_table_codes(torch, triples):
    """Each table's codes (from the kernel, in ``quantize_tables``) against
    ``kmeans_assign_plain`` with ``_check_assign``; the largest gap."""
    from repro_torch.kernels import kmeans_assign as km
    gap = 0.0
    for t, cb, codes in triples:
        x = t.float()
        gap = max(gap, _check_assign(torch, x, cb, codes.to(torch.int32),
                                     km.kmeans_assign_plain(x, cb)))
    return gap


def _recsys_phase(args, torch, np, dev, smi, kernel_mods):
    """Phase 12a-b: the recsys family. (a) DCN-v2, DIN (p 0 and 50), DIEN
    and the DLRM-MLPerf row cut on the card against CPU copies at
    serve_p99's batch, and ``quantize`` at D=16 and D=18 against
    ``kmeans_assign_plain``; (b) every recsys cell at full width. Returns
    the launches of 12b, the readings, and kmeans_assign's times at the
    tables' shapes."""
    import dataclasses
    import shutil
    from repro_torch import convert
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.recsys_archs import (DCN_V2, DIEN, DIN,
                                                  DLRM_MLPERF)
    from repro_torch.core import quantization as quant
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.models import recsys
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt

    build = ROOT / "build"
    ocfg = opt.AdamWConfig(total_steps=RECSYS_TRAIN_STEPS)
    out = {}
    for mod in kernel_mods.values():
        mod.launches = 0
    torch.cuda.empty_cache()
    print(f"phase 12 starts with {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated on the card")
    dlrm_cut = dataclasses.replace(DLRM_MLPERF.config, table_rows=tuple(
        min(r, DLRM_CUT_ROWS) for r in DLRM_MLPERF.config.table_rows))
    din_p50 = dataclasses.replace(DIN.config, din_prune_p=50.0)
    dims = {c.name: c.dims["batch"] for c in RECSYS_SHAPES}
    p99, train_b = dims["serve_p99"], dims["train_batch"]

    # -- 12a. card against CPU -------------------------------------------
    t0 = _phase(f"12a. recsys at full width (float32) on the card against "
                f"the CPU, batch {p99}; quantize at D=16 and D=18")
    checks, km_gap = {}, 0.0
    for i, cfg in enumerate((DCN_V2.config, DIN.config, din_p50,
                             DIEN.config, dlrm_cut)):
        name = cfg.name + ("-p50" if cfg.din_prune_p else "") + (
            "-cut" if cfg is dlrm_cut else "")
        model = recsys.init(cfg, generator=torch.Generator(dev).manual_seed(
            args.seed + 120 + i), device=dev)
        cpu = convert.recsys_params_from_numpy(
            convert.params_to_numpy(model), cfg, device="cpu")
        b = make_recsys_batch(torch.Generator().manual_seed(args.seed + 130
                                                            + i), p99,
                              cfg.n_dense, cfg.table_rows,
                              seq_len=cfg.seq_len, family=cfg.family)
        checks[name] = _card_vs_cpu(
            torch, name, recsys,
            lambda p, bb, c=cfg: recsys.forward(p, bb, c), model, cpu, cfg,
            b, dev, RECSYS_TOL)
        if cfg.family in ("dcn", "din") and not cfg.din_prune_p:
            # the kernel at D = 16 (DCN-v2's largest table) and D = 18
            t = max(model.tables, key=lambda x: x.shape[0]).detach()
            cb, _ = quant.kmeans_fit(torch.Generator(dev).manual_seed(
                args.seed + 140), t, quant.KMeansConfig(k=QT_K, iters=3,
                                                        n_restarts=1))
            km_gap = max(km_gap, _check_assign(
                torch, t, cb, quant.quantize(t, cb).to(torch.int32),
                km.kmeans_assign_plain(t, cb)))
        del model, cpu
        torch.cuda.empty_cache()
    out["card_vs_cpu"] = checks
    print(json.dumps({"recsys_card_vs_cpu": checks,
                      "seconds": time.perf_counter() - t0}))

    # -- 12b. the recsys cells at full width --------------------------------
    launches = {}
    for mod in kernel_mods.values():
        mod.launches = 0
    cells = {}
    t0 = _phase(f"12b. dcn-v2 at full width: {RECSYS_TRAIN_STEPS} train "
                f"steps at {train_b} through launch.train, the serving "
                f"cells, quantize_tables")
    ckpt_dir = build / "train_ckpt_dcn"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = DCN_V2.config
    tb = sum(cfg.table_rows) * cfg.embed_dim * 4
    res, tr = _train_cli_run(
        torch, np, ["--arch", "dcn-v2", "--batch", str(train_b), "--steps",
                    str(RECSYS_TRAIN_STEPS), "--ckpt-every", "0",
                    "--ckpt-dir", str(ckpt_dir), "--seed",
                    str(args.seed + 150)], build, 3.1 * tb, "12b dcn-v2")
    res.pop("model")
    tr["samples_per_s"] = train_b / tr["median_step_s_after_first"]
    sb = {k: v.to(dev) for k, v in make_recsys_batch(
        torch.Generator().manual_seed(args.seed + 151), train_b, cfg.n_dense,
        cfg.table_rows, family=cfg.family).items()}
    tr["split"] = _train_split(torch, lambda p: recsys.loss_fn(p, sb, cfg),
                               ocfg, res["params"], res["opt_state"])
    tr["flops"] = _flops_of(lambda: recsys.train_step(
        res["params"], res["opt_state"], sb, cfg, ocfg))
    tr["params_bytes"] = sum(t.numel() * t.element_size()
                             for t in res["params"].values())
    tr["table_bytes"] = tb
    del sb
    shutil.rmtree(ckpt_dir)
    params = res["params"]
    del res
    torch.cuda.empty_cache()
    dcn = {"train": tr, **_recsys_cells(torch, np, cfg, params, dev,
                                        args.seed + 152)}
    dcn["quantize"], triples = _quantize_cell(torch, np, cfg, params, dev,
                                              args.seed + 153)
    dcn["quantize"]["codes_max_gap_vs_plain"] = _check_table_codes(
        torch, triples)
    km_tables = {"dcn": max(triples, key=lambda x: x[0].shape[0])[:2]}
    del triples, params
    torch.cuda.empty_cache()
    dcn["seconds"] = time.perf_counter() - t0
    cells["dcn-v2"] = dcn
    print(json.dumps({"recsys_dcn_v2": dcn, "smi": smi}))

    cfg = dataclasses.replace(DLRM_MLPERF.config, param_dtype="bfloat16")
    t0 = _phase(f"12b. dlrm-mlperf serving at its full {sum(cfg.table_rows)}"
                f" rows in bfloat16")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    model = recsys.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 160), device=dev)
    torch.cuda.synchronize()
    dlrm = {"init_s": time.perf_counter() - t1,
            "weights_gib": (torch.cuda.memory_allocated() - base) / 2**30,
            **_recsys_cells(torch, np, cfg, T.params_of(model), dev,
                            args.seed + 161)}
    del model
    torch.cuda.empty_cache()
    cfg = dlrm_cut
    t1 = _phase(f"12b. dlrm-mlperf on its {DLRM_CUT_ROWS}-row cut (float32): "
                f"{RECSYS_TRAIN_STEPS} train steps at {train_b}, "
                f"quantize_tables")
    model = recsys.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 162), device=dev)
    dlrm["cut_train"], params, _ = _recsys_train(
        torch, np, cfg, T.params_of(model), dev, args.seed + 163,
        RECSYS_TRAIN_STEPS, train_b)
    del model
    dlrm["cut_quantize"], triples = _quantize_cell(
        torch, np, cfg, params, dev, args.seed + 164)
    dlrm["cut_quantize"]["codes_max_gap_vs_plain"] = _check_table_codes(
        torch, triples)
    km_tables["dlrm_cut"] = max(triples, key=lambda x: x[0].shape[0])[:2]
    del triples, params
    torch.cuda.empty_cache()
    dlrm["seconds"] = time.perf_counter() - t0
    cells["dlrm-mlperf"] = dlrm
    print(json.dumps({"recsys_dlrm_mlperf": dlrm, "smi": smi}))

    for spec, cut in ((DIN, None), (DIN, 50.0), (DIEN, None)):
        name = spec.arch_id + (f"-p{cut:g}" if cut else "")
        t0 = _phase(f"12b. {name} at full width: {RECSYS_TRAIN_STEPS} train "
                    f"steps at {train_b} x {spec.config.seq_len}, the serving "
                    f"cells")
        if cut is None:
            ckpt_dir = build / f"train_ckpt_{name}"
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            res, tr = _train_cli_run(
                torch, np, ["--arch", spec.arch_id, "--batch", str(train_b),
                            "--steps", str(RECSYS_TRAIN_STEPS),
                            "--ckpt-every", "0", "--ckpt-dir",
                            str(ckpt_dir), "--seed", str(args.seed + 170)],
                build, 1 << 30, f"12b {name}")
            res.pop("model")
            tr["samples_per_s"] = train_b / tr["median_step_s_after_first"]
            shutil.rmtree(ckpt_dir)
            params, cfg = res["params"], spec.config
            state = res["opt_state"]
            del res
            fb = {k: v.to(dev) for k, v in make_recsys_batch(
                torch.Generator().manual_seed(args.seed + 174), train_b,
                cfg.n_dense, cfg.table_rows, seq_len=cfg.seq_len,
                family=cfg.family).items()}
            tr["flops"] = _flops_of(lambda: recsys.train_step(
                params, state, fb, cfg, ocfg))
            tr["params_bytes"] = sum(t.numel() * t.element_size()
                                     for t in params.values())
            del fb
        else:
            cfg = dataclasses.replace(spec.config, din_prune_p=cut)
            tr, params, state = _recsys_train(
                torch, np, cfg, params, dev, args.seed + 171,
                RECSYS_TRAIN_STEPS, train_b)
        if cfg.family == "dien":
            sb = {k: v.to(dev) for k, v in make_recsys_batch(
                torch.Generator().manual_seed(args.seed + 172), train_b,
                cfg.n_dense, cfg.table_rows, seq_len=cfg.seq_len,
                family=cfg.family).items()}
            tr["kernels_per_train_step"] = _count_kernels(
                torch, lambda: recsys.train_step(params, state, sb, cfg,
                                                 ocfg))
            tr["kernels_per_serve_call"] = _count_kernels(
                torch, lambda: recsys.serve_step(params, sb, cfg))
            del sb
        del state
        cells[name] = {"train": tr, **_recsys_cells(
            torch, np, cfg, params, dev, args.seed + 173,
            cand_pass=CAND_PASS)}
        if cfg.family == "dien":
            del params
        cells[name]["seconds"] = time.perf_counter() - t0
        print(json.dumps({f"recsys_{name}": cells[name], "smi": smi}))
    launches["recsys"] = {n: mod.launches for n, mod in kernel_mods.items()}
    want = len(DCN_V2.config.table_rows) + len(dlrm_cut.table_rows)
    assert launches["recsys"]["kmeans_assign"] == want, launches
    out["cells"] = cells
    out["launches"] = launches

    # kmeans_assign at the tables' shapes (after the path's count)
    din_t = recsys.init(DIN.config, generator=torch.Generator(
        dev).manual_seed(args.seed + 180), device=dev).tables[0].detach()
    din_cb, _ = quant.kmeans_fit(torch.Generator(dev).manual_seed(1), din_t,
                                 quant.KMeansConfig(k=QT_K, iters=2,
                                                    n_restarts=1))
    km_tables["din"] = (din_t, din_cb)
    km_times = {}
    for key, (t, cb) in km_tables.items():
        x = t.float().contiguous()
        n, d = x.shape
        c2 = (cb * cb).sum(-1)
        b = _gemm_bounds(n * d * 4 + cb.numel() * 4 + n * 4,
                         2.0 * n * cb.shape[0] * d)
        km_times[key] = {
            "shape": f"{n} x {d} against K={cb.shape[0]}",
            "ms": _time_ms(torch, lambda: km.kmeans_assign_cuda(x, cb), 10),
            "plain_ms": _time_ms(torch, lambda: km.kmeans_assign_plain(
                x, cb), 3),
            "addmm_yardstick_ms": _time_ms(torch, lambda: torch.addmm(
                c2, x, cb.t(), alpha=-2.0), 3),
            "bound_ms": b[0], "bound_by": b[1], "f32_fma_bound_ms": b[2],
            "tf32x3_bound_ms": b[3]}
        print(f"kmeans_assign {key} table: {json.dumps(km_times[key])}")
    out["kmeans_assign_at_tables"] = km_times
    out["kmeans_max_gap"] = max(
        km_gap, cells["dcn-v2"]["quantize"]["codes_max_gap_vs_plain"],
        cells["dlrm-mlperf"]["cut_quantize"]["codes_max_gap_vs_plain"])
    del km_tables, din_t, din_cb
    torch.cuda.empty_cache()
    return out


def _pna_steps(torch, np, gnn, cfg, params, state, ocfg, batches):
    """One train step per batch: host wall (ended by a synchronize) and
    device time (CUDA events) of each, and the losses."""
    walls, devs, losses = [], [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        params, state, m = gnn.train_step(params, state, b, cfg, ocfg)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        devs.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), f"{cfg.name} losses {losses}"
    return {"step_host_wall_ms": walls, "step_device_ms": devs,
            "losses": losses}, params, state


def _pna_phase(args, torch, np, dev, smi, kernel_mods):
    """Phase 12a (PNA) and 12c: PNA at full_graph_sm on the card against a
    CPU copy; then the full_graph_sm and molecule cells and minibatch_lg
    (a Reddit-scale graph, its CSR built on the host, subgraphs from the
    sampler). Returns the launches (none: no kernel is on this path) and
    the readings."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.gnn_archs import PNA
    from repro_torch.data import sampler
    from repro_torch.data.synthetic import make_graph, make_molecule_batch
    from repro_torch.models import gnn
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizer as opt

    dims = {c.name: c.dims for c in GNN_SHAPES}
    out = {}
    sm = dims["full_graph_sm"]
    cfg = dataclasses.replace(PNA.config, d_feat=sm["d_feat"],
                              n_classes=sm["n_classes"])
    t0 = _phase(f"12a. pna at full_graph_sm ({sm['n_nodes']} nodes, "
                f"{sm['n_edges']} edges, d_feat {sm['d_feat']}) on the card "
                f"against the CPU")
    model = gnn.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 190), device=dev)
    cpu = convert.pna_params_from_numpy(convert.params_to_numpy(model), cfg,
                                        device="cpu")
    g_sm = make_graph(torch.Generator().manual_seed(args.seed + 191),
                      sm["n_nodes"], sm["n_edges"], sm["d_feat"],
                      sm["n_classes"])
    # the card's atomics sum each node's messages in another order: the
    # bound is the larger of PNA_TOL and PNA_REORDER x what the same edges
    # in a shuffled order move on the CPU
    logits_fn = lambda p, b: gnn.serve_step(p, b, cfg)      # noqa: E731
    perm = torch.randperm(sm["n_edges"], generator=torch.Generator()
                          .manual_seed(args.seed + 197))
    shuffled = dict(g_sm, edge_index=g_sm["edge_index"][:, perm])
    reorder = _errors(torch, gnn, logits_fn, cfg, cpu, shuffled, cpu, g_sm)
    print(f"12a pna: the CPU with its edges shuffled: {json.dumps(reorder)}")
    tol = {k: max(PNA_TOL, PNA_REORDER * reorder[k])
           for k in ("logits", "loss", "grad")}
    out["card_vs_cpu"] = _card_vs_cpu(
        torch, "pna full_graph_sm", gnn, logits_fn, model, cpu, cfg, g_sm,
        dev, tol)
    out["card_vs_cpu"]["cpu_reordered"] = reorder
    del cpu

    for mod in kernel_mods.values():
        mod.launches = 0
    ocfg = opt.AdamWConfig(total_steps=PNA_STEPS, warmup_steps=1)
    t0 = _phase(f"12c. pna: full_graph_sm and molecule, {PNA_STEPS} train "
                f"steps each; minibatch_lg from the sampler")
    params = T.params_of(model)
    b = {k: v.to(dev) for k, v in g_sm.items()}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["full_graph_sm"], _, _ = _pna_steps(
        torch, np, gnn, cfg, params, opt.init(ocfg, params), ocfg,
        [b] * PNA_STEPS)
    out["full_graph_sm"]["peak_above_held_bytes"] = (
        torch.cuda.max_memory_allocated() - held)
    out["full_graph_sm"]["flops"] = _flops_of(
        lambda: gnn.train_step(params, opt.init(ocfg, params), b, cfg, ocfg))
    del model, params, b
    mol = dims["molecule"]
    cfg = dataclasses.replace(PNA.config, d_feat=mol["d_feat"],
                              n_classes=mol["n_classes"], task="graph")
    model = gnn.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 192), device=dev)
    params = T.params_of(model)
    mg = torch.Generator().manual_seed(args.seed + 193)
    batches = [{k: v.to(dev) for k, v in make_molecule_batch(
        mg, mol["n_graphs"], mol["nodes_per"], mol["edges_per"],
        mol["d_feat"]).items()} for _ in range(PNA_STEPS)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["molecule"], _, _ = _pna_steps(torch, np, gnn, cfg, params,
                                       opt.init(ocfg, params), ocfg,
                                       batches)
    out["molecule"]["peak_above_held_bytes"] = (
        torch.cuda.max_memory_allocated() - held)
    out["molecule"]["flops"] = _flops_of(lambda: gnn.train_step(
        params, opt.init(ocfg, params), batches[0], cfg, ocfg))
    del model, params, batches

    lg = dims["minibatch_lg"]
    t1 = time.perf_counter()
    graph = make_graph(torch.Generator().manual_seed(args.seed + 194),
                       lg["graph_nodes"], lg["graph_edges"], lg["d_feat"],
                       lg["n_classes"])
    make_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    csr = sampler.build_csr(lg["graph_nodes"], graph["edge_index"].numpy(),
                            graph["feats"].numpy(), graph["labels"].numpy())
    csr_s = time.perf_counter() - t1
    del graph
    cfg = dataclasses.replace(PNA.config, d_feat=lg["d_feat"],
                              n_classes=lg["n_classes"])
    model = gnn.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 195), device=dev)
    params = T.params_of(model)
    state = opt.init(ocfg, params)
    rng = np.random.default_rng(args.seed + 196)
    sample_ms, rows = [], []
    for _ in range(PNA_STEPS):
        seeds = rng.choice(lg["graph_nodes"], lg["batch_nodes"],
                           replace=False)
        t1 = time.perf_counter()
        sub = sampler.sample_subgraph(rng, csr, seeds, lg["fanout"])
        sample_ms.append((time.perf_counter() - t1) * 1e3)
        b = {k: torch.from_numpy(v).to(dev) for k, v in sub.items()}
        r, params, state = _pna_steps(torch, np, gnn, cfg, params, state,
                                      ocfg, [b])
        rows.append(r)
    out["minibatch_lg"] = {
        "graph_nodes": lg["graph_nodes"], "graph_edges": lg["graph_edges"],
        "make_graph_s": make_s, "build_csr_s": csr_s,
        "subgraph_nodes": int(sub["feats"].shape[0]),
        "subgraph_edges": int(sub["edge_index"].shape[1]),
        "sampler_host_ms": sample_ms,
        "step_device_ms": [r["step_device_ms"][0] for r in rows],
        "step_host_wall_ms": [r["step_host_wall_ms"][0] for r in rows],
        "losses": [r["losses"][0] for r in rows]}
    del model, params, state, csr, sub, b
    torch.cuda.empty_cache()
    print("pna ogb_products: left out (one layer's edge tensors exceed the "
          "card's 80 GB: ROADMAP.md queue B (iii))")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"pna": out, "smi": smi}))
    launches = {"pna": {n: mod.launches for n, mod in kernel_mods.items()}}
    assert not any(launches["pna"].values()), launches
    return {"launches": launches, **out}

def _serve_cell(args, torch, np, dev, mesh, lds_per_s):
    """Phase 13a: the serve_query cell through sharded_search_fn. Returns
    (launches, readings)."""
    from repro_torch.core import distributed as dist_core
    from repro_torch.core import late_interaction as li
    from repro_torch.core import pruning
    from repro_torch.core import scan as scan_mod
    from repro_torch.kernels import quantized_maxsim as qm
    from repro_torch.parity import topk_mismatches

    t0 = _phase(f"13a. serve_query: {SERVE_QUERIES} queries x "
                f"{SERVE_DOCS} docs x {SERVE_MD} codes through "
                f"sharded_search_fn on one rank")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 300)
    codes = torch.empty((SERVE_DOCS, SERVE_MD), dtype=torch.uint8,
                        device=dev)
    for start in range(0, SERVE_DOCS, 1 << 18):
        n = min(1 << 18, SERVE_DOCS - start)
        base = torch.randint(0, K, (n, 1), generator=gen, device=dev)
        off = torch.randint(0, SERVE_WINDOW, (n, SERVE_MD), generator=gen,
                            device=dev)
        codes[start:start + n] = ((base + off) % K).to(torch.uint8)
    del base, off
    # doc-side top-p of a full 1024-patch page keeps keep_count(1024, 60)
    # = 615 patches; the 616th slot pads the row to a multiple of 8
    n_valid = pruning.keep_count(N_PATCHES, P)
    mask = (torch.arange(SERVE_MD, device=dev) < n_valid).expand(
        SERVE_DOCS, SERVE_MD).contiguous()
    ids = torch.arange(SERVE_DOCS, dtype=torch.int32, device=dev)
    q = torch.randn((SERVE_QUERIES, N_Q_PATCHES, DIM), generator=gen,
                    device=dev)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q_mask = torch.ones((SERVE_QUERIES, N_Q_PATCHES), dtype=torch.bool,
                        device=dev)                 # query_len 32, all valid
    cb = torch.randn((K, DIM), generator=gen, device=dev)
    cb = cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True)
    valid_slots = int(mask.sum())
    torch.cuda.synchronize()
    print(f"codes and masks drawn: {codes.numel() + mask.numel()} bytes, "
          f"{valid_slots / mask.numel():.3f} of the slots valid, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    search = dist_core.sharded_search_fn(mesh, ("data", "model"),
                                         k=SERVE_TOP_K)
    args_ = (q, q_mask, codes, mask, ids, cb)
    # the main path's run: counters from 0 just before, read just after
    qm.launches = 0
    torch.cuda.synchronize()
    pre_peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    top_s, top_i = search(*args_)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    first_peak = torch.cuda.max_memory_allocated() - held
    launches = qm.launches
    r = qm.launch_range_len(SERVE_QUERIES, SERVE_DOCS, dev)
    chunk = r * max(1, scan_mod.MAX_CANDIDATES
                    // (SERVE_QUERIES * min(SERVE_TOP_K, r)))
    want_launches = math.ceil(SERVE_DOCS / chunk)
    print(f"first search {first_s:.3f}s; quantized_maxsim launches "
          f"{launches} (expected {want_launches}: ranges of {r}, "
          f"{chunk} docs a launch)")
    assert launches == want_launches, "serve-cell launches off"
    assert tuple(top_s.shape) == (SERVE_QUERIES, SERVE_TOP_K)
    assert bool(torch.isfinite(top_s).all()) and bool((top_i >= 0).all())

    # the same search without the mesh: the same answer
    ref_s, ref_i = scan_mod.quantized_maxsim_topk(
        q, q_mask, codes, mask, cb, k=SERVE_TOP_K, doc_ids=ids)
    assert torch.equal(ref_s, top_s) and torch.equal(ref_i, top_i), \
        "sharded search differs from the unsharded scan"
    # the returned docs' scores by the plain version
    table = li.adc_table(q, cb).contiguous()
    qmf = q_mask.float().contiguous()
    rows = top_i.to(torch.int64)
    plain = qm.quantized_maxsim_plain(table, qmf, codes[rows], mask[rows])
    err = float((plain - top_s).abs().max())
    torch.testing.assert_close(top_s, plain, atol=QMAXSIM_TOL,
                               rtol=QMAXSIM_TOL)
    # a seeded sample of the other docs: none above the k-th score
    pick = torch.randperm(SERVE_DOCS, generator=gen,
                          device=dev)[:SERVE_SAMPLE]
    best = torch.full((SERVE_QUERIES,), float("-inf"), device=dev)
    blk = 256
    for start in range(0, SERVE_SAMPLE, blk):
        sel = pick[start:start + blk]
        sc = qm.quantized_maxsim_plain(table, qmf, codes[sel], mask[sel])
        inside = (sel[None, :, None] == rows[:, None, :]).any(dim=-1)
        best = torch.maximum(best, torch.where(inside, float("-inf"),
                                               sc).amax(dim=1))
    above = int((best > top_s[:, -1] + QMAXSIM_TOL).sum())
    print(f"top-{SERVE_TOP_K} == the unsharded scan; its scores within "
          f"{err:.2e} of the plain version; of {SERVE_SAMPLE} sampled docs "
          f"{above} queries have one above the {SERVE_TOP_K}-th score "
          f"(largest margin {float((best - top_s[:, -1]).max()):.3e})")
    assert above == 0, "a sampled doc scores above the k-th"

    walls = []
    for _ in range(SERVE_WALLS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        search(*args_)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    search(*args_)
    end_ev.record()
    end_ev.synchronize()
    device_ms = start_ev.elapsed_time(end_ev)
    search_flops = _flops_of(lambda: search(*args_))
    # the kernel alone: the sweep's launches, replayed from a CUDA graph
    all_valid = torch.ones(SERVE_DOCS, dtype=torch.bool, device=dev)

    def sweep():
        for start in range(0, SERVE_DOCS, chunk):
            qm.quantized_maxsim_topk_cuda(
                table, qmf, codes[start:start + chunk],
                mask[start:start + chunk], all_valid[start:start + chunk],
                k=SERVE_TOP_K, range_len=r)

    # the first launch's range lists against the plain version's on the
    # same 131,072 docs: scores within QMAXSIM_TOL, positions equal
    # outside near-ties (phase 3's rule)
    got = qm.quantized_maxsim_topk_cuda(
        table, qmf, codes[:chunk], mask[:chunk], all_valid[:chunk],
        k=SERVE_TOP_K, range_len=r)
    want = qm.quantized_maxsim_topk_plain(
        table, qmf, codes[:chunk], mask[:chunk], all_valid[:chunk],
        k=SERVE_TOP_K, range_len=r)
    torch.testing.assert_close(got[0], want[0], atol=QMAXSIM_TOL,
                               rtol=QMAXSIM_TOL)
    err = max(err, float((got[0] - want[0]).abs().max()))
    kk = got[0].shape[-1]
    g_s, g_p, w_s, w_p = (t.reshape(-1, kk) for t in (*got, *want))
    rows_off = (g_p != w_p).any(dim=1)
    bad = topk_mismatches(*(t[rows_off].cpu().numpy()
                            for t in (g_p, g_s, w_p, w_s)), QMAXSIM_TOL)
    assert not bad, f"serve-cell launch: positions {bad[:5]}"
    print(f"one launch ({chunk} docs, {g_s.shape[0]} range lists of {kk}) "
          f"== the plain version: scores within {err:.2e}, "
          f"{int(rows_off.sum())} lists reordered only within near-ties")
    del got, want, g_s, g_p, w_s, w_p, rows_off

    kernel_ms = _time_ms(torch, sweep, 1)
    plain_ms = _time_ms(torch, lambda: qm.quantized_maxsim_topk_plain(
        table, qmf, codes[:SERVE_PLAIN_DOCS], mask[:SERVE_PLAIN_DOCS],
        all_valid[:SERVE_PLAIN_DOCS], k=SERVE_TOP_K, range_len=r), 1)
    n_ranges = math.ceil(SERVE_DOCS / r)
    lists = SERVE_QUERIES * n_ranges * min(SERVE_TOP_K, r) * 8
    n_bytes, lookups = _qmaxsim_cost(table, qmf, codes, mask,
                                     all_valid.numel() + lists)
    bound, bound_by = _bound(n_bytes, lookups)
    lds_bound = lookups / lds_per_s * 1e3
    out = {"docs": SERVE_DOCS, "queries": SERVE_QUERIES,
           "kept_codes": SERVE_MD, "top_k": SERVE_TOP_K,
           "valid_slot_share": valid_slots / mask.numel(),
           "host_wall_ms_median": float(np.median(walls)),
           "host_wall_ms": walls, "device_ms": device_ms,
           "first_search_s": first_s, "launches": launches,
           "kernel_ms": kernel_ms, "kernel_plain_ms_16384_docs": plain_ms,
           "bound_ms": bound, "bound_by": bound_by,
           "lds_bound_ms": lds_bound, "bytes": n_bytes,
           "lookups": lookups, "max_abs_err": err,
           "range_len": r, "docs_per_launch": chunk,
           "codes_and_masks_bytes": codes.numel() + mask.numel(),
           "max_memory_allocated_gib":
               max(pre_peak, torch.cuda.max_memory_allocated()) / 2**30,
           "first_search_peak_above_held_bytes": first_peak,
           "flops": search_flops,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"sharded": {"serve_query": out}}))
    del codes, mask, ids, all_valid, plain, table
    torch.cuda.empty_cache()
    return launches, out


def _sharded_build(args, torch, np, dev, mesh, cfg, flat_codebook,
                   flat_hit):
    """Phase 13b: phase 4's corpus through Retriever.build(mesh=), shard
    and search. Returns (launches, readings)."""
    from repro_torch.core import quantization as quant
    from repro_torch.data.synthetic import CorpusSpec, make_retrieval_corpus
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import quantized_maxsim as qm
    from repro_torch.retrieval import Corpus, Query, Retriever

    t0 = _phase(f"13b. the flat build through Retriever.build(mesh=) over "
                f"{N_DOCS} docs, shard, search")
    spec = CorpusSpec(n_docs=N_DOCS, n_queries=N_REQUESTS,
                      n_patches=N_PATCHES, n_q_patches=N_Q_PATCHES, dim=DIM)
    data = make_retrieval_corpus(spec, seed=args.seed, device=dev)
    corpus = Corpus(data.doc_patches, data.doc_mask, data.doc_salience)
    queries = [Query(data.query_patches[i:i + MAX_BATCH],
                     data.query_mask[i:i + MAX_BATCH],
                     data.query_salience[i:i + MAX_BATCH])
               for i in range(0, N_REQUESTS, MAX_BATCH)]
    relevance = data.relevance.cpu().numpy()
    r = Retriever(cfg)
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: build, shard, serve every query
    km.launches = 0
    qm.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = r.build(torch.Generator(device=dev).manual_seed(args.seed + 1),
                    corpus, mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    sharded = r.shard(state, mesh)
    results = [r.search(sharded, qb, k=TOP_K) for qb in queries]
    torch.cuda.synchronize()
    launches = {"kmeans_assign": km.launches,
                "quantized_maxsim": qm.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"build {build_s:.2f}s, peak {peak:.2f} GiB; launches {launches} "
          f"(expected 1 kmeans_assign, {2 * len(queries)} "
          f"quantized_maxsim)")
    assert launches == {"kmeans_assign": 1,
                        "quantized_maxsim": 2 * len(queries)}, launches
    # codes: quantize under the same codebook
    codes = quant.quantize(corpus.embeddings, state.codebook,
                           code_dtype=torch.uint8)
    assert torch.equal(codes, state.rerank_codes), "build codes"
    del codes
    # mean inertia of the two codebooks over the training rows
    x = corpus.embeddings.reshape(-1, DIM)

    def inertia(cb):
        tot = 0.0
        for start in range(0, x.shape[0], 1 << 20):
            tot += float(quant.pairwise_sq_dists(
                x[start:start + (1 << 20)], cb).amin(dim=-1).sum())
        return tot / x.shape[0]

    i_mesh, i_flat = inertia(state.codebook), inertia(flat_codebook)
    hits = sum(int((relevance[b * MAX_BATCH + j][ids[ids >= 0]] > 0).any())
               for b, (_, idb) in enumerate(results)
               for j, ids in enumerate(idb.cpu().numpy()))
    hit = hits / N_REQUESTS
    want = r.search(state, queries[0], k=TOP_K)
    same = (torch.equal(want[0], results[0][0])
            and torch.equal(want[1], results[0][1]))
    print(f"codes == quantize under the codebook; mean inertia "
          f"{i_mesh:.6f} (phase 4's codebook {i_flat:.6f}); hit@{TOP_K} "
          f"{hit:.3f} (phase 4 {flat_hit:.3f}); shard + search == search: "
          f"{same}")
    assert i_mesh <= (1.0 + INERTIA_TOL) * i_flat, "inertia"
    assert hit >= 0.95 * flat_hit, "hit@10 of the sharded build"
    assert same, "shard + search differs from the unsharded search"
    out = {"build_s": build_s, "launches": launches,
           "inertia": i_mesh, "phase4_inertia": i_flat,
           "hit_at_10": hit, "phase4_hit_at_10": flat_hit,
           "kmeans_iters": cfg.kmeans_iters,
           "kmeans_restarts": cfg.kmeans_restarts,
           "e_step_block_rows": cfg.kmeans_minibatch,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"sharded": {"build": out}}))
    del data, corpus, x, state, sharded, results, want
    torch.cuda.empty_cache()
    return launches, out


def _world1_paths(args, torch, np, dev, mesh):
    """Phase 13c: a checkpoint restored onto the mesh, GPipe and the ring
    matmul at world size 1."""
    import tempfile
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import full_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import elastic
    from repro_torch.train.loop import make_pipelined_fn

    t0 = _phase("13c. restore_elastic, GPipe and the ring matmul at world "
                "size 1")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 310)
    tree = {"w": torch.randn((4096, 1024), generator=gen, device=dev),
            "codes": torch.randint(0, 512, (4096, SERVE_MD), generator=gen,
                                   device=dev, dtype=torch.int32
                                   ).to(torch.uint16),
            "h": torch.randn((1024, 1024), generator=gen,
                             device=dev).to(torch.bfloat16)}
    specs = {"w": ("batch", "mlp"), "codes": ("corpus", None),
             "h": (None, "mlp")}
    out_dir = ROOT / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="elastic_") as tmp:
        t1 = time.perf_counter()
        ck.save(tmp, 5, tree)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        step, got = elastic.restore_elastic(
            tmp, {k: torch.zeros_like(v) for k, v in tree.items()}, specs,
            mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
    assert step == 5
    for key, v in tree.items():
        assert got[key].device_mesh == mesh
        assert got[key].to_local().device.type == dev.type
        assert torch.equal(full_tensor(got[key]), v), key
    pipe = make_host_mesh((1,), ("pipe",), device=dev)
    ws = torch.randn((1, 1024, 1024), generator=gen, device=dev) / 32.0
    xp = torch.randn((GPIPE_MICRO * 64, 1024), generator=gen, device=dev)
    y = make_pipelined_fn(pipe, lambda sp, x: torch.tanh(x @ sp["w"]),
                          GPIPE_MICRO)({"w": ws}, xp)
    gpipe_err = float((y - torch.tanh(xp @ ws[0])).abs().max())
    ring = make_host_mesh((1,), ("model",), device=dev)
    xr = torch.randn((2048, 1024), generator=gen, device=dev)
    wr = torch.randn((1024, 4096), generator=gen, device=dev)
    ring_err = float((collectives.ring_allgather_matmul(ring, "model")(
        xr, wr) - xr @ wr).abs().max())
    print(f"restore_elastic: step {step}, 3 leaves (float32, uint16, "
          f"bfloat16) bit for bit as DTensors; save {save_s:.2f}s, restore "
          f"{restore_s:.2f}s; GPipe (1 stage, {GPIPE_MICRO} microbatches) "
          f"max err {gpipe_err:.2e}; ring matmul max err {ring_err:.2e}")
    assert gpipe_err <= 1e-4 and ring_err == 0.0
    out = {"save_s": save_s, "restore_s": restore_s,
           "gpipe_max_abs_err": gpipe_err, "ring_max_abs_err": ring_err,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"sharded": {"world1": out}}))
    return out


def _counted(torch, kernel_mods, fn):
    """(fn(), the kernels' launches in it), the counters at 0 just
    before."""
    for mod in kernel_mods.values():
        mod.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: mod.launches for n, mod in kernel_mods.items()}


def _held(torch, got, want, exact, what):
    """Batches of (scores, ids) held to others: bit for bit when
    ``exact``, else scores within QMAXSIM_TOL and ids outside near-ties;
    -> ids differing (within near-ties) over the batches."""
    from repro_torch.parity import topk_mismatches
    diff = 0
    for (gs, gi), (ws, wi) in zip(got, want):
        if exact:
            assert torch.equal(gs, ws) and torch.equal(gi, wi), what
            continue
        torch.testing.assert_close(gs, ws, atol=QMAXSIM_TOL,
                                   rtol=QMAXSIM_TOL, msg=what)
        g_i, g_s, w_i, w_s = (t.cpu().numpy() for t in (gi, gs, wi, ws))
        bad = topk_mismatches(g_i, g_s, w_i, w_s, QMAXSIM_TOL)
        assert not bad, f"{what}: ids differ outside near-ties {bad}"
        diff += int((g_i != w_i).sum())
    return diff


def _sharded_backends(args, torch, np, dev, smi, mesh, paths, queries,
                      kernel_mods):
    """Phase 13d, run after phase 8 while its states live, in a one-rank
    NCCL group of its own: every backend searched from a state that
    ``Retriever.shard`` placed on a (1, 1) mesh. ``paths`` maps a name to
    (retriever, unsharded state, whether its answer is a sweep's alone).
    Each path's 64 requests run in batches of 8 through
    ``Retriever.search`` (a cascade's through every ``search_degraded``
    rung too) with the launch counters at 0 just before, and the launches
    are held equal to the unsharded search's. Each batch is held to the
    unsharded search of the same state: a sweep's answer (shape (a): the
    same kernels at the same shapes at world size 1) and the cascade's
    floor bit for bit; where a pool is scored by the full-score kernel
    (shape (b)), scores within 1e-4 and ids outside near-ties. The sweep
    stage alone (a backend's own search; a cascade's stage 1) is held
    bit for bit as well. Then one batch's host wall (median of 9) and
    device time (a CUDA-graph replay; hnsw's walk syncs on its data, so
    CUDA events around 3 calls), sharded beside unsharded, and the bytes
    the placement added. Returns the launches by path and the
    readings."""
    import gc

    import torch.distributed as dist
    from repro_torch.retrieval import Query

    t0 = _phase("13d. every backend searched from a sharded state (a "
                "one-rank NCCL group of its own)")
    gc.collect()
    held_at_start = torch.cuda.memory_allocated()
    qs = [Query(*(torch.from_numpy(a[lo:lo + MAX_BATCH]).to(dev)
                  for a in queries))
          for lo in range(0, N_REQUESTS, MAX_BATCH)]

    def counted(fn):
        return _counted(torch, kernel_mods, fn)

    def held(got, want, exact, what):
        return _held(torch, got, want, exact, what)

    def readings(fn, graph):
        walls = []
        for _ in range(9):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        return {"host_wall_ms": float(np.median(walls)),
                "device_ms": (_time_ms(torch, fn, 3) if graph
                              else _event_ms(torch, fn, 3)),
                "device_time_from": "cuda graph" if graph else "cuda events"}

    out, launches = {}, {}
    for name, (r, state, sweep_only) in paths.items():
        t1 = time.perf_counter()
        gc.collect()                # earlier phases' cycles, not this one's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        sharded = r.shard(state, mesh)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - held_before
        rungs = r.degrade_rungs(state, k=TOP_K)
        assert rungs == r.degrade_rungs(sharded, k=TOP_K)

        def search(st):
            return [r.search(st, qb, k=TOP_K) for qb in qs]

        def degraded(st):
            return [[r.search_degraded(st, qb, k=TOP_K, rung=rung)
                     for qb in qs] for rung in rungs]

        # the main path's run: every batch (and every rung) from the
        # placed state
        got, n_got = counted(lambda: search(sharded))
        got_r, n_got_r = counted(lambda: degraded(sharded))
        want, n_want = counted(lambda: search(state))
        want_r, n_want_r = counted(lambda: degraded(state))
        assert n_got == n_want and sum(n_got.values()) > 0, \
            (name, n_got, n_want)
        assert n_got_r == n_want_r, (name, n_got_r, n_want_r)
        diff = held(got, want, sweep_only, f"13d {name}")
        for rung, g, w in zip(rungs, got_r, want_r):
            diff += held(g, w, rung is None, f"13d {name} rung {rung}")
        # the sweep stage alone, bit for bit
        be = r.backend
        if be.name == "cascade":
            (hb, hv), _, _ = be._views(sharded)
            (_, hv_l), _, _ = be._views(state)
            p1 = state.backend_state.p1
            held([hb.search(hv, qb, k=p1) for qb in qs],
                 [hb.search(hv_l, qb, k=p1) for qb in qs], True,
                 f"13d {name} stage 1")
        elif be.name in ("flat", "hamming", "float_flat"):
            n_cand = max(TOP_K, r.cfg.rerank)
            held([be.search(sharded, qb, k=n_cand) for qb in qs],
                 [be.search(state, qb, k=n_cand) for qb in qs], True,
                 f"13d {name} sweep")
        per_batch = {n: v / len(qs) for n, v in n_got.items() if v}
        per_rung = [{n: v / len(qs) for n, v in counted(
            lambda: [r.search_degraded(sharded, qb, k=TOP_K, rung=rung)
                     for qb in qs])[1].items() if v} for rung in rungs]
        graph = be.name != "hnsw"
        times = {"sharded": readings(lambda: r.search(sharded, qs[0],
                                                      k=TOP_K), graph),
                 "local": readings(lambda: r.search(state, qs[0], k=TOP_K),
                                   graph)}
        out[name] = {"launches": n_got, "launches_per_batch": per_batch,
                     "batches": len(qs), "rung_launches": n_got_r,
                     "rung_launches_per_batch": dict(zip(
                         map(str, rungs), per_rung)),
                     "ids_differing_within_near_ties": diff,
                     "placed_bytes": placed,
                     "max_memory_allocated_gib":
                         torch.cuda.max_memory_allocated() / 2**30,
                     "one_batch": times,
                     "seconds": time.perf_counter() - t1}
        launches[f"sharded {name}"] = {n: v + n_got_r[n]
                                       for n, v in n_got.items()}
        sh, lo = times["sharded"], times["local"]
        print(f"{name}: {len(qs)} batches + {len(rungs)} rungs x "
              f"{len(qs)} == unsharded ({'bit for bit' if sweep_only else 'within 1e-4'}; "
              f"{diff} ids differ within near-ties) | launches per batch "
              f"{per_batch}, per rung's batch {per_rung} | one batch: host "
              f"wall {sh['host_wall_ms']:.3f}"
              f" ms sharded, {lo['host_wall_ms']:.3f} local; device "
              f"{sh['device_ms']:.3f} / {lo['device_ms']:.3f} ms "
              f"({sh['device_time_from']}) | placement added "
              f"{placed / 2**30:.2f} GiB")
        del sharded, got, got_r, want, want_r
    del qs
    gc.collect()
    torch.cuda.empty_cache()
    held_at_end = torch.cuda.memory_allocated()
    print(f"allocated on the card: {held_at_start / 2**30:.3f} GiB before "
          f"13d, {held_at_end / 2**30:.3f} GiB after (every placed copy "
          f"freed)")
    # a placed copy is GBs; the margin is for the group's own buffers
    assert held_at_end <= held_at_start + 2**28, "a placed copy outlived 13d"
    out["group"] = dist.get_backend()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"sharded_backends": out, "smi": smi}))
    print(f"phase 13d {out['seconds']:.1f}s")
    return {"launches": launches, "readings": out}


def _all_placed(state, mesh, what):
    """Every tensor of ``state`` a DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.retrieval.base import state_map
    leaves = []
    state_map(leaves.append, state)
    bad = [tuple(x.shape) for x in leaves
           if not isinstance(x, DTensor) or x.device_mesh != mesh]
    assert not bad, f"{what}: tensors not placed on the mesh: {bad}"


def _placed_live_phase(args, torch, np, dev, smi, mesh, live, flat, casc,
                       queries, relevance, kernel_mods):
    """Phase 13g, right after 13d in its one-rank NCCL group: phase 7's
    live cascade and phase 7's mutation of phase 4's flat state run from
    states that ``Retriever.shard`` placed on the (1, 1) mesh, and phase
    5's serving readings placed beside unplaced.

    (a) phase 7's base cascade (docs 0-14335, kept from phase 7) placed
    and served through ``LiveIndexSession`` with phase 7's schedule
    (``_live_rounds``): every response held to phase 7's (scores within
    MAXSIM_TOL, ids outside near-ties: stage 3 scores a pool, 13d's rule),
    the launches equal to what the batches served imply, one batch's equal
    to the unplaced state's, every tensor still placed after each
    mutation; then ``compact``, one batch held to phase 7's state before
    its compaction. (b) phase 4's flat state placed, phase 7's 2048 docs
    added under fresh ids and its 512 ids deleted, then compacted: every
    batch held to the same mutations of the unplaced state (the sweep bit
    for bit, the rerank's pool within QMAXSIM_TOL with ids outside
    near-ties), launches equal. (c) phase 5's cascade state served as
    phase 5 serves it (``serve_state``: every rung warmed, then
    N_REQUESTS requests), unplaced, placed, placed, unplaced. Returns the
    launches by path and the readings."""
    from repro_torch.launch.serve import serve_state
    from repro_torch.parity import topk_mismatches
    from repro_torch.retrieval import Query
    from repro_torch.serving import (LiveIndexSession, ResilienceConfig,
                                     ServeConfig)

    t0 = _phase("13g. phase 7's live cascade and mutated flat path from "
                "placed states; phase 5's serving placed beside unplaced")
    out, launches = {}, {}
    qs = [Query(*(torch.from_numpy(a[lo:lo + MAX_BATCH]).to(dev)
                  for a in queries))
          for lo in range(0, N_REQUESTS, MAX_BATCH)]

    # (a) the live cascade from a placed state
    t1 = time.perf_counter()
    r = live["retriever"]
    sess = LiveIndexSession(r, r.shard(live["base"], mesh), ServeConfig(
        max_batch=MAX_BATCH, top_k=TOP_K, guard_recompiles=True,
        resilience=ResilienceConfig(**LIVE_RESILIENCE)), device=dev)
    sess.warm_shapes(*(a[0] for a in queries))
    rounds = _live_rounds(torch, np, r, sess, queries, live["delta"],
                          live["upsert"], live["dead"], kernel_mods)
    assert rounds["launches"] == rounds["expect"], \
        ("placed live cascade launches off", rounds["launches"],
         rounds["expect"])
    _all_placed(sess.state, mesh, "13g live cascade")
    want = {qi: res for _, qi, res in live["responses"]}
    n_diff = 0
    for _, qi, res in rounds["responses"]:
        (gs, gi), (ws, wi) = res, want[qi]
        assert res.level == 0
        np.testing.assert_allclose(gs, ws, atol=MAXSIM_TOL, rtol=MAXSIM_TOL)
        bad = topk_mismatches(gi[None], gs[None], wi[None], ws[None],
                              MAXSIM_TOL)
        assert not bad, f"13g: query {qi} differs from phase 7 at {bad}"
        n_diff += int((gi != wi).sum())
    got, n_got = _counted(torch, kernel_mods,
                          lambda: r.search(sess.state, qs[0], k=TOP_K))
    ref, n_ref = _counted(torch, kernel_mods,
                          lambda: r.search(live["state"], qs[0], k=TOP_K))
    assert n_got == n_ref, ("13g one batch's launches", n_got, n_ref)
    n_diff += _held(torch, [got], [ref], False, "13g before compaction")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sess.compact()
    torch.cuda.synchronize()
    rounds["mut_s"]["compact"] = time.perf_counter() - t2
    _all_placed(sess.state, mesh, "13g compacted live cascade")
    n_diff += _held(torch, [r.search(sess.state, qs[0], k=TOP_K)], [ref],
                    False, "13g after compaction")
    sess.close()
    st = rounds["stats"]
    out["live_cascade"] = {
        "launches": rounds["launches"], "batches": rounds["batches"],
        "phase7_launches": live["launches"],
        "ids_differing_within_near_ties": n_diff,
        "window_qps": st["qps"], "serving_qps":
            N_REQUESTS / sum(rounds["round_s"]),
        "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
        "phase7_window": live["window"],
        "mutation_s": rounds["mut_s"], "phase7_mutation_s": live["mut_s"],
        "seconds": time.perf_counter() - t1}
    launches["placed live cascade"] = rounds["launches"]
    print(f"live cascade placed: {N_REQUESTS} requests in "
          f"{rounds['batches']} batches == phase 7's responses (scores "
          f"within {MAXSIM_TOL}; {n_diff} ids differ within near-ties) | "
          f"launches {rounds['launches']} (phase 7 {live['launches']}) | "
          f"serving QPS {out['live_cascade']['serving_qps']:.1f} (phase 7 "
          f"{live['window']['qps']:.1f}), p50 {st['p50_ms']:.2f} ms, p99 "
          f"{st['p99_ms']:.2f} (phase 7 {live['window']['p50_ms']:.2f}, "
          f"{live['window']['p99_ms']:.2f}) | mutations {rounds['mut_s']} s "
          f"(phase 7 {live['mut_s']})")
    del sess, rounds, got, ref

    # (b) phase 7's mutation of phase 4's flat state, placed
    t1 = time.perf_counter()
    fr, fs = flat
    mut_s = {}

    def mutate(st, key):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st = fr.add(st, live["delta"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        st = fr.delete(st, live["dead"])
        torch.cuda.synchronize()
        mut_s[key] = {"add": t3 - t2, "delete": time.perf_counter() - t3}
        return st

    local, n_local = _counted(torch, kernel_mods,
                              lambda: mutate(fs, "unplaced"))
    placed, n_mut = _counted(torch, kernel_mods, lambda: mutate(
        fr.shard(fs, mesh), "placed"))
    assert n_mut == n_local, ("13g flat mutation launches", n_mut, n_local)
    launches["placed flat mutations"] = n_mut
    n_diff, n_flat = 0, {}
    for step in ("mutated", "compacted"):
        if step == "compacted":
            local, placed = fr.compact(local), fr.compact(placed)
        _all_placed(placed, mesh, f"13g flat {step}")
        got, n_got = _counted(torch, kernel_mods, lambda: [
            fr.search(placed, qb, k=TOP_K) for qb in qs])
        want_, n_want = _counted(torch, kernel_mods, lambda: [
            fr.search(local, qb, k=TOP_K) for qb in qs])
        n_seg = len(fr.backend._segmented(placed).live)
        assert n_got == n_want and n_got["quantized_maxsim"] == \
            len(qs) * (n_seg + 1), (step, n_got, n_want)
        n_diff += _held(torch, got, want_, False, f"13g flat {step}")
        n_cand = max(TOP_K, fr.cfg.rerank)
        _held(torch, [fr.backend.search(placed, qb, k=n_cand) for qb in qs],
              [fr.backend.search(local, qb, k=n_cand) for qb in qs], True,
              f"13g flat {step} sweep")
        n_flat[step] = n_got
        launches[f"placed flat {step}"] = n_got
    out["flat"] = {"launches": n_flat, "mutation_s": mut_s,
                   "ids_differing_within_near_ties": n_diff,
                   "seconds": time.perf_counter() - t1}
    print(f"flat placed: {N_DOCS - N_BASE} added, {N_DEAD} deleted, then "
          f"compacted: {len(qs)} batches each == unplaced (sweep bit for "
          f"bit; {n_diff} ids differ within near-ties), launches {n_flat} "
          f"| mutation seconds {mut_s}")
    del local, placed, got, want_

    # (c) phase 5's serving, placed beside unplaced
    t1 = time.perf_counter()
    cr, cs = casc
    placed = cr.shard(cs, mesh)
    serving = {"unplaced": [], "placed": []}
    hits = set()
    for name in ("unplaced", "placed", "placed", "unplaced"):
        run = serve_state(cr, placed if name == "placed" else cs, queries,
                          relevance, n_requests=N_REQUESTS,
                          max_batch=MAX_BATCH, top_k=TOP_K, device=dev)
        serving[name].append({k: run.stats[k] for k in (
            "qps", "p50_ms", "p99_ms", "mean_batch")})
        hits.add(run.hit_rate)
    assert len(hits) == 1, f"placed and unplaced serving differ: {hits}"
    del placed, run
    torch.cuda.empty_cache()
    out["serving"] = {**serving, "hit_rate": hits.pop(),
                      "seconds": time.perf_counter() - t1}
    for name, runs in serving.items():
        print(f"phase 5's cascade served {name} (two runs, unplaced and "
              f"placed in turns): QPS {[r['qps'] for r in runs]}, p50 "
              f"{[r['p50_ms'] for r in runs]} ms, p99 "
              f"{[r['p99_ms'] for r in runs]} ms | {smi}")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"placed_live": out, "smi": smi}))
    print(f"phase 13g {out['seconds']:.1f}s")
    return {"launches": launches, "readings": out}


def _f5_start():
    """Phase 13f, started in the background: two gloo ranks on the
    host's CPU (``tests/_torch_dist_ranks.py``'s ``f5`` suite) holding
    attention with kv heads sharded at model = 2 to the port's own
    unplaced run under this host's PyTorch. Returns (processes, their
    directory, start time, a list that gets the time both ended)."""
    import os
    import threading
    work = ROOT / "build" / "f5_ranks"
    work.mkdir(parents=True, exist_ok=True)
    for old in work.iterdir():
        old.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
         str(rank), "2", str(work), "f5"], env=env,
        stdout=open(work / f"log{rank}.txt", "w"), stderr=subprocess.STDOUT)
        for rank in range(2)]
    ended = []

    def watch():
        while any(p.poll() is None for p in procs):
            time.sleep(0.5)
        ended.append(time.perf_counter())

    threading.Thread(target=watch, daemon=True).start()
    return procs, work, time.perf_counter(), ended


def _f5_finish(started, smi) -> dict:
    """Phase 13f's result: both ranks exited 0 and wrote "ok" for every
    case, within F5_TIMEOUT of their start; every process stopped."""
    procs, work, t0, ended = started
    _phase("13f. F5: attention with kv heads sharded at model = 2, two "
           "gloo ranks on the host's CPU under its PyTorch (the host's "
           "PyTorch is under test here, not the card)")
    import torch
    try:
        for p in procs:
            p.wait(timeout=max(1.0, F5_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [json.loads((work / f"rank{r}.json").read_text())
           if (work / f"rank{r}.json").exists() else {} for r in range(2)]
    if not (all(p.returncode == 0 for p in procs) and all(
            r and all(v == "ok" for v in r.values()) for r in res)):
        for r in range(2):
            print((work / f"log{r}.txt").read_text()[-3000:])
        raise AssertionError(f"13f failed: {res}")
    while not ended:                  # the watcher's last poll
        time.sleep(0.1)
    out = {"torch": torch.__version__, "cases": sorted(res[0]),
           "seconds": ended[0] - t0}
    print(json.dumps({"f5": out, "smi": smi}))
    print(f"phase 13f: {out['cases']} ok on 2 gloo ranks under torch "
          f"{torch.__version__} in {out['seconds']:.1f}s, in the "
          f"background of phases 9-13e")
    return out


def _model_sharding_phase(args, torch, np, dev, smi, kernel_mods):
    """Phase 13e: model-internal sharding at world size 1, in a one-rank
    NCCL group of its own and a (1, 1) mesh. (a) the full-width encoder
    over MS_PAGES pages and MS_QUERIES queries, unsharded and then with
    its weights placed (``transformer.shard_module``) and the pages on
    "batch"; the placed embeddings, taken whole, are indexed by the flat
    backend and searched, so ``kmeans_assign`` and ``quantized_maxsim``
    run on the sharded path's output (launches counted from 0). (b) phase
    11a's 1-layer llama4-scout cut: prefill and MOE_CUT_DECODE greedy
    steps, unsharded, then placed in place (each leaf's whole copy freed
    as its placement is made) with placed caches. (c) dcn-v2's train_batch
    step and (d) PNA's full_graph_sm step from ``launch.cells.build_cell``
    without and with the mesh. Each placed result is held to the
    unsharded one and reported with its largest difference (0 where the
    ops are the same); each pair's host wall and device time (CUDA events
    around the call) are printed. Nothing here is caught. Returns the
    launches by path and the readings."""
    import dataclasses
    import gc

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.configs.colpali_hpc import COLPALI_HPC
    from repro_torch.configs.lm_archs import LLAMA4_SCOUT
    from repro_torch.dist.sharding import Sharder, full_tensor, shard_tree
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh, open_local_group
    from repro_torch.models import colpali
    from repro_torch.models import transformer as T
    from repro_torch.retrieval import Corpus, Query, Retriever

    t0 = _phase("13e. model-internal sharding at world size 1 (a one-rank "
                "NCCL group of its own)")
    gc.collect()
    torch.cuda.empty_cache()
    held_at_start = torch.cuda.memory_allocated()
    group = open_local_group(dev)
    mesh = make_host_mesh((1, 1), ("data", "model"), device=dev)
    shd = Sharder(mesh)
    out, launches = {}, {}

    def zero():
        for mod in kernel_mods.values():
            mod.launches = 0

    def counts():
        return {n: mod.launches for n, mod in kernel_mods.items()}

    def timed(fn):
        """(result, host wall ms, device ms) of one call."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, (time.perf_counter() - t1) * 1e3, start.elapsed_time(end)

    def diff(got, want):
        got = full_tensor(got)
        assert not isinstance(got, DTensor) and got.shape == want.shape
        return float((got.float() - want.float()).abs().max())

    def held(name, pairs, tol):
        """{what: largest difference}, each within tol relative to the
        unsharded value (and absolute for small ones)."""
        res = {}
        for what, (got, want) in pairs.items():
            d = diff(got, want)
            scale = max(1.0, float(want.float().abs().max()))
            assert d <= tol * scale, f"13e {name} {what}: {d} > {tol}"
            res[what] = d
        return res

    def record(name, walls, errs, **extra):
        (w0, d0), (w1, d1) = walls
        out[name] = {"unsharded": {"host_wall_ms": w0, "device_ms": d0},
                     "sharded": {"host_wall_ms": w1, "device_ms": d1},
                     "max_abs_diff": errs,
                     "bit_for_bit": sorted(k for k, v in errs.items()
                                           if v == 0.0), **extra}
        print(f"13e {name}: sharded == unsharded (largest differences "
              f"{errs}) | host wall {w1:.1f} ms sharded, {w0:.1f} ms "
              f"unsharded; device {d1:.1f} / {d0:.1f} ms (cuda events) "
              f"| {smi}")

    # -- (a) the encoder, its placed output indexed and searched -----------
    arch = COLPALI_HPC.config
    enc_cfg = arch.encoder
    enc = colpali.init(enc_cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 131), device=dev)
    pg = torch.Generator(dev).manual_seed(args.seed + 132)
    pages = torch.randn((MS_PAGES, enc_cfg.n_patches, enc_cfg.d_patch),
                        generator=pg, device=dev)
    mask = torch.ones((MS_PAGES, enc_cfg.n_patches), dtype=torch.bool,
                      device=dev)
    q_tok = torch.randint(0, enc_cfg.backbone.vocab,
                          (MS_QUERIES, enc_cfg.query_len), generator=pg,
                          device=dev)
    q_mask = torch.ones_like(q_tok, dtype=torch.bool)
    enc.encode_doc(pages[:1], mask[:1])               # cuBLAS set-up
    (e0, s0), w0, d0 = timed(lambda: enc.encode_doc(pages, mask))
    q0, qs0 = enc.encode_query(q_tok, q_mask)
    T.shard_module(enc, shd, colpali.param_specs(enc_cfg))
    d_pages = shard_tree(shd, ("batch", None, None), pages)
    d_mask = shard_tree(shd, ("batch", None), mask)
    enc.encode_doc(d_pages[:1], d_mask[:1], shd=shd)
    (e1, s1), w1, d1 = timed(lambda: enc.encode_doc(d_pages, d_mask,
                                                    shd=shd))
    q1, qs1 = enc.encode_query(shard_tree(shd, ("batch", None), q_tok),
                               shard_tree(shd, ("batch", None), q_mask),
                               shd=shd)
    errs = held("encoder", {"doc_embeddings": (e1, e0),
                            "doc_salience": (s1, s0),
                            "query_embeddings": (q1, q0),
                            "query_salience": (qs1, qs0)},
                MS_TOL)
    del enc
    gc.collect()
    torch.cuda.empty_cache()
    emb, sal = full_tensor(e1), full_tensor(s1)   # whole: kernels read them
    retriever = Retriever(arch.hpc)
    zero()
    state = retriever.build(torch.Generator(dev).manual_seed(args.seed + 133),
                            Corpus(emb, torch.ones_like(sal, dtype=torch.bool),
                                   sal))
    torch.cuda.synchronize()
    launches["13e sharded encoder build"] = counts()
    assert launches["13e sharded encoder build"]["kmeans_assign"] >= 1, \
        launches
    query = Query(full_tensor(q1), q_mask, full_tensor(qs1))
    zero()
    got_s, got_i = retriever.search(state, query, k=TOP_K)
    torch.cuda.synchronize()
    launches["13e sharded encoder search"] = counts()
    assert launches["13e sharded encoder search"]["quantized_maxsim"] == 2, \
        launches
    want_s, want_i = retriever.search(state, Query(q0, q_mask, qs0),
                                      k=TOP_K)
    torch.testing.assert_close(got_s, want_s, atol=QMAXSIM_TOL,
                               rtol=QMAXSIM_TOL)
    assert bool(torch.isfinite(got_s).all()) and got_i.shape == (
        MS_QUERIES, TOP_K)
    record("encoder", ((w0, d0), (w1, d1)), errs, pages=MS_PAGES,
           queries=MS_QUERIES,
           search_ids_equal_to_unsharded_queries=bool(
               torch.equal(got_i, want_i)))
    del e0, s0, e1, s1, q0, qs0, q1, qs1, emb, sal, state, pages, d_pages
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the 1-layer llama4-scout cut: prefill and decode ---------------
    cfg = dataclasses.replace(LLAMA4_SCOUT.config, n_layers=1,
                              activation_dtype="float32")
    model = T.init(cfg, generator=torch.Generator(dev).manual_seed(
        args.seed + 134), device=dev)
    b, s = MOE_CUT_PROMPT
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator(
        dev).manual_seed(args.seed + 135), device=dev)
    max_len = s + MOE_CUT_DECODE
    (lg0, c0), w0, d0 = timed(lambda: T.prefill(model, prompt, max_len))
    feeds, want = [], [lg0]
    for i in range(MOE_CUT_DECODE):
        feeds.append(torch.argmax(want[-1], -1).to(torch.int32))
        lg, c0 = T.decode_step(model, feeds[-1], c0, s + i)
        want.append(lg)
    placed_before = torch.cuda.memory_allocated()
    T.shard_module(model, shd, T.param_specs(cfg))
    torch.cuda.synchronize()
    placement_bytes = torch.cuda.memory_allocated() - placed_before
    dp = shard_tree(shd, ("batch", None), prompt)
    (lg1, c1), w1, d1 = timed(lambda: T.prefill(model, dp, max_len,
                                                shd=shd))
    pairs = {"prefill_logits": (lg1, lg0), "cache_k": (c1.k, c0.k),
             "cache_v": (c1.v, c0.v)}
    for i, feed in enumerate(feeds):
        lg, c1 = T.decode_step(model, shard_tree(shd, ("batch",), feed), c1,
                               s + i, shd=shd)
        pairs[f"decode_{i}_logits"] = (lg, want[i + 1])
    errs = held("llama4-scout 1-layer cut", pairs, MS_TOL)
    record("scout_cut", ((w0, d0), (w1, d1)), errs, prompt=[b, s],
           decode_steps=MOE_CUT_DECODE, placement_added_bytes=placement_bytes)
    del model, c0, c1, lg0, lg1, want, pairs, lg
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c, d) dcn-v2's and PNA's train steps through the cell builder ----
    for name, arch_id, cell_name in (("dcn_train", "dcn-v2", "train_batch"),
                                     ("pna_full_graph_sm", "pna",
                                      "full_graph_sm")):
        spec = registry.get(arch_id)
        cell = next(c for c in spec.shapes if c.name == cell_name)
        built = cells.build_cell(spec, cell, None, device=dev, fake=False,
                                 seed=args.seed + 136)
        (p0, _, m0), w0, d0 = timed(lambda: built.fn(*built.args))
        del built
        gc.collect()
        torch.cuda.empty_cache()
        built = cells.build_cell(spec, cell, mesh, device=dev, fake=False,
                                 seed=args.seed + 136)
        assert all(isinstance(v, DTensor) for v in built.args[0].values())
        (p1, _, m1), w1, d1 = timed(lambda: built.fn(*built.args))
        errs = held(name, {"loss": (m1["loss"], m0["loss"])}, MS_TOL)
        errs.update(held(name, {"grad_norm": (m1["grad_norm"],
                                              m0["grad_norm"])},
                         MS_GNORM_TOL))
        errs["params"] = max(held(name, {k: (p1[k], p0[k]) for k in p0},
                                  MS_PARAM_TOL).values())
        record(name, ((w0, d0), (w1, d1)), errs,
               placements_recorded=sorted(built.placements))
        del built, p0, p1, m0, m1
        gc.collect()
        torch.cuda.empty_cache()

    dist.destroy_process_group()
    held_at_end = torch.cuda.memory_allocated()
    assert held_at_end <= held_at_start + 2**28, "a 13e model outlived it"
    out["group"] = group
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"model_sharding": out, "smi": smi}))
    print(f"phase 13e {out['seconds']:.1f}s")
    return {"launches": launches, "readings": out}


def _sharded_phase(args, torch, np, dev, cfg, flat_codebook, flat_hit,
                   lds_per_s):
    """Phase 13: a one-rank NCCL group and a (1, 1) ("data", "model")
    mesh; 13a, 13b, 13c. Returns the launches by path and the readings."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, open_local_group

    t0 = _phase("13. distribution: a one-rank NCCL group")
    backend = open_local_group(dev)
    mesh = make_host_mesh((1, 1), ("data", "model"), device=dev)
    print(f"process group: {backend}, world size {dist.get_world_size()}; "
          f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
          f"{mesh.device_type}")
    serve_launches, serve = _serve_cell(args, torch, np, dev, mesh,
                                        lds_per_s)
    build_launches, build = _sharded_build(args, torch, np, dev, mesh, cfg,
                                           flat_codebook, flat_hit)
    world1 = _world1_paths(args, torch, np, dev, mesh)
    dist.destroy_process_group()
    print(f"phase 13 {time.perf_counter() - t0:.1f}s")
    return {"launches": {"serve_query (sharded)":
                         {"quantized_maxsim": serve_launches},
                         "sharded build": build_launches},
            "serve": serve, "build": build, "world1": world1}


def _card_cells(recsys_out, pna, sharded):
    """The cells phases 12-13 ran at their registry shapes, with what each
    measured: (arch, shape, config changes, how it held its memory,
    measured peak bytes, measured FLOPs). ``_HELD`` says what each
    accounting adds to the dry run's peak."""
    c = recsys_out["cells"]
    gib = 2 ** 30
    serve_query = sharded["serve"]

    def cli(arch):
        tr = c[arch]["train"]
        return (arch, "train_batch", {}, "cli",
                tr["peak_memory_gib"] * gib, tr["flops"])

    def serve(arch, shape, changes=None):
        r = c[arch][shape]
        return (arch, shape, changes or {}, "serve", r["peak_bytes"],
                r["flops"])

    return [
        cli("dcn-v2"), serve("dcn-v2", "serve_bulk"),
        serve("dcn-v2", "retrieval_cand"),
        serve("dlrm-mlperf", "serve_bulk", {"param_dtype": "bfloat16"}),
        cli("din"), cli("dien"), serve("dien", "serve_bulk"),
        *[("pna", shape, {}, "steps", pna[shape]["peak_above_held_bytes"],
           pna[shape]["flops"]) for shape in ("full_graph_sm", "molecule")],
        ("colpali-hpc", "serve_query", {}, "serve",
         serve_query["first_search_peak_above_held_bytes"],
         serve_query["flops"]),
    ]


# What a phase's measurement held beside the step, in the dry run's terms
# (args = params + optimizer state + batch for a train step; "temp" = the
# peak above the arguments):
#   serve: the params and the batch were held before the call: temp;
#   cli:   launch.train held nothing before it and, from the second step
#          on, keeps the model's initial weights beside the loop's params
#          and up to PREFETCH_BATCHES device batches in its pipeline:
#          args + params + temp + PREFETCH_BATCHES x batch;
#   steps: the model's params and the batches were held; the optimizer
#          state and, from the second step on, the loop's params came
#          after: args - batch + temp.
_HELD = {
    "serve": lambda m: m["temp_bytes"],
    "cli": lambda m: (m["argument_bytes"] + m["argument_bytes_each"][0]
                      + m["temp_bytes"]
                      + PREFETCH_BATCHES * m["argument_bytes_each"][2]),
    "steps": lambda m: (m["argument_bytes"] - m["argument_bytes_each"][2]
                        + m["temp_bytes"]),
}


def _fresh_registers(torch):
    """Registers per thread of each kernel source, from a build's ptxas
    lines: this run's build, or a fresh compile under build/ when the
    library came from an earlier run."""
    import tempfile
    from repro_torch.kernels import _build
    if _build.last_build.get("compiled"):
        return _build.registers(), "this run's build"
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log = _build._compile(_build._sources(), Path(tmp) / _build.LIB_NAME)
    return _build.registers(log), "a fresh compile"


def _launch_checks(torch, dev, kernel_mods):
    """14b: the launched shapes' geometry against the library's, PAL01-04
    at the sites and launched shapes, PAL03 on the card at every site."""
    from repro_torch.analysis import pallas_check as pc
    from repro_torch.kernels import _build, vmem
    exports = {"quantized_maxsim": "hpc_qmaxsim_geometry",
               "maxsim": "hpc_maxsim_geometry",
               "hamming_maxsim": "hpc_hamming_geometry",
               "kmeans_assign": "hpc_kmeans_assign_geometry"}
    dtypes = {"quantized_maxsim": (torch.float32,),
              "quantized_maxsim_topk": (torch.float32, torch.int32),
              "maxsim": (torch.float32,), "hamming_maxsim": (torch.int32,),
              "kmeans_assign": (torch.int32,)}
    budget = vmem.device_budget(dev)
    regs, regs_from = _fresh_registers(torch)
    table = json.loads(pc.REGISTERS_JSON.read_text())["registers"]
    assert regs == table, f"csrc/registers.json {table} != {regs_from} {regs}"
    rows, findings, n_shapes = [], [], 0
    for name, mod in kernel_mods.items():
        for key, geom in sorted(mod.launch_shapes.items()):
            n_shapes += 1
            c = _build.c_geometry(exports[name], *key)
            assert c == geom.as_c(), \
                f"{name} at {key}: Python {geom.as_c()} != library {c}"
            f = pc.check_geometry(geom, f"{name}{list(key)}",
                                  dtypes[geom.kernel], budget=budget,
                                  registers=regs)
            findings += f
            rows.append({"kernel": geom.kernel, "shape": list(key),
                         "grid": list(geom.grid), "block": geom.threads,
                         "smem": geom.smem, "config": list(geom.config),
                         "registers": regs[pc._SOURCES[geom.kernel]],
                         "findings": [str(x) for x in f]})
    for site in pc.kernel_sites():
        geom = site.geometry(budget)
        c = _build.c_geometry(site.c_call[0], *site.c_call[1])
        assert c == geom.as_c(), \
            f"site {site.name}: Python {geom.as_c()} != library {c}"
        f = pc.check_site(site, budget=budget, registers=regs)
        findings += f
        card = pc.launch_site(site, dev)
        assert card["unwritten"] == 0, f"PAL03 on the card: {card}"
        rows.append({"kernel": geom.kernel, "site": site.name,
                     "shape": dict(site.dims), "grid": list(geom.grid),
                     "block": geom.threads, "smem": geom.smem,
                     "config": list(geom.config),
                     "registers": regs[pc._SOURCES[geom.kernel]],
                     "sentinel_elements": card["elements"],
                     "sentinel_unwritten": card["unwritten"],
                     "findings": [str(x) for x in f]})
    torch.cuda.empty_cache()
    print(json.dumps({"launch_check": rows}))
    print(f"launch geometry: {n_shapes} launched shapes and "
          f"{len(pc.kernel_sites())} sites equal to the library's; "
          f"registers {regs} ({regs_from}) == csrc/registers.json; budget "
          f"{budget.smem} B shared, {budget.regs_per_sm} registers per SM "
          f"({budget.source}); {len(findings)} finding(s)")
    assert not findings, "\n".join(map(str, findings))
    return {"launched_shapes": n_shapes, "sites": len(pc.kernel_sites()),
            "registers": regs, "registers_from": regs_from}


def _dryrun_checks(torch, dev, recsys_out, pna, sharded):
    """14c: every non-skipped cell on fake CUDA tensors, then the cells
    phases 12-13 ran held to the card."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    t1 = time.perf_counter()
    todo = [(a, c.name) for a, c in registry.all_cells()]
    recs = dryrun.run_cells(todo, workers=DRYRUN_WORKERS, device="cuda")
    wall = time.perf_counter() - t1
    bad = [(r["arch"], r["shape"], r.get("error")) for r in recs
           if r["status"] != "ok"]
    print(json.dumps({"dryrun": [
        {"arch": r["arch"], "shape": r["shape"], "status": r["status"],
         **({"trace_s": r["trace_s"], "cost_source": r["cost_source"],
             "flops": r["flops_per_dev"],
             "model_flops": r["meta"]["model_flops"],
             "hbm_bytes": r["hbm_bytes_per_dev"],
             "peak_bytes": r["mem"]["peak_bytes"],
             "peak_source": r["mem"]["peak_source"],
             "fits": r["mem"]["fits"],
             "dominant": r["roofline"]["dominant"],
             "roofline_frac": r["roofline"]["roofline_frac"]}
            if r["status"] == "ok" else {"error": r.get("error")})}
        for r in recs], "workers": DRYRUN_WORKERS, "wall_s": wall}))
    assert len(recs) == 39 and not bad, f"dry run failed: {bad}"
    by_cell = {(r["arch"], r["shape"]): r for r in recs}
    rows = []
    for arch, shape, changes, held, measured, real in _card_cells(
            recsys_out, pna, sharded):
        if changes:
            spec = registry.get(arch)
            spec = dataclasses.replace(spec, config=dataclasses.replace(
                spec.config, **changes))
            cell = next(c for c in spec.shapes if c.name == shape)
            world = dryrun._world_mesh("cuda") if cell.kind == "search" \
                else None
            m = dryrun.exact_cost_metrics(spec, cell, world, device="cuda")
            mem = {"argument_bytes": m["argument_bytes"],
                   "argument_bytes_each": m["argument_bytes_each"],
                   "temp_bytes": m["peak_above_args"]}
            flops = m["flops"]
        else:
            mem, flops = by_cell[(arch, shape)]["mem"], \
                by_cell[(arch, shape)]["flops_per_dev"]
        predicted = _HELD[held](mem)
        band = max(PEAK_BAND * measured, PEAK_FLOOR)
        rows.append({"arch": arch, "shape": shape, "changes": changes,
                     "held": held, "predicted_bytes": predicted,
                     "measured_bytes": measured,
                     "ratio": predicted / measured if measured else None,
                     "band_bytes": band,
                     "ok": abs(predicted - measured) <= band,
                     "flops_fake": flops, "flops_real": real})
    print(json.dumps({"dryrun_vs_card": rows}))
    for r in rows:
        print(f"{r['arch']} {r['shape']} ({r['held']}): predicted "
              f"{r['predicted_bytes'] / 2**30:.3f} GiB, measured "
              f"{r['measured_bytes'] / 2**30:.3f} GiB (x{r['ratio']:.4f}); "
              f"FLOPs fake {r['flops_fake']:.6g} real {r['flops_real']:.6g}")
    off = [r for r in rows if not r["ok"]]
    assert not off, f"dry-run peaks outside the band: {off}"
    flop_off = [r for r in rows if r["flops_fake"] != r["flops_real"]]
    assert not flop_off, f"fake FLOPs != real FLOPs: {flop_off}"
    return {"cells": len(recs), "wall_s": wall, "vs_card": rows}


def _cost_checks():
    """14d: every manifest's cost on the h100 roofline, held to
    COST_baseline_torch.json."""
    from repro_torch.analysis.cost_model import (check_against_baseline,
                                                 cost_report, load_baseline)
    from repro_torch.analysis.manifests import manifests
    reports = [cost_report(m) for m in manifests()]
    drift = check_against_baseline(reports, load_baseline())
    print(json.dumps({"cost": {
        r["manifest"]: {"flops": r["flops"], "hbm_bytes": r["hbm_bytes"],
                        "flops_per_doc": r["flops_per_doc"],
                        "bytes_per_doc": r["bytes_per_doc"],
                        "intensity": r["intensity"],
                        "bound_h100": r["bound"]["h100"],
                        "roofline_s_h100": r["roofline_s"]["h100"],
                        "ok": r["ok"]} for r in reports},
        "drift": [str(d) for d in drift]}))
    assert all(r["ok"] for r in reports), \
        [r["violations"] for r in reports if not r["ok"]]
    assert not drift, [str(d) for d in drift]
    return {"manifests": len(reports)}


def _rank0_on_card(seed: int) -> dict:
    """14e(b), in a process of its own: rank 0 of a fake MESH_RANKS-rank
    group over a "cuda" (16, 16) mesh runs its programs of MESH_HELD for
    real. Returns, per cell, its peak above what was held, its FLOPs as
    the dry run counts them and its quantized_maxsim launches. The fake
    group's collectives write no output, so no result is compared."""
    import gc

    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import registry
    from repro_torch.core import distributed as dist_core
    from repro_torch.core import pruning
    from repro_torch.dist.sharding import Sharder
    from repro_torch.kernels import quantized_maxsim as qm
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch import mesh as mesh_mod

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_mod.open_fake_group(MESH_RANKS)
    mesh = mesh_mod.make_production_mesh(device="cuda")
    shd = Sharder(mesh)

    def measure(fn):
        gc.collect()          # what earlier work left in reference cycles
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        qm.launches = 0
        t0 = time.perf_counter()
        out, flops = dryrun.real_flops(fn)
        torch.cuda.synchronize()
        return out, {"measured_bytes": torch.cuda.max_memory_allocated()
                     - held, "held_bytes": held, "flops": flops,
                     "quantized_maxsim_launches": qm.launches,
                     "seconds": time.perf_counter() - t0}

    # serve_query: rank 0's share of the corpus, drawn as phase 13a draws
    # the whole of it, placed as DTensors of its local rows
    gen = torch.Generator(device=dev).manual_seed(seed + 1400)
    n_loc = SERVE_DOCS // MESH_RANKS
    base = torch.randint(0, K, (n_loc, 1), generator=gen, device=dev)
    off = torch.randint(0, SERVE_WINDOW, (n_loc, SERVE_MD), generator=gen,
                        device=dev)
    codes = ((base + off) % K).to(torch.uint8)
    del base, off
    n_valid = pruning.keep_count(N_PATCHES, P)
    mask = (torch.arange(SERVE_MD, device=dev) < n_valid).expand(
        n_loc, SERVE_MD).contiguous()
    ids = torch.arange(n_loc, dtype=torch.int32, device=dev)

    def placed(t, spec, shape):
        return DTensor.from_local(
            t, mesh, shd.placements(spec, shape, unit_axes=False),
            run_check=False, shape=torch.Size(shape),
            stride=tuple(math.prod(shape[i + 1:])
                         for i in range(len(shape))))

    corpus = (placed(codes, ("corpus", None), (SERVE_DOCS, SERVE_MD)),
              placed(mask, ("corpus", None), (SERVE_DOCS, SERVE_MD)),
              placed(ids, ("corpus",), (SERVE_DOCS,)))
    q = torch.randn((SERVE_QUERIES, N_Q_PATCHES, DIM), generator=gen,
                    device=dev)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q_mask = torch.ones((SERVE_QUERIES, N_Q_PATCHES), dtype=torch.bool,
                        device=dev)
    cb = torch.randn((K, DIM), generator=gen, device=dev)
    cb = cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True)
    search = dist_core.sharded_search_fn(
        mesh, dist_core.corpus_data_axes(mesh, SERVE_DOCS), k=SERVE_TOP_K)
    (top_s, _), got = measure(lambda: search(q, q_mask, *corpus, cb))
    got["docs_a_rank"] = n_loc
    got["answer_shape"] = list(top_s.shape)
    out = {"colpali-hpc/serve_query": got}
    del corpus, codes, mask, ids, q, q_mask, cb, top_s
    torch.cuda.empty_cache()

    # dcn-v2 train_batch: the cell's arguments drawn whole and each
    # rank's shard kept (build_cell), the step run on rank 0's shards
    spec = registry.get("dcn-v2")
    cell = next(c for c in spec.shapes if c.name == "train_batch")
    built = cells.build_cell(spec, cell, mesh, device=dev, fake=False,
                             seed=seed + 1401)
    _, got = measure(lambda: built.fn(*built.args))
    out["dcn-v2/train_batch"] = got
    del built
    torch.distributed.destroy_process_group()
    return out


def _mesh_dryrun_phase(args, torch, smi):
    """Phase 14e: (a) MESH_CELLS traced as rank 0 of the production
    meshes on fake CUDA tensors; (b) ``_rank0_on_card`` held to them.
    Returns the launches of (b)'s run and the readings."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from repro_torch.launch import dryrun
    t0 = _phase("14e. the dry run at the production meshes: rank 0 of a "
                "fake 256- or 512-rank group")
    held = [(a, s, "single") for a, s in MESH_HELD
            if (a, s, "single") not in MESH_CELLS]
    with cf.ProcessPoolExecutor(max_workers=1,
                                mp_context=mp.get_context("spawn")) as ex:
        on_card = ex.submit(_rank0_on_card, args.seed)
        t1 = time.perf_counter()
        recs = dryrun.run_cells(list(MESH_CELLS) + held,
                                workers=DRYRUN_WORKERS, device="cuda")
        wall = time.perf_counter() - t1
        real = on_card.result()
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
           for r in recs if r["status"] != "ok"]
    assert not bad, f"production-mesh dry run failed: {bad}"
    rows = []
    for r in recs:
        ro, mem = r["roofline"], r["mem"]
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "chips": r["chips"], "rank": r["rank"],
            "trace_s": r["trace_s"], "cost_source": r["cost_source"],
            "peak_bytes": mem["peak_bytes"], "fits": mem["fits"],
            "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "flops_per_dev": r["flops_per_dev"],
            "model_flops_per_dev": ro["model_flops_per_dev"],
            "collective_bytes": r["collective_bytes_per_dev"],
            "collective_bytes_by_link": r["collective_bytes_by_link"],
            "compute_s": ro["compute_s"], "memory_s": ro["memory_s"],
            "collective_s": ro["collective_s"],
            "collective_s_all_nvlink": ro["collective_s_all_nvlink"],
            "collective_s_all_ib": ro["collective_s_all_ib"],
            "dominant": ro["dominant"],
            "kernels": {k: v["launches"] for k, v in r["kernels"].items()}})
    print(json.dumps({"dryrun_meshes": rows, "workers": DRYRUN_WORKERS,
                      "wall_s": wall, "smi": smi}))
    for r in rows:
        coll = {k: v for k, v in r["collective_bytes"].items() if v}
        print(f"{r['arch']} {r['shape']} on {r['mesh']} ({r['chips']} "
              f"chips, rank {r['rank']}): peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB a device (fits "
              f"{r['fits']}), {r['flops_per_dev']:.6g} FLOPs, collectives "
              f"{coll}, {r['dominant']}-bound, trace {r['trace_s']:.1f}s "
              f"({r['cost_source']})")
    by_cell = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    checks = []
    for arch, shape in MESH_HELD:
        want = by_cell[(arch, shape, "single")]
        got = real[f"{arch}/{shape}"]
        predicted = _HELD["serve"](want)
        measured = got["measured_bytes"]
        band = max(PEAK_BAND * measured, PEAK_FLOOR)
        checks.append({"arch": arch, "shape": shape, "mesh": "single",
                       "held": "serve", "predicted_bytes": predicted,
                       "measured_bytes": measured,
                       "ratio": predicted / measured if measured else None,
                       "band_bytes": band,
                       "ok": abs(predicted - measured) <= band,
                       "flops_fake": want["flops_per_dev"],
                       "flops_real": got["flops"],
                       "launches_fake": sum(
                           n for k, n in want["kernels"].items()
                           if k.startswith("quantized_maxsim")),
                       "launches_real": got["quantized_maxsim_launches"],
                       "seconds_real": got["seconds"]})
    print(json.dumps({"dryrun_meshes_vs_card": checks, "smi": smi}))
    print("the fake group's collectives write no output: rank 0's results "
          "are not compared, only its peak memory, FLOPs and launches")
    for c in checks:
        print(f"{c['arch']} {c['shape']} rank 0 of {MESH_RANKS} on the "
              f"card: predicted {c['predicted_bytes'] / 2**20:.2f} MiB, "
              f"measured {c['measured_bytes'] / 2**20:.2f} MiB above what "
              f"was held (x{c['ratio']:.4f}); FLOPs fake "
              f"{c['flops_fake']:.6g} real {c['flops_real']:.6g}; "
              f"quantized_maxsim launches {c['launches_real']} | {smi}")
    off = [c for c in checks if not c["ok"]]
    assert not off, f"production-mesh peaks outside the band: {off}"
    flop_off = [c for c in checks if c["flops_fake"] != c["flops_real"]]
    assert not flop_off, f"fake FLOPs != real FLOPs: {flop_off}"
    launch_off = [c for c in checks
                  if c["launches_fake"] != c["launches_real"]]
    assert not launch_off, f"launches differ: {launch_off}"
    serve = real["colpali-hpc/serve_query"]
    assert serve["quantized_maxsim_launches"] >= 1, \
        "the serve cell's rank 0 launched no quantized_maxsim"
    seconds = time.perf_counter() - t0
    print(f"phase 14e {seconds:.1f}s (traces {wall:.1f}s)")
    return {"launches": {f"serve_query (rank 0 of {MESH_RANKS})": {
        "quantized_maxsim": serve["quantized_maxsim_launches"]}},
        "records": rows, "vs_card": checks, "seconds": seconds}


def _analysis_phase(args, torch, np, dev, smi, kernel_mods, recsys_out, pna,
                    sharded):
    """Phase 14: (a) lint, (b) launch geometry, (c) the dry run held to
    the card, (d) the cost model."""
    from repro_torch.analysis.astchecks import TORCH_RULES
    from repro_torch.analysis.lintcore import RUFF_FALLBACK_RULES, run_paths
    t0 = _phase("14. analysis: lint, launch geometry, the dry run, the cost "
                "model")
    t1 = time.perf_counter()
    findings = run_paths([ROOT / "src" / "repro_torch",
                          Path(__file__).resolve()],
                         tuple(RUFF_FALLBACK_RULES) + tuple(TORCH_RULES))
    print(json.dumps({"lint": {"findings": [str(f) for f in findings],
                               "seconds": time.perf_counter() - t1}}))
    assert not findings, "\n".join(map(str, findings))
    t1 = time.perf_counter()
    out = {"launch": _launch_checks(torch, dev, kernel_mods)}
    out["launch"]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["dryrun"] = _dryrun_checks(torch, dev, recsys_out, pna, sharded)
    out["dryrun"]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["cost"] = _cost_checks()
    out["cost"]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"analysis": {k: (v if not isinstance(v, dict) else
                                       {kk: vv for kk, vv in v.items()
                                        if kk != "vs_card"})
                                   for k, v in out.items()}, "smi": smi}))
    print(f"phase 14 {out['seconds']:.1f}s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device on this host", file=sys.stderr)
        return 2
    from repro_torch import state_to
    from repro_torch.configs.colpali_hpc import COLPALI_HPC
    from repro_torch.configs.lm_archs import KIMI_K2, LLAMA4_SCOUT, QWEN2_1_5B
    from repro_torch.core import index as index_mod
    from repro_torch.core import pruning
    from repro_torch.core import scan as scan_mod
    from repro_torch.core import late_interaction as li
    from repro_torch.core.binary import packed_nbytes
    from repro_torch.data.synthetic import CorpusSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels import hamming as hm
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import maxsim as ms
    from repro_torch.kernels import quantized_maxsim as qm
    from repro_torch.launch.serve import build_and_serve
    from repro_torch.parity import topk_mismatches
    from repro_torch.retrieval import (CascadeConfig, HPCConfig, Query,
                                       Retriever, get_backend)

    def check_first_batch(run, cpu_state, tol):
        return _check_first_batch(torch, np, run, cpu_state, tol)

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)

    # -- 1. device -------------------------------------------------------
    t0 = _phase("device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lds_per_s = LDS_PER_CLK_PER_SM * n_sm * max_sm_mhz * 1e6
    popc_per_s = POPC_PER_CLK_PER_SM * n_sm * max_sm_mhz * 1e6
    print(f"device: {kind} | count {count} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {n_sm} SMs, max SM clock "
          f"{max_sm_mhz:.0f} MHz -> {lds_per_s:.3e} shared-memory loads/s, "
          f"{popc_per_s:.3e} popcounts/s")
    print(smi)
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2. build --------------------------------------------------------
    t0 = _phase("build")
    _build.library()
    info = _build.last_build
    print(f"kernels {'built' if info['compiled'] else 'loaded'} in "
          f"{info['seconds']:.1f}s -> {info['path']}")
    for line in str(info["log"]).splitlines():
        if "ptxas" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    # -- 3. kernels against their plain versions --------------------------
    t0 = _phase("check kernels against plain versions")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    md_kept = pruning.keep_count(N_PATCHES, P)

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def codes_mask(*shape, p_valid=0.97, k=K, dtype=torch.uint8):
        codes = torch.randint(0, k, shape, generator=gen, device=dev,
                              dtype=torch.int32).to(dtype)
        mask = torch.rand(shape, generator=gen, device=dev) < p_valid
        return codes, mask

    codebook = unit(K, DIM)
    q_unit = unit(MAX_BATCH, N_Q_PATCHES, DIM)
    table = li.adc_table(q_unit, codebook).contiguous()
    q_mask = (torch.rand((MAX_BATCH, N_Q_PATCHES), generator=gen,
                         device=dev) < 0.95).float()
    scan_c, scan_m = codes_mask(BLOCK_DOCS, md_kept)
    pool = codes_mask(MAX_BATCH, 2 * RERANK, N_PATCHES)
    rr_c, rr_m = (a[:, RERANK // 2:RERANK // 2 + RERANK] for a in pool)
    rag_c, rag_m = codes_mask(100, md_kept)
    dead_c, dead_m = codes_mask(BLOCK_DOCS, md_kept)
    dead_m[::7] = False                                  # all-masked docs
    qm_abs_err = 0.0
    for name, c, m in (("scan block", scan_c, scan_m),
                       ("rerank (per-query, strided)", rr_c, rr_m),
                       ("ragged block", rag_c, rag_m),
                       ("all-masked docs", dead_c, dead_m)):
        got = qm.quantized_maxsim_cuda(table, q_mask, c, m)
        want = qm.quantized_maxsim_plain(table, q_mask, c, m)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=QMAXSIM_TOL,
                                   rtol=QMAXSIM_TOL)
        live = m.any(dim=-1)
        live = live if live.dim() == 2 else live[None].expand_as(got)
        err = float((got - want).abs()[live].max())
        qm_abs_err = max(qm_abs_err, err)
        print(f"quantized_maxsim {name}: {tuple(c.shape)} max |err| "
              f"{err:.3e} over live docs")
    dead_got = qm.quantized_maxsim_cuda(table, q_mask, dead_c, dead_m)[:, ::7]
    expect = (li.NEG_INF * q_mask.double().sum(dim=1))[:, None]
    assert torch.isfinite(dead_got).all(), "all-masked docs not finite"
    assert torch.allclose(dead_got.double(), expect.expand_as(dead_got),
                          rtol=1e-5, atol=0), "all-masked docs != sum qm*-1e30"

    # quantized_maxsim's per-range top-k: the kernel's range lists against
    # the plain version's, at the flat sweep's, the rerank's and stage 2's
    # shapes (the launch's own range length) and at edge shapes, each with
    # invalid slots and all-masked docs; scores within 1e-4 and positions
    # equal outside near-ties
    def adc_inputs(b, mq, k_cb, lead, md, dtype=torch.uint8):
        tab = li.adc_table(unit(b, mq, DIM), unit(k_cb, DIM)).contiguous()
        qmask = (torch.rand((b, mq), generator=gen, device=dev)
                 < 0.95).float()
        return (tab, qmask) + codes_mask(*lead, md, k=k_cb, dtype=dtype)

    def with_holes(tab, qmask, c, m):
        m[..., 1::7, :] = False                          # all-masked docs
        v = torch.rand(c.shape[:-1], generator=gen, device=dev) > 0.05
        return tab, qmask, c, m, v

    rr_v = torch.rand((MAX_BATCH, 2 * RERANK), generator=gen,
                      device=dev)[:, RERANK // 2:RERANK // 2 + RERANK] > 0.05
    topk_cases = (
        ("flat sweep", with_holes(table, q_mask,
                                  *codes_mask(N_DOCS, md_kept)), RERANK,
         None),
        ("rerank (per-query, strided)", (table, q_mask, rr_c, rr_m, rr_v),
         RERANK, None),
        ("stage-2 pools", with_holes(table, q_mask, *codes_mask(
            MAX_BATCH, P1, md_kept)), P2, None),
        ("ragged, k > R", with_holes(*adc_inputs(3, N_Q_PATCHES, K, (100,),
                                                 md_kept)), 20, 16),
        ("k > N", with_holes(*adc_inputs(2, 8, 64, (5,), 40)), 12, 8),
        ("Mq 5, per-query", with_holes(*adc_inputs(3, 5, 64, (3, 70), 17)),
         7, 32),
        ("Mq 40", with_holes(*adc_inputs(2, 40, 128, (90,), 33)), 9, 16),
        ("K 512 uint16, per-query", with_holes(*adc_inputs(
            2, 16, 512, (2, 60), 32, torch.uint16)), 10, 16),
        ("ivf pools", with_holes(table, q_mask, *codes_mask(
            MAX_BATCH, IVF_N_PROBE * IVF_CAP, md_kept)), RERANK, None),
        ("hnsw pools", with_holes(table, q_mask, *codes_mask(
            MAX_BATCH, HNSW_EF, md_kept)), RERANK, None),
        ("RAG flat sweep (phase 9c)", with_holes(*adc_inputs(
            RAG_QUERIES, RAG_Q_PATCHES, K, (RAG_DOCS,), md_kept)), 8, None),
        ("RAG rerank (phase 9c)", with_holes(*adc_inputs(
            RAG_QUERIES, RAG_Q_PATCHES, K, (RAG_QUERIES, 8), N_PATCHES)),
         RAG_TOP_K_DOCS, None))
    for name, inputs, k_top, r in topk_cases:
        b_, n_ = inputs[0].shape[0], inputs[2].shape[-2]
        r = r if r is not None else qm.launch_range_len(b_, n_, dev)
        got = qm.quantized_maxsim_topk_cuda(*inputs, k=k_top, range_len=r)
        want = qm.quantized_maxsim_topk_plain(*inputs, k=k_top, range_len=r)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], atol=QMAXSIM_TOL,
                                   rtol=QMAXSIM_TOL)
        kk = got[0].shape[-1]
        g_s, g_p, w_s, w_p = (t.reshape(-1, kk).cpu().numpy()
                              for t in (*got, *want))
        bad = topk_mismatches(g_p, g_s, w_p, w_s, QMAXSIM_TOL)
        assert not bad, f"quantized_maxsim_topk {name}: positions {bad[:5]}"
        live = want[0] > li.NEG_INF
        err = float((got[0] - want[0]).abs()[live].max())
        qm_abs_err = max(qm_abs_err, err)
        print(f"quantized_maxsim_topk {name}: {tuple(inputs[2].shape)} "
              f"k={k_top} R={r} -> lists {tuple(got[0].shape)}, max |err| "
              f"{err:.3e} over live docs, positions equal outside near-ties")
    del topk_cases

    # hamming_maxsim, bit for bit: stage 1's block (uint16 codes, as the
    # HammingIndex stores them), ragged, all-masked, strided per-query
    # pools, and 9-bit codes of a K=512 codebook
    q_w = q_mask.to(torch.int32)
    for bits, k_codes in ((BITS, K), (9, 512)):
        q_codes = torch.randint(0, k_codes, (MAX_BATCH, N_Q_PATCHES),
                                generator=gen, device=dev, dtype=torch.int32)
        h_pool = codes_mask(MAX_BATCH, 3 * P2, md_kept, k=k_codes,
                            dtype=torch.uint16)
        h_dead = codes_mask(BLOCK_DOCS, md_kept, k=k_codes, dtype=torch.uint16)
        h_dead[1][::7] = False
        for name, (c, m) in (
                ("stage-1 block", codes_mask(BLOCK_DOCS, md_kept, k=k_codes,
                                             dtype=torch.uint16)),
                ("ragged block", codes_mask(100, md_kept, k=k_codes,
                                            dtype=torch.uint16)),
                ("all-masked docs", h_dead),
                ("per-query, strided", tuple(a[:, P2:2 * P2]
                                             for a in h_pool))):
            got = hm.hamming_maxsim_cuda(q_codes, q_w, c, m, bits)
            want = hm.hamming_maxsim_plain(q_codes, q_w, c, m, bits)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"hamming_maxsim {name} bits {bits}"
            print(f"hamming_maxsim {name}: {tuple(c.shape)} bits {bits} "
                  f"K={k_codes}: equal to the plain version")
        dead = hm.hamming_maxsim_cuda(q_codes, q_w, *h_dead, bits)[:, ::7]
        want = (-(2 ** 20) * q_w.sum(1)).to(torch.int32)[:, None]
        assert torch.equal(dead, want.expand_as(dead)), \
            "all-masked docs != sum qm * -(2**20)"
    # phase 9c's hamming retriever: 64 queries of 4 patches, 9-bit codes
    rag_qc = torch.randint(0, 512, (RAG_QUERIES, RAG_Q_PATCHES),
                           generator=gen, device=dev, dtype=torch.int32)
    rag_qw = torch.ones((RAG_QUERIES, RAG_Q_PATCHES), dtype=torch.int32,
                        device=dev)
    c, m = codes_mask(BLOCK_DOCS, md_kept, k=512, dtype=torch.uint16)
    got = hm.hamming_maxsim_cuda(rag_qc, rag_qw, c, m, 9)
    assert torch.equal(got, hm.hamming_maxsim_plain(rag_qc, rag_qw, c, m, 9)), \
        "hamming_maxsim at the RAG shape"
    print(f"hamming_maxsim RAG block (phase 9c): queries "
          f"{tuple(rag_qc.shape)} x {tuple(c.shape)} bits 9 K=512: equal "
          f"to the plain version")

    # maxsim within 1e-4: stage 3's pools (B, p2, Md, D), a shared-layout
    # block of float_flat, ragged, all-masked, strided per-query pools
    ms_abs_err = 0.0
    f_pool = unit(MAX_BATCH, 2 * P2, md_kept, DIM)
    f_pool_m = torch.rand(f_pool.shape[:-1], generator=gen, device=dev) < 0.97
    f_blk = unit(BLOCK_DOCS, md_kept, DIM)
    f_blk_m = torch.rand(f_blk.shape[:-1], generator=gen, device=dev) < 0.97
    f_dead_m = f_blk_m.clone()
    f_dead_m[::7] = False
    for name, d, m in (
            ("stage-3 pools", f_pool[:, :P2].contiguous(),
             f_pool_m[:, :P2].contiguous()),
            ("float_flat block", f_blk, f_blk_m),
            ("ragged block", f_blk[:100], f_blk_m[:100]),
            ("all-masked docs", f_blk, f_dead_m),
            ("per-query, strided", f_pool[:, P2 // 2:P2 // 2 + P2],
             f_pool_m[:, P2 // 2:P2 // 2 + P2])):
        got = ms.maxsim_cuda(q_unit, q_mask, d, m)
        want = ms.maxsim_plain(q_unit, q_mask, d, m)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=MAXSIM_TOL, rtol=MAXSIM_TOL)
        live = m.any(dim=-1)
        live = live if live.dim() == 2 else live[None].expand_as(got)
        err = float((got - want).abs()[live].max())
        ms_abs_err = max(ms_abs_err, err)
        print(f"maxsim {name}: {tuple(d.shape)} max |err| {err:.3e} over "
              f"live docs")
    dead_got = ms.maxsim_cuda(q_unit, q_mask, f_blk, f_dead_m)[:, ::7]
    assert torch.isfinite(dead_got).all(), "all-masked docs not finite"
    assert torch.allclose(dead_got.double(), expect.expand_as(dead_got),
                          rtol=1e-5, atol=0), "all-masked docs != sum qm*-1e30"
    # phase 9c's float_flat retriever: 64 queries of 4 patches (eight
    # groups of 8 per block) over a block of unpruned 1024-patch docs
    rag_q = unit(RAG_QUERIES, RAG_Q_PATCHES, DIM)
    rag_qm = torch.ones((RAG_QUERIES, RAG_Q_PATCHES), device=dev)
    f_rag = unit(BLOCK_DOCS, N_PATCHES, DIM)
    f_rag_m = torch.rand(f_rag.shape[:-1], generator=gen, device=dev) < 0.97
    got = ms.maxsim_cuda(rag_q, rag_qm, f_rag, f_rag_m)
    want = ms.maxsim_plain(rag_q, rag_qm, f_rag, f_rag_m)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=MAXSIM_TOL, rtol=MAXSIM_TOL)
    err = float((got - want).abs().max())
    ms_abs_err = max(ms_abs_err, err)
    print(f"maxsim RAG float_flat block (phase 9c): queries "
          f"{tuple(rag_q.shape)} x {tuple(f_rag.shape)} max |err| {err:.3e}")
    del f_rag, f_rag_m
    # the shared corpus with one query per block (the earlier grid, timed
    # in phase 6 beside the default)
    got = ms.maxsim_cuda(q_unit, q_mask, f_blk, f_blk_m,
                         max_queries_per_block=1)
    want = ms.maxsim_plain(q_unit, q_mask, f_blk, f_blk_m)
    torch.testing.assert_close(got, want, atol=MAXSIM_TOL, rtol=MAXSIM_TOL)
    ms_abs_err = max(ms_abs_err, float((got - want).abs().max()))
    print("maxsim float_flat block, one query per block: within tolerance")
    # candidate rows read through their ids (stage 3's layout): (B, p2)
    # positions into the block as a corpus, with repeated ids, -1 slots and
    # all-masked docs; an id past the corpus is never read and scores NaN
    f_rows = torch.randint(0, BLOCK_DOCS, (MAX_BATCH, P2), generator=gen,
                           device=dev, dtype=torch.int32)
    f_rows[:, 1::5] = f_rows[:, :1]
    f_rows[:, 2::9] = -1
    for name, m in (("stage-3 rows", f_blk_m),
                    ("stage-3 rows, all-masked docs", f_dead_m)):
        got = ms.maxsim_cuda(q_unit, q_mask, f_blk, m, rows=f_rows)
        want = ms.maxsim_plain(q_unit, q_mask, f_blk, m, rows=f_rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=MAXSIM_TOL, rtol=MAXSIM_TOL)
        live = (f_rows >= 0) & m.any(dim=1)[f_rows.clamp(min=0).long()]
        err = float((got - want).abs()[live].max())
        ms_abs_err = max(ms_abs_err, err)
        assert bool((got[f_rows < 0] == li.NEG_INF).all()), "-1 slots"
        print(f"maxsim {name}: rows {tuple(f_rows.shape)} into "
              f"{tuple(f_blk.shape)} max |err| {err:.3e} over live docs")
    past = f_rows.clone()
    past[:, 3] = BLOCK_DOCS + 5
    got = ms.maxsim_cuda(q_unit, q_mask, f_blk, f_blk_m, rows=past)
    assert bool(torch.isnan(got[:, 3]).all()), "an id past the corpus"
    assert not bool(torch.isnan(got[:, :3]).any())
    # the rows layout's segment table (a segmented live index's corpus
    # read in place): the block cut into 1, 2 and 5 segments, with
    # capacity-8 segments, -1 slots and ids resolved to a tombstone
    # (position -1), against the plain version's segment-by-segment
    # gather, which equals its monolithic gather bit for bit
    seg_rows = f_rows.clone()
    seg_rows[:, 3] = 195                       # in a capacity-8 segment
    seg_rows[:, 4] = 250                       # ... and in the last one
    seg_rows[:, 6::11] = -1                    # ids resolved to tombstones
    for caps in ((BLOCK_DOCS,), (200, 56), (128, 64, 8, 48, 8)):
        cut = np.cumsum((0,) + caps)
        for name, m in (("", f_blk_m), (", all-masked docs", f_dead_m)):
            segs = tuple(f_blk[a:b] for a, b in zip(cut[:-1], cut[1:]))
            masks = tuple(m[a:b] for a, b in zip(cut[:-1], cut[1:]))
            got = ms.maxsim_cuda(q_unit, q_mask, segs, masks, rows=seg_rows)
            want = ms.maxsim_plain(q_unit, q_mask, segs, masks,
                                   rows=seg_rows)
            torch.cuda.synchronize()
            assert torch.equal(want, ms.maxsim_plain(
                q_unit, q_mask, f_blk, m, rows=seg_rows)), "plain segments"
            torch.testing.assert_close(got, want, atol=MAXSIM_TOL,
                                       rtol=MAXSIM_TOL)
            assert bool((got[seg_rows < 0] == li.NEG_INF).all()), "-1 slots"
            live = (seg_rows >= 0) & m.any(dim=1)[seg_rows.clamp(
                min=0).long()]
            err = float((got - want).abs()[live].max())
            ms_abs_err = max(ms_abs_err, err)
            print(f"maxsim stage-3 rows through a {len(caps)}-segment table "
                  f"{caps}{name}: max |err| {err:.3e} over live docs")
    del f_pool, f_pool_m, f_blk, f_blk_m, f_dead_m

    x = unit(1 << 20, DIM)
    km_abs_err = _check_assign(torch, x, codebook,
                               km.kmeans_assign_cuda(x, codebook),
                               km.kmeans_assign_plain(x, codebook))
    x = unit(MAX_BATCH * N_Q_PATCHES, DIM)          # a batch's query codes
    km_abs_err = max(km_abs_err, _check_assign(
        torch, x, codebook, km.kmeans_assign_cuda(x, codebook),
        km.kmeans_assign_plain(x, codebook)))
    # ivf's routing assignment (K = n_list = 64) at the build's 16384
    # documents and at an append of 512, and the tests' K = 16
    for rows, k_c in ((N_DOCS, IVF_N_LIST), (N_ANN_ADD, IVF_N_LIST),
                      (300, 16)):
        x, cents = unit(rows, DIM), unit(k_c, DIM)
        km_abs_err = max(km_abs_err, _check_assign(
            torch, x, cents, km.kmeans_assign_cuda(x, cents),
            km.kmeans_assign_plain(x, cents)))
    del x, cents
    torch.cuda.empty_cache()
    print(f"checks passed in {time.perf_counter() - t0:.1f}s")

    # -- 4. flat path ------------------------------------------------------
    t0 = _phase("flat path")
    spec = CorpusSpec(n_docs=N_DOCS, n_queries=N_REQUESTS,
                      n_patches=N_PATCHES, n_q_patches=N_Q_PATCHES, dim=DIM)
    knobs = dict(k=K, p=P, prune_side="doc",
                 kmeans_restarts=KMEANS_RESTARTS,
                 kmeans_seed_batch=KMEANS_SEED_BATCH,
                 kmeans_minibatch=KMEANS_MINIBATCH,
                 scan_block_docs=BLOCK_DOCS)
    cfg = HPCConfig(backend="flat", rerank=RERANK, **knobs)
    torch.cuda.reset_peak_memory_stats()
    qm.launches = 0
    km.launches = 0
    run = build_and_serve(spec, cfg, n_requests=N_REQUESTS,
                          max_batch=MAX_BATCH, top_k=TOP_K, device=dev,
                          seed=args.seed)
    qm_launches, km_launches = qm.launches, km.launches
    st = run.stats
    n_batches = sum(v["batches"] for v in st["rungs"].values())
    n_warm = len(run.ladder)
    per_batch = 2                    # one sweep launch + one rerank launch
    print(f"build {run.build_s:.2f}s | storage {run.storage} | ladder "
          f"{run.ladder} warmed in {run.warm_s:.3f}s | served "
          f"{st['n']} requests in {run.serve_s:.3f}s, {st['qps']:.1f} QPS, "
          f"p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms | "
          f"hit@{TOP_K} {run.hit_rate:.3f} recall@{TOP_K} {run.recall:.3f} "
          f"| mean batch {st['mean_batch']:.2f} over {n_batches} batches | "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches: quantized_maxsim {qm_launches} (expected "
          f"({n_batches} served + {n_warm} warm-up batches) x {per_batch}), "
          f"kmeans_assign {km_launches}")
    assert km_launches >= 1, "the build never launched kmeans_assign"
    assert qm_launches == (n_batches + n_warm) * per_batch, \
        "scan launches off"
    assert st["n"] == N_REQUESTS, "not every request was served"
    assert run.storage["payload"] == N_DOCS * md_kept, run.storage

    s = run.state
    cpu_state = state_to(s, "cpu")
    t1 = time.perf_counter()
    check_first_batch(run, cpu_state, QMAXSIM_TOL)
    print(f"first batch == CPU plain path (ids outside near-ties, scores "
          f"within {QMAXSIM_TOL}); CPU search {time.perf_counter() - t1:.1f}s")
    # what phase 6 times the kernel and splits the search on; the rest of
    # the run is freed
    flat_s, flat_retriever = s, run.retriever
    flat_batch_ms = run.serve_s / n_batches * 1e3
    flat_hit, flat_recall = run.hit_rate, run.recall
    flat_queries, flat_relevance = run.queries, run.relevance
    del run, s, cpu_state
    torch.cuda.empty_cache()
    print(f"flat path phase {time.perf_counter() - t0:.1f}s")

    # -- 5. cascade path ---------------------------------------------------
    t0 = _phase("cascade path")
    cfg_c = HPCConfig(backend="cascade", cascade=CascadeConfig(P1, P2),
                      **knobs)
    torch.cuda.reset_peak_memory_stats()
    kernel_mods = {"hamming_maxsim": hm, "quantized_maxsim": qm,
                   "maxsim": ms, "kmeans_assign": km}
    for mod in kernel_mods.values():
        mod.launches = 0
    run = build_and_serve(spec, cfg_c, n_requests=N_REQUESTS,
                          max_batch=MAX_BATCH, top_k=TOP_K, device=dev,
                          seed=args.seed)
    casc_launches = {name: mod.launches for name, mod in kernel_mods.items()}
    st = run.stats
    n_batches_c = sum(v["batches"] for v in st["rungs"].values())
    n_warm_c = len(run.ladder)
    # per searched batch: stage 1 sweeps N in blocks, stage 2 the p1 pool
    # in one launch, stage 3 the p2 pool; stage 1 quantizes the queries
    # once; the build quantizes the corpus once
    casc_per_batch = {"hamming_maxsim": math.ceil(N_DOCS / BLOCK_DOCS),
                      "quantized_maxsim": 1,
                      "maxsim": math.ceil(P2 / BLOCK_DOCS),
                      "kmeans_assign": 1}
    casc_expect = {name: (n_batches_c + n_warm_c) * n
                   + (name == "kmeans_assign")
                   for name, n in casc_per_batch.items()}
    print(f"build {run.build_s:.2f}s | storage {run.storage} | ladder "
          f"{run.ladder} warmed in {run.warm_s:.3f}s | served "
          f"{st['n']} requests in {run.serve_s:.3f}s, {st['qps']:.1f} QPS, "
          f"p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms | "
          f"hit@{TOP_K} {run.hit_rate:.3f} (flat {flat_hit:.3f}) "
          f"recall@{TOP_K} {run.recall:.3f} (flat {flat_recall:.3f}) | "
          f"mean batch {st['mean_batch']:.2f} over {n_batches_c} batches | "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches: {casc_launches}; expected {casc_expect} = "
          f"({n_batches_c} served + {n_warm_c} warm-up batches) x "
          f"{casc_per_batch} + 1 kmeans_assign for the build")
    assert casc_launches == casc_expect, "cascade launches off"
    assert st["n"] == N_REQUESTS, "not every request was served"
    assert run.storage["stage_hamming"] == packed_nbytes(N_DOCS * md_kept,
                                                         BITS), run.storage
    assert run.storage["stage_flat"] == N_DOCS * md_kept, run.storage
    assert run.storage["stage_float_flat"] == N_DOCS * md_kept * DIM * 4
    assert run.hit_rate >= 0.95 * flat_hit, \
        f"cascade hit@{TOP_K} {run.hit_rate} < 0.95 x flat {flat_hit}"
    casc_qps = st["qps"]

    s = run.state
    casc = get_backend("cascade")
    (ham_b, ham_v), (flat_b, flat_v), _ = casc._views(s)
    cpu_state = state_to(s, "cpu")
    (_, cpu_ham_v), _, _ = casc._views(cpu_state)
    q, q_m, q_s = (torch.from_numpy(a[:MAX_BATCH]) for a in run.queries)
    qg = Query(q.to(dev), q_m.to(dev), q_s.to(dev))
    t1 = time.perf_counter()
    # stage 1 on the card (kernel) and on the CPU (plain), same query codes
    q_codes = ham_b._q_codes(ham_v, qg)
    q_codes_cpu = ham_b._q_codes(cpu_ham_v, Query(q, q_m, q_s))
    n_code_diff = int((q_codes.cpu() != q_codes_cpu).sum())
    idx = ham_v.backend_state.index
    pool_gpu = index_mod.search_hamming(idx, q_codes, qg.mask, bits=BITS,
                                        k=P1)
    pool_cpu = index_mod.search_hamming(cpu_ham_v.backend_state.index,
                                        q_codes.cpu(), q_m, bits=BITS, k=P1)
    assert torch.equal(pool_gpu[0].cpu(), pool_cpu[0]), "stage-1 scores"
    assert torch.equal(pool_gpu[1].cpu(), pool_cpu[1]), "stage-1 pools"
    top = BITS * N_Q_PATCHES
    at_top = (pool_gpu[0] == top).sum(dim=1).tolist()
    print(f"stage-1 pools: per query, {at_top} of {P1} candidates score the "
          f"maximum {top} (bits x Mq); the p1-th scores "
          f"{pool_gpu[0][:, -1].tolist()}")
    # the served batch against the whole funnel on the CPU, plain
    check_first_batch(run, cpu_state, MAXSIM_TOL)
    print(f"stage-1 pools ({MAX_BATCH} x {P1}) identical on the card and the "
          f"CPU; query codes differ at {n_code_diff} of {q_codes.numel()}; "
          f"first batch == CPU plain funnel (ids outside near-ties, scores "
          f"within {MAXSIM_TOL}); CPU checks {time.perf_counter() - t1:.1f}s")
    del cpu_state, cpu_ham_v
    pre_s, pre_i = casc.search_prefilter(s, qg, k=TOP_K)
    assert pre_s.dtype == torch.float32 and tuple(pre_i.shape) == (
        MAX_BATCH, TOP_K) and bool(torch.isfinite(pre_s).all())
    print(f"search_prefilter: float32 scores {tuple(pre_s.shape)}, top "
          f"{pre_s[0, :3].tolist()}")
    print(f"cascade path phase {time.perf_counter() - t0:.1f}s")

    # -- 6. kmeans_assign at the build's shape, then times -------------------
    t0 = _phase("kmeans_assign at the build's shape; times")
    # quantized_maxsim on the flat path's index: one sweep's launch (the
    # per-range top-k at the search's k = the rerank's over-fetch), the
    # same sweep through the scan (table, launch, merge), the scores-only
    # entry over the whole corpus, and the rerank's per-query pools
    flat = flat_s.backend_state
    codes, mask = flat.codes, flat.mask
    table = li.adc_table(q.to(dev), flat.codebook).contiguous()
    qmf = q_m.to(dev).float().contiguous()
    all_valid = torch.ones(N_DOCS, dtype=torch.bool, device=dev)
    sweep_r = qm.launch_range_len(MAX_BATCH, N_DOCS, dev)

    def topk_fn(tab, c, m, v, k_top, fn=qm.quantized_maxsim_topk_cuda,
                r=None):
        """One per-range top-k call, by default at the launch's own range
        length."""
        r = r or qm.launch_range_len(MAX_BATCH, c.shape[-2], dev)
        return lambda: fn(tab, qmf, c, m, v, k=k_top, range_len=r)

    def by_range(tab, c, m, v, k_top, reps):
        """The kernel's ms at half, once and twice the launch's range
        length: the evidence for launch_range_len's choice."""
        r = qm.launch_range_len(MAX_BATCH, c.shape[-2], dev)
        return {rr: _time_ms(torch, topk_fn(tab, c, m, v, k_top, r=rr), reps)
                for rr in (r // 2, r, 2 * r) if 1 <= rr <= qm.MAX_RANGE}

    def topk_cost(tab, c, m, v, k_top):
        """_qmaxsim_cost of one per-range top-k call: valid read once, the
        (score, position) lists written once."""
        n_ = c.shape[-2]
        r = qm.launch_range_len(MAX_BATCH, n_, dev)
        lists = MAX_BATCH * -(-n_ // r) * min(k_top, r) * 8
        return _qmaxsim_cost(tab, qmf, c, m,
                             v.numel() * v.element_size() + lists)

    sweep_ms = _time_ms(torch, topk_fn(table, codes, mask, all_valid,
                                       RERANK), 20)
    sweep_plain_ms = _time_ms(torch, topk_fn(
        table, codes, mask, all_valid, RERANK,
        qm.quantized_maxsim_topk_plain), 2)
    sweep_by_range = by_range(table, codes, mask, all_valid, RERANK, 10)
    # the same sweep with one query per block (the design two queries per
    # block replaced): timed beside it, in this run
    sweep_one_q_ms = _time_ms(torch, lambda: qm.quantized_maxsim_topk_cuda(
        table, qmf, codes, mask, all_valid, k=RERANK,
        max_queries_per_block=1), 20)
    sweep_bytes, sweep_ops = topk_cost(table, codes, mask, all_valid, RERANK)
    sweep_bound, sweep_by = _bound(sweep_bytes, sweep_ops)
    sweep_lds_bound = sweep_ops / lds_per_s * 1e3
    q_dev, q_m_dev = q.to(dev), q_m.to(dev)
    sweep_merge_ms = _time_ms(torch, lambda: scan_mod.quantized_maxsim_topk(
        q_dev, q_m_dev, codes, mask, flat.codebook, k=RERANK,
        doc_ids=flat.doc_ids), 20)
    scores_ms = _time_ms(
        torch, lambda: qm.quantized_maxsim_cuda(table, qmf, codes, mask), 20)
    ids = torch.arange(RERANK, device=dev).repeat(MAX_BATCH, 1) * 17
    rr_codes = flat_s.rerank_codes[ids]
    rr_mask = flat_s.rerank_mask[ids]
    rr_valid = ids >= 0
    rr_ms = _time_ms(torch, topk_fn(table, rr_codes, rr_mask, rr_valid,
                                    TOP_K), 200)
    rr_plain_ms = _time_ms(torch, topk_fn(
        table, rr_codes, rr_mask, rr_valid, TOP_K,
        qm.quantized_maxsim_topk_plain), 20)
    rr_by_range = by_range(table, rr_codes, rr_mask, rr_valid, TOP_K, 100)
    rr_bytes, rr_ops = topk_cost(table, rr_codes, rr_mask, rr_valid, TOP_K)
    rr_bound, _ = _bound(rr_bytes, rr_ops)
    rr_lds_bound = rr_ops / lds_per_s * 1e3
    del codes, mask, rr_codes, rr_mask

    # hamming_maxsim on the cascade's stage 1 (the first batch's codes)
    qc32 = q_codes.to(torch.int32).contiguous()
    qw32 = q_m.to(dev).to(torch.int32).contiguous()
    h_blocks = [(idx.codes[i:i + BLOCK_DOCS], idx.mask[i:i + BLOCK_DOCS])
                for i in range(0, N_DOCS, BLOCK_DOCS)]
    h_blk = h_blocks[0]

    def scan(score, blks):
        """One sweep's kernel launches, without the merges."""
        def run_blocks():
            for c, m in blks:
                score(c, m)
        return run_blocks

    ham_ms = _time_ms(torch, lambda: hm.hamming_maxsim_cuda(
        qc32, qw32, *h_blk, BITS), 200)
    ham_plain_ms = _time_ms(torch, lambda: hm.hamming_maxsim_plain(
        qc32, qw32, *h_blk, BITS), 10)
    ham_stage1_ms = _time_ms(torch, scan(
        lambda c, m: hm.hamming_maxsim_cuda(qc32, qw32, c, m, BITS),
        h_blocks), 10)
    ham_stage1_plain_ms = _time_ms(torch, scan(
        lambda c, m: hm.hamming_maxsim_plain(qc32, qw32, c, m, BITS),
        h_blocks), 2)
    # matmul-only yardstick: bits - popc(a ^ b) = (bits + <sa, sb>) / 2 for
    # the codes' +-1 bit vectors sa, sb; one (B*Mq, b) x (b, T*Md) product
    bit = torch.arange(BITS, device=dev)
    q_pm = (((qc32[..., None] >> bit) & 1) * 2 - 1).float().reshape(-1, BITS)
    d_pm = (((h_blk[0].to(torch.int32)[..., None] >> bit) & 1) * 2 - 1) \
        .float().reshape(-1, BITS).t().contiguous()
    ham_mm_ms = _time_ms(torch, lambda: torch.matmul(q_pm, d_pm), 50)
    ham_bytes, ham_ops = _hamming_cost(qc32, *h_blk)
    ham_bound, ham_by = _bound(ham_bytes, ham_ops, popc_per_s)
    s1_bytes, s1_ops = _hamming_cost(qc32, idx.codes, idx.mask)
    s1_bound, s1_by = _bound(s1_bytes, s1_ops, popc_per_s)

    # maxsim on the cascade's stage 3: the first batch's p2 pool, read
    # through its ids as search_float_flat_candidates hands it over, and
    # gathered first (the earlier stage 3), so the fusion's gain and the
    # tensor cores' show apart
    ff = s.backend_state.members[2]
    _, ids1 = ham_b.search(ham_v, qg, k=P1)
    _, ids2 = flat_b.search_candidates(flat_v, qg, ids1, k=P2)
    rows2 = ids2.to(torch.int32)
    qf = q.to(dev).float().contiguous()
    rows_ms = _time_ms(torch, lambda: ms.maxsim_cuda(
        qf, qmf, ff.embeddings, ff.mask, rows=rows2), 100)
    rows_plain_ms = _time_ms(torch, lambda: ms.maxsim_plain(
        qf, qmf, ff.embeddings, ff.mask, rows=rows2), 20)
    rows_bound = _gemm_bounds(*_maxsim_cost(qf, ff.embeddings, ff.mask,
                                            rows2))
    safe2 = torch.clamp(ids2, min=0).to(torch.int64)
    pool_emb, pool_mask = ff.embeddings[safe2], ff.mask[safe2]
    pool_ms = _time_ms(torch, lambda: ms.maxsim_cuda(qf, qmf, pool_emb,
                                                     pool_mask), 100)
    pool_plain_ms = _time_ms(torch, lambda: ms.maxsim_plain(
        qf, qmf, pool_emb, pool_mask), 20)
    pool_flat = pool_emb.reshape(MAX_BATCH, -1, DIM).transpose(1, 2)
    pool_mm_ms = _time_ms(torch, lambda: torch.matmul(qf, pool_flat), 50)
    gather_ms = _time_ms(torch, lambda: ff.embeddings[safe2], 20)
    pool_bound = _gemm_bounds(*_maxsim_cost(qf, pool_emb, pool_mask))
    # ... and on one shared-layout 256-doc block of float_flat, with every
    # query in one block and with one query per block (the earlier grid)
    f_blk, f_blk_m = ff.embeddings[:BLOCK_DOCS], ff.mask[:BLOCK_DOCS]
    fblk_ms = _time_ms(torch, lambda: ms.maxsim_cuda(qf, qmf, f_blk,
                                                     f_blk_m), 20)
    fblk_one_q_ms = _time_ms(torch, lambda: ms.maxsim_cuda(
        qf, qmf, f_blk, f_blk_m, max_queries_per_block=1), 20)
    fblk_plain_ms = _time_ms(torch, lambda: ms.maxsim_plain(
        qf, qmf, f_blk, f_blk_m), 5)
    fblk_flat = f_blk.reshape(-1, DIM).t()
    q_rows = qf.reshape(-1, DIM)
    fblk_mm_ms = _time_ms(torch, lambda: torch.matmul(q_rows, fblk_flat), 10)
    fblk_bound = _gemm_bounds(*_maxsim_cost(qf, f_blk, f_blk_m))
    pool_bytes = pool_emb.numel() * pool_emb.element_size()

    # quantized_maxsim on stage 2's first per-query block of the p1 pool
    fm = s.backend_state.members[1]
    safe1 = torch.clamp(ids1, min=0).to(torch.int64)
    s2_codes, s2_mask, s2_valid = fm.codes[safe1], fm.mask[safe1], ids1 >= 0
    table_c = li.adc_table(qf, fm.codebook).contiguous()
    s2_ms = _time_ms(torch, topk_fn(table_c, s2_codes, s2_mask, s2_valid,
                                    P2), 100)
    s2_plain_ms = _time_ms(torch, topk_fn(
        table_c, s2_codes, s2_mask, s2_valid, P2,
        qm.quantized_maxsim_topk_plain), 5)
    s2_by_range = by_range(table_c, s2_codes, s2_mask, s2_valid, P2, 50)
    s2_bytes, s2_ops = topk_cost(table_c, s2_codes, s2_mask, s2_valid, P2)
    s2_bound, _ = _bound(s2_bytes, s2_ops)
    s2_lds_bound = s2_ops / lds_per_s * 1e3

    # one cascade batch (the first served one) split into its stages, and
    # one flat batch into its sweep and rerank (the first batch's queries
    # on the flat path's state); see _split
    ff_b, ff_v = casc._views(s)[2]
    stage_fns = {
        "stage 1 (hamming prefilter, p1)": lambda: ham_b.search(
            ham_v, qg, k=P1),
        "stage 2 (ADC rescore, p2)": lambda: flat_b.search_candidates(
            flat_v, qg, ids1, k=P2),
        "stage 3 (float rerank, top-k)": lambda: ff_b.search_candidates(
            ff_v, qg, ids2, k=TOP_K),
        "whole search": lambda: run.retriever.search(s, qg, k=TOP_K)}
    stage_ms = _split(torch, stage_fns)
    print(f"served cascade batch: {run.serve_s / n_batches_c * 1e3:.1f} ms "
          f"of serving window per batch")
    f_backend = flat_retriever.backend
    _, f_ids = f_backend.search(flat_s, qg, k=RERANK, scan=cfg.scan)
    flat_fns = {
        f"sweep (ADC top-{RERANK} over {N_DOCS} docs)": lambda: (
            f_backend.search(flat_s, qg, k=RERANK, scan=cfg.scan)),
        f"rerank ({RERANK} per query -> top-{TOP_K})": lambda: (
            flat_retriever._rerank(flat_s, qg, f_ids, k=TOP_K)),
        "whole search": lambda: flat_retriever.search(flat_s, qg, k=TOP_K)}
    flat_ms = _split(torch, flat_fns)
    print(f"served flat batch: {flat_batch_ms:.1f} ms of serving window per "
          f"batch")
    casc_s, casc_retriever = s, run.retriever     # phase 13d's
    del run, s, casc, ham_v, flat_v, ff_v, ff, fm, idx, h_blocks, h_blk, \
        flat, f_ids, \
        pool_emb, pool_mask, pool_flat, f_blk, f_blk_m, fblk_flat, s2_codes, \
        s2_mask, s2_valid, rows2
    torch.cuda.empty_cache()

    def km_cost(rows):
        """(bytes, FLOPs) of one assignment of ``rows`` x DIM against K."""
        return rows * DIM * 4 + K * DIM * 4 + rows * 4, 2.0 * rows * K * DIM

    n_rows = N_DOCS * N_PATCHES
    x = unit(n_rows, DIM)
    cb = unit(K, DIM)
    c2 = (cb * cb).sum(-1)
    km_abs_err = max(km_abs_err, _check_assign(
        torch, x, cb, km.kmeans_assign_cuda(x, cb),
        km.kmeans_assign_plain(x, cb)))
    torch.cuda.empty_cache()
    km_ms = _time_ms(torch, lambda: km.kmeans_assign_cuda(x, cb), 3)
    km_plain_ms = _time_ms(torch, lambda: km.kmeans_assign_plain(x, cb), 2)
    addmm_ms = _time_ms(torch, lambda: torch.addmm(c2, x, cb.t(),
                                                   alpha=-2.0), 2)
    km_bound = _gemm_bounds(*km_cost(n_rows))
    # a cascade batch's query codes: B x Mq rows
    n_small = MAX_BATCH * N_Q_PATCHES
    xs = x[:n_small].contiguous()
    km_small_ms = _time_ms(torch, lambda: km.kmeans_assign_cuda(xs, cb), 200)
    km_small_plain_ms = _time_ms(
        torch, lambda: km.kmeans_assign_plain(xs, cb), 200)
    addmm_small_ms = _time_ms(torch, lambda: torch.addmm(
        c2, xs, cb.t(), alpha=-2.0), 200)
    km_small_bound = _gemm_bounds(*km_cost(n_small))
    del x, xs
    torch.cuda.empty_cache()
    print(f"times taken in {time.perf_counter() - t0:.1f}s")

    live = _live_phase(args, torch, np, dev, smi, spec, cfg, cfg_c,
                       flat_s, flat_retriever, flat_hit, casc_qps, stage_ms,
                       kernel_mods)
    files = _index_files(torch, dev, live, flat_s, flat_retriever)
    ann = _ann_phase(args, torch, np, dev, cfg, flat_s, flat_retriever,
                     flat_queries, flat_relevance, live["delta"],
                     kernel_mods, lds_per_s)
    casc_b = get_backend("cascade")
    (_, ham_s), _, (_, ff_s) = casc_b._views(casc_s)
    # 13d and 13g: a one-rank NCCL group of their own and a (1, 1) mesh
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, open_local_group
    open_local_group(dev)
    mesh = make_host_mesh((1, 1), ("data", "model"), device=dev)
    backends = _sharded_backends(args, torch, np, dev, smi, mesh, {
        "flat": (flat_retriever, flat_s, False),
        "hamming": (Retriever(dataclasses.replace(cfg, backend="hamming")),
                    ham_s, False),
        "float_flat": (Retriever(dataclasses.replace(
            cfg, backend="float_flat")), ff_s, True),
        "cascade": (casc_retriever, casc_s, False),
        "live cascade": (live["retriever"], live["state"], False),
        "ivf": ann["states"]["ivf"] + (False,),
        "hnsw": ann["states"]["hnsw"] + (False,)},
        flat_queries, kernel_mods)
    placed_live = _placed_live_phase(
        args, torch, np, dev, smi, mesh, live, (flat_retriever, flat_s),
        (casc_retriever, casc_s), flat_queries, flat_relevance, kernel_mods)
    dist.destroy_process_group()
    flat_codebook = flat_s.codebook.clone()
    for key in ("delta", "state", "base", "responses", "retriever"):
        del live[key]
    del flat_s, flat_retriever, ann["states"]
    del casc_s, casc_retriever, ham_s, ff_s
    torch.cuda.empty_cache()
    f5 = _f5_start()
    model = _model_phase(args, torch, np, dev, smi, COLPALI_HPC.config,
                         QWEN2_1_5B.config, kernel_mods)
    train = _train_phase(args, torch, np, dev, smi, COLPALI_HPC.config,
                         QWEN2_1_5B, kernel_mods)
    moe = _moe_phase(args, torch, np, dev, smi, LLAMA4_SCOUT, KIMI_K2,
                     kernel_mods)
    recsys_out = _recsys_phase(args, torch, np, dev, smi, kernel_mods)
    pna = _pna_phase(args, torch, np, dev, smi, kernel_mods)
    km_abs_err = max(km_abs_err, recsys_out["kmeans_max_gap"])
    model_sharding = _model_sharding_phase(args, torch, np, dev, smi,
                                           kernel_mods)
    _f5_finish(f5, smi)
    sharded = _sharded_phase(args, torch, np, dev, cfg, flat_codebook,
                             flat_hit, lds_per_s)
    serve = sharded["serve"]
    _analysis_phase(args, torch, np, dev, smi, kernel_mods, recsys_out, pna,
                    sharded)
    meshes = _mesh_dryrun_phase(args, torch, smi)
    qm_abs_err = max(qm_abs_err, serve["max_abs_err"])

    by_path = {"flat": {"quantized_maxsim": qm_launches,
                        "kmeans_assign": km_launches},
               "cascade": casc_launches,
               "live cascade": live["launches"],
               **ann["launches"], **model["launches"],
               **train["launches"], **moe["launches"],
               **recsys_out["launches"], **pna["launches"],
               **sharded["launches"], **backends["launches"],
               **placed_live["launches"],
               **model_sharding["launches"], **meshes["launches"]}

    def launches(name):
        return sum(path.get(name, 0) for path in by_path.values())

    def per_path(name):
        return {p: v[name] for p, v in by_path.items() if name in v}

    kernels = [
        {"name": "quantized_maxsim", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantized_maxsim.cu",
         "replaces": "src/repro/kernels/quantized_maxsim.py:92",
         "launches": launches("quantized_maxsim"),
         "launches_by_path": per_path("quantized_maxsim"),
         "max_abs_err": qm_abs_err,
         "ms": sweep_ms, "plain_ms": sweep_plain_ms,
         "bound_ms": sweep_bound, "bound_by": sweep_by, "library_ms": None,
         "f32_fma_bound_ms": None, "tf32x3_bound_ms": None,
         "ms_over_bound": sweep_ms / sweep_bound,
         "lds_bound_ms": sweep_lds_bound,
         "ms_over_lds_bound": sweep_ms / sweep_lds_bound,
         "shape": f"one flat sweep, per-range top-{RERANK} in one launch: "
                  f"B={MAX_BATCH} Mq={N_Q_PATCHES} K={K} {N_DOCS} docs x "
                  f"Md={md_kept}, ranges of {sweep_r}",
         "sweep_ms_by_range_len": sweep_by_range,
         "sweep_one_query_per_block_ms": sweep_one_q_ms,
         "sweep_with_table_and_merge_ms": sweep_merge_ms,
         "scores_only_full_corpus_ms": scores_ms,
         "rerank_ms": rr_ms, "rerank_plain_ms": rr_plain_ms,
         "rerank_bound_ms": rr_bound, "rerank_lds_bound_ms": rr_lds_bound,
         "rerank_ms_by_range_len": rr_by_range,
         "cascade_stage2_ms": s2_ms, "cascade_stage2_plain_ms": s2_plain_ms,
         "cascade_stage2_bound_ms": s2_bound,
         "cascade_stage2_lds_bound_ms": s2_lds_bound,
         "cascade_stage2_ms_by_range_len": s2_by_range,
         **{f"{router}_pool_{key}": val
            for router in ("ivf", "hnsw")
            for key, val in ann[f"{router}_pool"].items()},
         "serve_cell_ms": serve["kernel_ms"],
         "serve_cell_plain_ms_16384_docs":
             serve["kernel_plain_ms_16384_docs"],
         "serve_cell_bound_ms": serve["bound_ms"],
         "serve_cell_bound_by": serve["bound_by"],
         "serve_cell_lds_bound_ms": serve["lds_bound_ms"],
         "serve_cell_launches": serve["launches"],
         "serve_cell_shape": f"serve_query through sharded_search_fn: "
                             f"B={SERVE_QUERIES} Mq={N_Q_PATCHES} K={K} "
                             f"{SERVE_DOCS} docs x Md={SERVE_MD}, "
                             f"per-range top-{SERVE_TOP_K}, ranges of "
                             f"{serve['range_len']}, "
                             f"{serve['docs_per_launch']} docs a launch"},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign.py:58",
         "launches": launches("kmeans_assign"),
         "launches_by_path": per_path("kmeans_assign"),
         "max_abs_err": km_abs_err,
         "ms": km_ms, "plain_ms": km_plain_ms, "bound_ms": km_bound[0],
         "bound_by": km_bound[1], "library_ms": None,
         "f32_fma_bound_ms": km_bound[2], "tf32x3_bound_ms": km_bound[3],
         "ms_over_bound": km_ms / km_bound[0],
         "shape": f"quantize {n_rows} x {DIM} against K={K}",
         "addmm_matmul_only_yardstick_ms": addmm_ms,
         "query_codes_ms": km_small_ms,
         "query_codes_plain_ms": km_small_plain_ms,
         "query_codes_bound_ms": km_small_bound[0],
         "query_codes_bound_by": km_small_bound[1],
         "query_codes_f32_fma_bound_ms": km_small_bound[2],
         "query_codes_tf32x3_bound_ms": km_small_bound[3],
         "query_codes_addmm_yardstick_ms": addmm_small_ms,
         "query_codes_shape": f"{n_small} x {DIM} against K={K}, one per "
                              f"cascade batch",
         "ivf_route_assign_ms": ann["ivf_assign"]["ms"],
         "ivf_route_assign_plain_ms": ann["ivf_assign"]["plain_ms"],
         "ivf_route_assign_bound_ms": ann["ivf_assign"]["bound"][0],
         "ivf_route_assign_bound_by": ann["ivf_assign"]["bound"][1],
         "ivf_route_assign_addmm_yardstick_ms": ann["ivf_assign"]["addmm_ms"],
         "ivf_route_assign_shape": ann["ivf_assign"]["shape"],
         "recsys_tables": recsys_out["kmeans_assign_at_tables"],
         "sharded_build_launches":
             sharded["build"]["launches"]["kmeans_assign"],
         "sharded_build_shape": f"sharded_quantize of {N_DOCS * N_PATCHES} "
                                f"x {DIM} against K={K} (the build's "
                                f"shape, timed above) on one rank"},
        {"name": "hamming_maxsim", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming_maxsim.cu",
         "replaces": "src/repro/kernels/hamming.py:74",
         "launches": launches("hamming_maxsim"),
         "launches_by_path": per_path("hamming_maxsim"),
         "max_abs_err": 0.0,
         "ms": ham_ms, "plain_ms": ham_plain_ms, "bound_ms": ham_bound,
         "bound_by": ham_by, "library_ms": None,
         "f32_fma_bound_ms": None, "tf32x3_bound_ms": None,
         "ms_over_bound": ham_ms / ham_bound,
         "popcounts_per_s": popc_per_s,
         "shape": f"one stage-1 block: B={MAX_BATCH} Mq={N_Q_PATCHES} "
                  f"bits={BITS} {BLOCK_DOCS} docs x Md={md_kept} uint16",
         "stage1_ms_per_batch": ham_stage1_ms,
         "stage1_plain_ms_per_batch": ham_stage1_plain_ms,
         "stage1_bound_ms": s1_bound, "stage1_bound_by": s1_by,
         "pm1_matmul_only_yardstick_ms": ham_mm_ms},
        {"name": "maxsim", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/maxsim.cu",
         "replaces": "src/repro/kernels/maxsim.py:80",
         "launches": launches("maxsim"),
         "launches_by_path": per_path("maxsim"),
         "max_abs_err": ms_abs_err,
         "ms": rows_ms, "plain_ms": rows_plain_ms, "bound_ms": rows_bound[0],
         "bound_by": rows_bound[1], "library_ms": None,
         "f32_fma_bound_ms": rows_bound[2], "tf32x3_bound_ms": rows_bound[3],
         "ms_over_bound": rows_ms / rows_bound[0],
         "shape": f"stage-3 pools read through their ids: B={MAX_BATCH} "
                  f"Mq={N_Q_PATCHES} D={DIM} {P2} candidates x Md={md_kept} "
                  f"per query",
         "gathered_pools_ms": pool_ms,
         "gathered_pools_plain_ms": pool_plain_ms,
         "gathered_pools_bound_ms": pool_bound[0],
         "matmul_only_yardstick_ms": pool_mm_ms,
         "candidate_gather_ms": gather_ms,
         "candidate_gather_bytes": pool_bytes,
         "float_flat_block_ms": fblk_ms,
         "float_flat_block_one_query_per_block_ms": fblk_one_q_ms,
         "float_flat_block_plain_ms": fblk_plain_ms,
         "float_flat_block_bound_ms": fblk_bound[0],
         "float_flat_block_bound_by": fblk_bound[1],
         "float_flat_block_f32_fma_bound_ms": fblk_bound[2],
         "float_flat_block_tf32x3_bound_ms": fblk_bound[3],
         "float_flat_block_matmul_only_yardstick_ms": fblk_mm_ms,
         "segmented_rows_ms": live["rows_ms"],
         "segmented_rows_plain_ms": live["rows_plain_ms"],
         "segmented_rows_bound_ms": live["rows_bound_ms"],
         "segmented_rows_shape": live["rows_shape"]},
    ]
    print(json.dumps({"cascade_stages_ms": stage_ms}))
    print(json.dumps({"flat_search_ms": flat_ms}))
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

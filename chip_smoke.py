#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a host with a CUDA card. Phases, in order;
any failure exits non-zero, and no phase's error is swallowed:

  1. device: the card's name and count, ``nvidia-smi`` name and power
     limit, the TF32 flags (both set False: the path is float32);
  2. build: compile every kernel from ``src/repro_torch/kernels/csrc``
     with nvcc for sm_90a (time and ``-Xptxas -v`` lines);
  3. check: each kernel against its plain PyTorch version on the card at
     the main path's shapes (atol = rtol = 1e-4 for quantized_maxsim;
     agreement >= 0.9999 for kmeans_assign with every disagreement a
     near-tie, the two distances within 1e-4 in float64);
  4. main path at full ColPali width: build a flat index over 16384
     synthetic pages (1024 patches of D=128, pruned to 615, K=256), warm
     every ladder rung and serve 64 requests through
     ``AsyncRetrievalServer``; the launch counters prove the kernels ran,
     and the first batch is repeated on a CPU copy of the state through
     the plain path;
  5. kmeans_assign held to its plain version again at the build's own
     shape (16,777,216 x 128, 2^31 elements), then times with CUDA events
     after warm-up (CUDA-graph replays of many launches, so host overhead
     is not counted), beside each kernel's bound, printed as one
     ``{"kernels": [...]}`` JSON line.

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

# NVIDIA H100 SXM data sheet (at the full 700 W): f32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Shared memory serves 32 four-byte loads per clock per SM (128 B/clk):
# the rate that limits quantized_maxsim's table gather, one load per
# masked max-lookup. Times the SM count and the card's max SM clock.
LDS_PER_CLK_PER_SM = 32

QMAXSIM_TOL = 1e-4
KMEANS_AGREE = 0.9999
KMEANS_TIE_TOL = 1e-4


def _phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def _qmaxsim_cost(table, codes, mask):
    """(bytes, masked max-lookups) one quantized_maxsim call needs: every
    input read once, the output written once; lookups over valid slots."""
    b, mq, _ = table.shape
    n = codes.shape[-2]
    n_bytes = (table.numel() * 4 + b * mq * 4
               + codes.numel() * codes.element_size()
               + mask.numel() * mask.element_size() + b * n * 4)
    valid = int(mask.sum())
    lookups = mq * valid * (1 if codes.dim() == 3 else b)
    return n_bytes, lookups


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device on this host", file=sys.stderr)
        return 2
    from repro_torch.core import pruning
    from repro_torch.core import late_interaction as li
    from repro_torch.core.index import FlatIndex
    from repro_torch.data.synthetic import CorpusSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import quantized_maxsim as qm
    from repro_torch.launch.serve import build_and_serve
    from repro_torch.parity import topk_mismatches
    from repro_torch.retrieval import HPCConfig, Query, RetrieverState

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
    print(f"device: {kind} | count {count} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {n_sm} SMs, max SM clock "
          f"{max_sm_mhz:.0f} MHz -> {lds_per_s:.3e} shared-memory loads/s")
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

    def codes_mask(*shape, p_valid=0.97):
        codes = torch.randint(0, K, shape, generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        mask = torch.rand(shape, generator=gen, device=dev) < p_valid
        return codes, mask

    codebook = unit(K, DIM)
    table = li.adc_table(unit(MAX_BATCH, N_Q_PATCHES, DIM), codebook).contiguous()
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

    x = unit(1 << 20, DIM)
    km_abs_err = _check_assign(torch, x, codebook,
                               km.kmeans_assign_cuda(x, codebook),
                               km.kmeans_assign_plain(x, codebook))
    del x
    print(f"checks passed in {time.perf_counter() - t0:.1f}s")

    # -- 4. main path ------------------------------------------------------
    t0 = _phase("main path")
    spec = CorpusSpec(n_docs=N_DOCS, n_queries=N_REQUESTS,
                      n_patches=N_PATCHES, n_q_patches=N_Q_PATCHES, dim=DIM)
    cfg = HPCConfig(k=K, p=P, prune_side="doc", backend="flat",
                    rerank=RERANK, kmeans_restarts=KMEANS_RESTARTS,
                    kmeans_seed_batch=KMEANS_SEED_BATCH,
                    kmeans_minibatch=KMEANS_MINIBATCH,
                    scan_block_docs=BLOCK_DOCS)
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
    per_batch = math.ceil(N_DOCS / BLOCK_DOCS) + 1
    print(f"build {run.build_s:.2f}s | storage {run.storage} | ladder "
          f"{run.ladder} warmed in {run.warm_s:.3f}s | served "
          f"{st['n']} requests in {run.serve_s:.3f}s, {st['qps']:.1f} QPS, "
          f"p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms | "
          f"hit@{TOP_K} {run.hit_rate:.3f} | mean batch "
          f"{st['mean_batch']:.2f} over {n_batches} batches | "
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
    cpu_state = RetrieverState(
        s.codebook.cpu(), FlatIndex(*(t.cpu() for t in s.backend_state)),
        s.rerank_codes.cpu(), s.rerank_mask.cpu())
    q, q_m, q_s = (torch.from_numpy(a[:MAX_BATCH]) for a in run.queries)
    t1 = time.perf_counter()
    cpu_s, cpu_i = run.retriever.search(cpu_state, Query(q, q_m, q_s),
                                        k=TOP_K)
    srv_s = np.stack([r[0] for r in run.results[:MAX_BATCH]])
    srv_i = np.stack([r[1] for r in run.results[:MAX_BATCH]])
    cpu_s, cpu_i = cpu_s.numpy(), cpu_i.numpy()
    assert np.isfinite(srv_s).all() and srv_i.shape == (MAX_BATCH, TOP_K)
    np.testing.assert_allclose(srv_s, cpu_s, atol=QMAXSIM_TOL,
                               rtol=QMAXSIM_TOL)
    bad = topk_mismatches(srv_i, srv_s, cpu_i, cpu_s, QMAXSIM_TOL)
    assert not bad, f"served ids differ from the CPU plain path at {bad}"
    print(f"first batch == CPU plain path (ids outside near-ties, scores "
          f"within {QMAXSIM_TOL}); CPU search {time.perf_counter() - t1:.1f}s")
    print(f"main path phase {time.perf_counter() - t0:.1f}s")

    # -- 5. kmeans_assign at the build's shape, then times -------------------
    t0 = _phase("kmeans_assign at the build's shape; times")
    codes, mask = s.backend_state.codes, s.backend_state.mask
    table = li.adc_table(q.to(dev), s.codebook).contiguous()
    qmf = q_m.to(dev).float().contiguous()
    blocks = [(codes[i:i + BLOCK_DOCS], mask[i:i + BLOCK_DOCS])
              for i in range(0, N_DOCS, BLOCK_DOCS)]

    def scan(fn):
        def run_blocks():
            for c, m in blocks:
                fn(table, qmf, c, m)
        return run_blocks

    scan_ms = _time_ms(torch, scan(qm.quantized_maxsim_cuda), 10)
    scan_plain_ms = _time_ms(torch, scan(qm.quantized_maxsim_plain), 2)
    blk_bytes, blk_ops = _qmaxsim_cost(table, *blocks[0])
    blk_bound, blk_by = _bound(blk_bytes, blk_ops)
    blk_lds_bound = blk_ops / lds_per_s * 1e3
    full_bytes, full_ops = _qmaxsim_cost(table, codes, mask)
    full_bound, _ = _bound(full_bytes, full_ops)
    full_lds_bound = full_ops / lds_per_s * 1e3
    full_ms = _time_ms(
        torch, lambda: qm.quantized_maxsim_cuda(table, qmf, codes, mask), 20)
    ids = torch.arange(RERANK, device=dev).repeat(MAX_BATCH, 1) * 17
    rr_codes = s.rerank_codes[ids]
    rr_mask = s.rerank_mask[ids]
    rr_ms = _time_ms(torch, lambda: qm.quantized_maxsim_cuda(
        table, qmf, rr_codes, rr_mask), 200)
    rr_plain_ms = _time_ms(torch, lambda: qm.quantized_maxsim_plain(
        table, qmf, rr_codes, rr_mask), 20)
    rr_bound, _ = _bound(*_qmaxsim_cost(table, rr_codes, rr_mask))
    n_blocks = len(blocks)
    del run, s, cpu_state, codes, mask, blocks, rr_codes, rr_mask
    torch.cuda.empty_cache()

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
    km_bound, km_by = _bound(n_rows * DIM * 4 + K * DIM * 4 + n_rows * 4,
                             2.0 * n_rows * K * DIM)
    del x
    torch.cuda.empty_cache()
    print(f"times taken in {time.perf_counter() - t0:.1f}s")

    kernels = [
        {"name": "quantized_maxsim", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantized_maxsim.cu",
         "replaces": "src/repro/kernels/quantized_maxsim.py:92",
         "launches": qm_launches, "max_abs_err": qm_abs_err,
         "ms": scan_ms / n_blocks, "plain_ms": scan_plain_ms / n_blocks,
         "bound_ms": blk_bound, "bound_by": blk_by, "library_ms": None,
         "ms_over_bound": scan_ms / n_blocks / blk_bound,
         "lds_bound_ms": blk_lds_bound,
         "ms_over_lds_bound": scan_ms / n_blocks / blk_lds_bound,
         "shape": f"one scan block: B={MAX_BATCH} Mq={N_Q_PATCHES} K={K} "
                  f"{BLOCK_DOCS} docs x Md={md_kept} (mean of the "
                  f"{n_blocks} blocks of a {N_DOCS}-doc scan)",
         "scan_ms_per_batch": scan_ms,
         "scan_plain_ms_per_batch": scan_plain_ms,
         "one_launch_full_scan_ms": full_ms,
         "full_scan_bound_ms": full_bound,
         "full_scan_lds_bound_ms": full_lds_bound,
         "rerank_ms": rr_ms, "rerank_plain_ms": rr_plain_ms,
         "rerank_bound_ms": rr_bound},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign.py:58",
         "launches": km_launches, "max_abs_err": km_abs_err,
         "ms": km_ms, "plain_ms": km_plain_ms, "bound_ms": km_bound,
         "bound_by": km_by, "library_ms": None,
         "ms_over_bound": km_ms / km_bound,
         "shape": f"quantize {n_rows} x {DIM} against K={K}",
         "addmm_matmul_only_yardstick_ms": addmm_ms},
    ]
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

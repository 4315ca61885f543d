"""A copy of the benchmark's files with tiny cells, for runs on the CPU
(the port's plain versions stand in for its kernels there)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent

TINY_CONFIGS = {
    "tiny-flat": {
        "kind": "flat", "corpus_docs": 3000, "kept_patches": 12,
        "n_patches": 16, "proj_dim": 16, "query_len": 4, "k": 16, "p": 60.0,
        "prune_side": "doc", "backend": "flat", "rerank": 8, "top_k": 4,
        "code_window": 8, "query_pool": 64},
    "tiny-cascade": {
        "kind": "cascade", "corpus_docs": 1024, "n_patches": 16,
        "proj_dim": 16, "query_len": 4, "k": 16, "p": 60.0,
        "prune_side": "doc", "backend": "cascade", "rerank": 8, "p1": 64,
        "p2": 16, "bits": 4, "top_k": 4, "chunk_docs": 256,
        "query_pool": 64, "n_topics": 4, "patches_per_topic": 8,
        "noise": 0.25, "salient_frac": 0.5, "dup_per_doc": 3},
    # the port's colpali-smoke encoder (float32) in front of a tiny index
    "tiny-qenc": {
        "kind": "encoded_flat", "corpus_docs": 3000, "kept_patches": 12,
        "n_patches": 16, "proj_dim": 16, "query_len": 8, "k": 16, "p": 60.0,
        "prune_side": "doc", "backend": "flat", "rerank": 8, "top_k": 4,
        "code_window": 8, "query_pool": 64, "query_tokens_min": 3,
        "embed_scale": 0.02, "bias_scale": 0.02, "norm_scale": 0.1,
        "encoder": {
            "name": "colpali-smoke", "d_patch": 24, "proj_dim": 16,
            "n_patches": 16, "query_len": 8, "temperature": 0.02,
            "backbone": {
                "name": "colpali-smoke-bb", "n_layers": 2, "d_model": 48,
                "n_heads": 3, "n_kv_heads": 1, "d_ff": 96, "vocab": 128,
                "head_dim": 16, "qkv_bias": True, "rope_theta": 500000.0,
                "norm_eps": 1e-5, "q_chunk": 16, "loss_chunk": 16,
                "param_dtype": "float32", "activation_dtype": "float32"}}},
}
# the card's tests: the cells' widths at a few thousand pages
CARD_CONFIGS = {
    "tiny-flat": {
        "kind": "flat", "corpus_docs": 65536, "kept_patches": 616,
        "n_patches": 1024, "proj_dim": 128, "query_len": 32, "k": 256,
        "p": 60.0, "prune_side": "doc", "backend": "flat", "rerank": 32,
        "top_k": 10, "code_window": 64, "query_pool": 512},
    "tiny-cascade": {
        "kind": "cascade", "corpus_docs": 8192, "n_patches": 1024,
        "proj_dim": 128, "query_len": 32, "k": 256, "p": 60.0,
        "prune_side": "doc", "backend": "cascade", "rerank": 32, "p1": 1024,
        "p2": 64, "bits": 8, "top_k": 10, "chunk_docs": 1024,
        "query_pool": 512, "n_topics": 32, "patches_per_topic": 64,
        "noise": 0.25, "salient_frac": 0.5, "dup_per_doc": 3},
}
# the full cell's configuration (qwen2-1.5b, bf16 activations) over 65,536
# pages: ``tree`` reads the rest from the configuration named by "from"
CARD_CONFIGS["tiny-qenc"] = {"from": "colpali-hpc-qenc-flat-4m",
                             "kind": "encoded_flat", "corpus_docs": 65536,
                             "query_pool": 512}
TINY_TRAFFIC = {"generator": "closed_loop", "clients": 8, "max_batch": 4,
                "max_inflight": 2, "max_wait_ms": 2.0, "warm_s": 0.3}
# the tiny cells' limits: the full cells' are set from chip readings; on
# the CPU the port's plain versions and the reference agree to rounding
TINY_LIMITS = {"score_err": 1e-5, "rank_miss": 0.25}
CELLS = {"tiny-flat-cell": "tiny-flat", "tiny-cascade-cell": "tiny-cascade",
         "tiny-qenc-cell": "tiny-qenc"}
# the encoder cell's check on the CPU: a float32 encoder against the
# float32 reference agrees to rounding (errors near 1e-7); 32 answers, so
# that a fault in one of 4 batch slots shows (one miss reads 1/32)
TINY_ENC = {"sample": 32, "enc_tol": 1e-4,
            "limits": {**TINY_LIMITS, "enc_err": 1e-5, "enc_miss": 0.02}}


def cell_file(cell: str, card: bool) -> dict:
    """A tiny cell's file; on the card the encoder cell takes the full
    cell's sample, limits and ``enc_tol`` (the same encoder)."""
    out = {"config": CELLS[cell], "traffic": "tiny-closed", "chips": 1,
           "sample": 8, "limits": TINY_LIMITS}
    if CELLS[cell] == "tiny-qenc":
        full = json.loads((PB / "cells" / "qenc-flat4m-backlog.json")
                          .read_text())
        out.update({k: full[k] for k in TINY_ENC} if card else TINY_ENC)
    return out


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")


def tree(dest: Path, configs=None) -> Path:
    """Copy BENCHMARK.json and portbench/ under ``dest``, add the tiny
    configs (or ``configs``), mix and cells, and return the copy's
    portbench/."""
    pb = dest / "portbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, cfg in (configs or TINY_CONFIGS).items():
        if "from" in cfg:
            full = json.loads((PB / "configs" / f"{cfg['from']}.json")
                              .read_text())
            cfg = {**full, **{k: v for k, v in cfg.items() if k != "from"}}
        write_json(pb / "configs" / f"{name}.json", cfg)
    write_json(pb / "traffic" / "tiny-closed.json", TINY_TRAFFIC)
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for cell, cfg in CELLS.items():
        write_json(pb / "cells" / f"{cell}.json",
                   cell_file(cell, configs is CARD_CONFIGS))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": "tiny-closed", "chips": 1,
                                   "why": "tiny"})
    # the tiny cells report what the flat cell reports, the encoder cell
    # also what the full encoder cell reports; the tiny cascade also the
    # Hamming kernel's roofline, whose reader is there for the cascade cell
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flat4m-backlog" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + list(CELLS)
        elif "qenc-flat4m-backlog" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + ["tiny-qenc-cell"]
    bench["per_layer"].append({
        "name": "hamming_maxsim_roofline", "unit": "%",
        "better": "higher", "source": "device_trace",
        "layer": "kernels: kernels/hamming", "moves": "qps",
        "workloads": ["tiny-cascade-cell"]})
    write_json(dest / "BENCHMARK.json", bench)
    return pb

#!/usr/bin/env python3
"""Run the reference's RAG benchmark (``benchmarks/rag_bench.py``) over a
few seeds on the CPU and print its quality rows as JSON lines.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/rag_quality_seeds.py \
        [--seeds 0 1 2 3]

Each seed trains the benchmark's generator (300 steps) and scores every
retriever of its Table V rows. ROUGE-L, the hallucination rate and the
answer accuracy are quality numbers and do not depend on the host; the
latencies it prints are CPU times and no device's.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args(argv)
    from benchmarks import rag_bench
    for seed in args.seeds:
        t0 = time.perf_counter()
        rows = rag_bench.run(seed=seed, verbose=False)
        for row in rows:
            print(json.dumps({"seed": seed, **{
                k: row[k] for k in ("retriever", "rouge_l", "hallucination",
                                    "answer_acc") if k in row}}))
        print(json.dumps({"seed": seed,
                          "cpu_seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

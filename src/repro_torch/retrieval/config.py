"""HPC-ColPali configuration (paper §III): the knobs the ported backends
read.

The counterpart of ``repro.retrieval.config.HPCConfig``. ``backend`` names
the index backend in the ``repro_torch.retrieval`` registry.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core import binary as binary_mod
from repro_torch.core.graph import HNSWConfig
from repro_torch.core.index import IVFConfig
from repro_torch.core.scan import ScanConfig


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Per-stage candidate budgets of the compression cascade
    (retrieval/cascade.py): the Hamming prefilter over all N docs keeps
    ``p1`` candidates, the ADC rescore of those keeps ``p2``, and the float
    rerank of those returns the final top-k."""

    p1: int = 1024
    p2: int = 64


@dataclasses.dataclass(frozen=True)
class HPCConfig:
    """Tunable knobs of HPC-ColPali (paper §III)."""

    k: int = 256                     # codebook size (128/256/512)
    p: float = 60.0                  # top-p% patches kept
    prune_side: Literal["doc", "query", "both", "none"] = "doc"
    kmeans_iters: int = 25
    kmeans_restarts: int = 8         # independent codebook fits, best-of-N
    kmeans_seed_batch: int = 4096    # k-means++ seeding subsample; 0 = all
    kmeans_minibatch: int = 0        # 0 = full-batch Lloyd; else per-step
                                     # sample size for corpus-scale N
    rerank: int = 0                  # rerank top-r candidates with unpruned
                                     # quantized maxsim (0 = off)
    scan_block_docs: int = 256       # docs per streaming-scan block
    scan_impl: str = "auto"          # block scorer: auto|plain
    backend: str = "flat"            # registry key
    ivf: IVFConfig = dataclasses.field(default_factory=IVFConfig)
    hnsw: HNSWConfig = dataclasses.field(default_factory=HNSWConfig)
    cascade: CascadeConfig = dataclasses.field(default_factory=CascadeConfig)

    @property
    def bits(self) -> int:
        """b = ceil(log2 K), the width of a binary code (paper §III-D)."""
        return binary_mod.bits_for_k(self.k)

    @property
    def scan(self) -> ScanConfig:
        """Streaming-scan config implied by this HPCConfig."""
        return ScanConfig(block_docs=self.scan_block_docs,
                          impl=self.scan_impl)

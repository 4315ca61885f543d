"""HPC-ColPali configuration (paper §III): the knobs the flat path reads.

The counterpart of ``repro.retrieval.config.HPCConfig``. ``backend`` names
the index backend in the ``repro_torch.retrieval`` registry.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core.scan import ScanConfig


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

    @property
    def scan(self) -> ScanConfig:
        """Streaming-scan config implied by this HPCConfig."""
        return ScanConfig(block_docs=self.scan_block_docs,
                          impl=self.scan_impl)

"""HPC-ColPali configuration (paper §III): the knobs the ported backends
read.

The counterpart of ``repro.retrieval.config.HPCConfig``. ``backend`` names
the index backend in the ``repro_torch.retrieval`` registry. The v0 knobs
``mode``/``index`` are still accepted as a deprecated alias pair, resolved
to a backend through the reference's table, and kept populated on the
config (derived from ``backend``) for old readers; the deprecation warns
once per process, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Literal, Optional

from repro_torch.core import binary as binary_mod
from repro_torch.core.graph import HNSWConfig
from repro_torch.core.index import IVFConfig
from repro_torch.core.scan import ScanConfig

# (mode, index) -> backend name; the old union dispatch, now a table.
_MODE_INDEX_TO_BACKEND = {
    ("float", "flat"): "float_flat",
    ("float", "ivf"): "float_flat",      # v0 ignored `index` for float
    ("quantized", "flat"): "flat",
    ("quantized", "ivf"): "ivf",
    ("binary", "flat"): "hamming",       # v0 ignored `index` for binary
    ("binary", "ivf"): "hamming",
}
# backend name -> canonical (mode, index) for old readers; hnsw and cascade
# can never be produced *from* mode/index.
_BACKEND_TO_MODE_INDEX = {
    "float_flat": ("float", "flat"),
    "flat": ("quantized", "flat"),
    "ivf": ("quantized", "ivf"),
    "hnsw": ("quantized", "ivf"),
    "hamming": ("binary", "flat"),
    "cascade": ("float", "flat"),
}

# The mode/index deprecation fires once per process, not once per
# construction, as the reference's does. Tests reset this flag.
_mode_index_warned = False


def _warn_mode_index(backend: str) -> None:
    global _mode_index_warned
    if _mode_index_warned:
        return
    _mode_index_warned = True
    # stacklevel: this helper -> __post_init__ -> dataclass __init__ ->
    # the caller's HPCConfig(...) line.
    warnings.warn(
        "HPCConfig(mode=..., index=...) is deprecated and will be removed "
        f"in v2.0; pass backend={backend!r} instead (this warning is "
        "emitted once per process)",
        DeprecationWarning, stacklevel=4)


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
    """Tunable knobs of HPC-ColPali (paper §III). ``backend`` selects the
    primary search structure; ``mode``/``index`` are the deprecated v0
    spelling, derived from it."""

    k: int = 256                     # codebook size (128/256/512)
    p: float = 60.0                  # top-p% patches kept
    prune_side: Literal["doc", "query", "both", "none"] = "doc"
    mode: Optional[Literal["float", "quantized", "binary"]] = None
    index: Optional[Literal["flat", "ivf"]] = None
    kmeans_iters: int = 25
    kmeans_restarts: int = 8         # independent codebook fits, best-of-N
    kmeans_seed_batch: int = 4096    # k-means++ seeding subsample; 0 = all
    kmeans_minibatch: int = 0        # 0 = full-batch Lloyd; else per-step
                                     # sample size for corpus-scale N
    rerank: int = 0                  # rerank top-r candidates with unpruned
                                     # quantized maxsim (0 = off)
    scan_block_docs: int = 256       # docs per streaming-scan block
    scan_impl: str = "auto"          # block scorer: auto|plain
    backend: Optional[str] = None    # registry key; wins over mode/index
    ivf: IVFConfig = dataclasses.field(default_factory=IVFConfig)
    hnsw: HNSWConfig = dataclasses.field(default_factory=HNSWConfig)
    cascade: CascadeConfig = dataclasses.field(default_factory=CascadeConfig)

    def __post_init__(self):
        if self.backend is None:
            mode = self.mode if self.mode is not None else "quantized"
            index = self.index if self.index is not None else "flat"
            if self.mode is not None or self.index is not None:
                _warn_mode_index(_MODE_INDEX_TO_BACKEND[(mode, index)])
            object.__setattr__(
                self, "backend", _MODE_INDEX_TO_BACKEND[(mode, index)])
        elif self.backend not in _BACKEND_TO_MODE_INDEX:
            # unknown names are allowed for out-of-tree backends, but then
            # the mode/index aliases cannot be derived — leave as given.
            if self.mode is None or self.index is None:
                object.__setattr__(self, "mode", self.mode or "quantized")
                object.__setattr__(self, "index", self.index or "flat")
            return
        mode, index = _BACKEND_TO_MODE_INDEX[self.backend]
        object.__setattr__(self, "mode", mode)
        object.__setattr__(self, "index", index)

    @property
    def bits(self) -> int:
        """b = ceil(log2 K), the width of a binary code (paper §III-D)."""
        return binary_mod.bits_for_k(self.k)

    @property
    def scan(self) -> ScanConfig:
        """Streaming-scan config implied by this HPCConfig."""
        return ScanConfig(block_docs=self.scan_block_docs,
                          impl=self.scan_impl)

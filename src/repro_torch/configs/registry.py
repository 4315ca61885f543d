"""Architecture registry: ``--arch <id>`` resolution.

The counterpart of ``repro.configs.registry`` over the archs the port
has: the five LM archs (dense and MoE) and colpali-hpc. The gnn and
recsys arch ids raise ``NotImplementedError`` (ROADMAP.md §A item 7).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.colpali_hpc import COLPALI_HPC
from repro_torch.configs.lm_archs import (GLM4_9B, KIMI_K2, LLAMA32_3B,
                                          LLAMA4_SCOUT, QWEN2_1_5B)

ARCHS: Dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in (
        GLM4_9B, QWEN2_1_5B, LLAMA32_3B, LLAMA4_SCOUT, KIMI_K2,
        COLPALI_HPC,
    )
}

# the reference's gnn and recsys arch ids (repro.configs.gnn_archs,
# repro.configs.recsys_archs)
NOT_PORTED = ("pna", "din", "dlrm-mlperf", "dien", "dcn-v2")

def get(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch '{arch_id}': the gnn and recsys families are not ported "
            "yet (ROADMAP.md §A item 7)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = False, include_colpali: bool = True):
    """Yield (arch_id, ShapeCell) for every cell of the port's archs."""
    for arch_id, spec in ARCHS.items():
        if arch_id == "colpali-hpc" and not include_colpali:
            continue
        for cell in spec.shapes:
            if cell.skip and not include_skipped:
                continue
            yield arch_id, cell

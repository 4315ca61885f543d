"""Assigned GNN architecture: PNA [arXiv:2004.05718; paper].

The reference's ``repro.configs.gnn_archs``, copied as data over the
port's ``PNAConfig``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import PNAConfig

PNA = ArchSpec(
    arch_id="pna",
    family="gnn",
    config=PNAConfig(
        name="pna", n_layers=4, d_hidden=75, d_feat=1433, n_classes=7,
        delta=2.5),
    smoke_config=PNAConfig(
        name="pna-smoke", n_layers=2, d_hidden=16, d_feat=12, n_classes=3,
        delta=2.0),
    shapes=GNN_SHAPES,
    source="[arXiv:2004.05718; paper]",
    notes="aggregators mean/max/min/std x scalers id/amplification/"
          "attenuation. d_feat/n_classes are overridden per shape cell "
          "(Cora/Reddit/ogbn-products/molecules). Paper technique: K-Means "
          "feature quantization applies; attention pruning N/A "
          "(attention-free arch — docs/design.md §5).",
)

"""Assigned recsys architectures: DIN, DLRM-MLPerf, DIEN, DCN-v2.

The reference's ``repro.configs.recsys_archs``, copied as data over the
port's ``RecsysConfig``.

Embedding-table vocabularies are the public Criteo lists (Terabyte for
DLRM-MLPerf, Kaggle for DCN-v2) and the public Amazon-Electronics counts
for DIN/DIEN. Rows are padded up to a multiple of 512 so tables row-shard
on the 16-way model axis of either production mesh (real row counts kept
in `notes`; padding rows are never indexed).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig


def _pad512(rows):
    return tuple(-(-r // 512) * 512 for r in rows)


# Criteo Terabyte (MLPerf DLRM) per-feature cardinalities
CRITEO_TB = (39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
             38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14,
             39979771, 25641295, 39664984, 585935, 12972, 108, 36)

# Criteo Kaggle per-feature cardinalities (DCN-v2 paper benchmark)
CRITEO_KAGGLE = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                 93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                 2173, 4, 7046547, 18, 15, 286181, 105, 142572)

# Amazon Electronics (DIN/DIEN public benchmark)
AMAZON_ITEMS = 63001

DLRM_MLPERF = ArchSpec(
    arch_id="dlrm-mlperf",
    family="recsys",
    config=RecsysConfig(
        name="dlrm-mlperf", family="dlrm", n_dense=13,
        table_rows=_pad512(CRITEO_TB), embed_dim=128,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1)),
    smoke_config=RecsysConfig(
        name="dlrm-smoke", family="dlrm", n_dense=13,
        table_rows=(64, 32, 96, 48), embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(32, 16, 1)),
    shapes=RECSYS_SHAPES,
    source="[arXiv:1906.00091; paper]",
    notes=f"MLPerf DLRM (Criteo 1TB), 26 tables, {sum(CRITEO_TB):,} real "
          "rows (~266M); dot interaction. Paper technique: table "
          "quantization + binary apply; attention pruning N/A.",
)

DCN_V2 = ArchSpec(
    arch_id="dcn-v2",
    family="recsys",
    config=RecsysConfig(
        name="dcn-v2", family="dcn", n_dense=13,
        table_rows=_pad512(CRITEO_KAGGLE), embed_dim=16,
        n_cross_layers=3, top_mlp=(1024, 1024, 512)),
    smoke_config=RecsysConfig(
        name="dcn-smoke", family="dcn", n_dense=13,
        table_rows=(64, 32, 96), embed_dim=8, n_cross_layers=2,
        top_mlp=(32, 16)),
    shapes=RECSYS_SHAPES,
    source="[arXiv:2008.13535; paper]",
    notes="cross-network v2 (full-rank), stacked; Criteo Kaggle vocab",
)

DIN = ArchSpec(
    arch_id="din",
    family="recsys",
    config=RecsysConfig(
        name="din", family="din", table_rows=_pad512((AMAZON_ITEMS,)),
        embed_dim=18, seq_len=100, attn_mlp=(80, 40), top_mlp=(200, 80)),
    smoke_config=RecsysConfig(
        name="din-smoke", family="din", table_rows=(256,), embed_dim=8,
        seq_len=12, attn_mlp=(16, 8), top_mlp=(16, 8)),
    shapes=RECSYS_SHAPES,
    source="[arXiv:1706.06978; paper]",
    notes="target attention over user history (Amazon Electronics vocab). "
          "Paper technique transfers fully: attention-guided history "
          "pruning (din_prune_p) + table quantization — docs/design.md §5.",
)

DIEN = ArchSpec(
    arch_id="dien",
    family="recsys",
    config=RecsysConfig(
        name="dien", family="dien", table_rows=_pad512((AMAZON_ITEMS,)),
        embed_dim=18, seq_len=100, gru_dim=108, attn_mlp=(80, 40),
        top_mlp=(200, 80)),
    smoke_config=RecsysConfig(
        name="dien-smoke", family="dien", table_rows=(256,), embed_dim=8,
        seq_len=12, gru_dim=16, attn_mlp=(16, 8), top_mlp=(16, 8)),
    shapes=RECSYS_SHAPES,
    source="[arXiv:1809.03672; unverified]",
    notes="GRU interest extraction + AUGRU evolution",
)

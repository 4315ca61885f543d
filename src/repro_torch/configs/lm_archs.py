"""Assigned LM-family architecture configs (exact public configs).

The reference's ``repro.configs.lm_archs``, copied as data over the
port's ``LMConfig``: the dense glm4-9b, qwen2-1.5b and llama3.2-3b, and
the MoE llama4-scout (16 experts top-1, a shared expert, chunked-local
attention) and kimi-k2 (384 experts top-8).

long_500k policy (docs/design.md §6): glm4/qwen2/llama3.2/kimi-k2 are pure
full-attention per their public configs -> the 500k decode cell is skipped
for them; llama4-scout's public iRoPE design uses chunked-local attention
(chunk 8192, every 4th layer global) -> it runs long_500k.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

_FULL_ATTN_SKIP = ("pure full-attention arch: O(S^2) prefill/O(S) dense "
                   "decode state at 524k is out of scope per assignment; "
                   "see docs/design.md §6")

GLM4_9B = ArchSpec(
    arch_id="glm4-9b",
    family="lm",
    config=LMConfig(
        name="glm4-9b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, head_dim=128, qkv_bias=True,
        tie_embeddings=False, rope_theta=1e6, loss_chunk=256,
        activation_dtype="bfloat16"),
    smoke_config=LMConfig(
        name="glm4-9b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, head_dim=16, qkv_bias=True,
        tie_embeddings=False, q_chunk=16, loss_chunk=16),
    shapes=lm_shapes(long_skip=_FULL_ATTN_SKIP),
    source="[hf:THUDM/glm-4-9b; hf]",
    notes="dense, RoPE, GQA kv=2, QKV bias",
)

QWEN2_1_5B = ArchSpec(
    arch_id="qwen2-1.5b",
    family="lm",
    config=LMConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128, qkv_bias=True,
        tie_embeddings=True, rope_theta=1e6, loss_chunk=256,
        activation_dtype="bfloat16"),
    smoke_config=LMConfig(
        name="qwen2-1.5b-smoke", n_layers=2, d_model=48, n_heads=3,
        n_kv_heads=1, d_ff=96, vocab=128, head_dim=16, qkv_bias=True,
        tie_embeddings=True, q_chunk=16, loss_chunk=16),
    shapes=lm_shapes(long_skip=_FULL_ATTN_SKIP),
    source="[arXiv:2407.10671; hf]",
    notes="dense, GQA kv=2, QKV bias; ColQwen2.5 backbone family "
          "(12 heads don't divide the 16-way model axis: heads replicate, "
          "fused qkv_out=1536 still shards — docs/design.md §4)",
)

LLAMA32_3B = ArchSpec(
    arch_id="llama3.2-3b",
    family="lm",
    config=LMConfig(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=128,
        tie_embeddings=True, rope_theta=500000.0, loss_chunk=256,
        activation_dtype="bfloat16"),
    smoke_config=LMConfig(
        name="llama3.2-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=128, head_dim=16,
        tie_embeddings=True, q_chunk=16, loss_chunk=16),
    shapes=lm_shapes(long_skip=_FULL_ATTN_SKIP),
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
    notes="small llama3; GQA kv=8",
)

LLAMA4_SCOUT = ArchSpec(
    arch_id="llama4-scout-17b-a16e",
    family="lm",
    config=LMConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
        tie_embeddings=False, rope_theta=500000.0,
        n_experts=16, moe_top_k=1, moe_d_ff=8192, n_shared_experts=1,
        attn_chunk=8192, global_every=4, loss_chunk=256, q_chunk=128,
        activation_dtype="bfloat16"),
    smoke_config=LMConfig(
        name="llama4-scout-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=0, vocab=128, head_dim=16, tie_embeddings=False,
        n_experts=4, moe_top_k=1, moe_d_ff=96, n_shared_experts=1,
        attn_chunk=8, global_every=4, q_chunk=8, loss_chunk=16),
    shapes=lm_shapes(long_skip=None),   # chunked-local attn -> runs 500k
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
    notes="MoE 16e top-1 + shared expert; iRoPE chunked-local attention "
          "(chunk 8192, every 4th layer global) -> long_500k runs",
)

KIMI_K2 = ArchSpec(
    arch_id="kimi-k2-1t-a32b",
    family="lm",
    config=LMConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, d_ff=0, vocab=163840, head_dim=112,
        tie_embeddings=False, rope_theta=500000.0,
        n_experts=384, moe_top_k=8, moe_d_ff=2048, loss_chunk=256,
        q_chunk=256,
        param_dtype="bfloat16", activation_dtype="bfloat16"),
    smoke_config=LMConfig(
        name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=0, vocab=128, head_dim=16, tie_embeddings=False,
        n_experts=8, moe_top_k=2, moe_d_ff=32, q_chunk=16, loss_chunk=16),
    shapes=lm_shapes(long_skip=_FULL_ATTN_SKIP),
    source="[arXiv:2501.kimi2; unverified]",
    notes="1T-param MoE 384e top-8 (paper-table config). Trains with bf16 "
          "params + int8 Adam moments, ZeRO-sharded (docs/design.md §6): fp32 "
          "AdamW (16 B/param = 16.5 TB) cannot fit either mesh.",
)

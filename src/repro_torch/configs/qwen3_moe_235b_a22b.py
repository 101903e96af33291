"""qwen3-moe-235b-a22b [moe] — hf:Qwen/Qwen3-235B-A22B (family per spec).

94L, d_model=4096, 64 heads (GQA kv=4), per-expert d_ff=1536, vocab=151936,
MoE 128 experts top-8, QK-norm.

SpGEMM applicability: YES — dispatch/combine is the two-phase SpGEMM
specialization (routing = symbolic; grouped matmul = numeric). See
DESIGN.md §4. long_500k: skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=151_936,
    pattern=("moe",),
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    pattern=("moe",),
    head_dim=16,
    qk_norm=True,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (per-spec skip)"}

"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B.

48L, d_model=2048, 32 heads (GQA kv=4), per-expert d_ff=768, vocab=151936,
MoE 128 experts top-8, QK-norm.

SpGEMM applicability: YES (dispatch = two-phase SpGEMM; DESIGN.md §4).
long_500k: skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=151_936,
    pattern=("moe",),
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
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

"""qwen2-7b [dense] — arXiv:2407.10671, hf:Qwen/Qwen2-7B.

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064, QKV bias.
SpGEMM applicability: none. long_500k: skipped (pure full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=56,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    qkv_bias=True,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (per-spec skip)"}

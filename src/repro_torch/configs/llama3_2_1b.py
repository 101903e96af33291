"""llama3.2-1b [dense] — hf:meta-llama/Llama-3.2-1B (unverified tier).

16L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=128256.
SpGEMM applicability: none (dense matmul path) — DESIGN.md §Arch-applicability.
long_500k: skipped (pure full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    head_dim=64,
    rope_theta=500_000.0,
    tie_embeddings=True,
    act="silu",
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (per-spec skip)"}

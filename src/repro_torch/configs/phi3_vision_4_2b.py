"""phi-3-vision-4.2b [vlm] — hf:microsoft/Phi-3-vision-128k-instruct.

Backbone only (per spec): 32L, d_model=3072, 32 heads (kv=32 == MHA),
d_ff=8192, vocab=32064. Vision frontend is a STUB: input_specs() supplies
precomputed CLIP patch embeddings (num_patches x 1024) projected into the
token stream. SpGEMM applicability: none.
long_500k: skipped (pure full-attention backbone).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    head_dim=96,
    rope_theta=10_000.0,
    frontend="vision",
    frontend_dim=1024,
    num_patches=576,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    frontend="vision",
    frontend_dim=32,
    num_patches=16,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (per-spec skip)"}

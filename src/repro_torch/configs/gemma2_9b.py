"""gemma2-9b [dense] — arXiv:2408.00118, hf:google/gemma-2-9b.

42L, d_model=3584, 16 heads (GQA kv=8), d_ff=14336, vocab=256000,
alternating local(4096-window)/global attention, attn softcap 50,
final logit softcap 30, head_dim=256.

SpGEMM applicability: none (sliding-window = block-banded mask in the flash
kernel, not a sparse-matrix product).
long_500k: RUN as a hybrid-window cell — half the layers are 4096-window
local (bounded KV); global layers decode against the full 512k cache at
linear per-token cost. Recorded in DESIGN.md §Shape-cell skips.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=256_000,
    pattern=("local", "global"),
    head_dim=256,
    window=4_096,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    act="gelu",  # gemma2 uses GeGLU
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    pattern=("local", "global"),
    head_dim=16,
    window=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    act="gelu",
)

SKIP_SHAPES = {}

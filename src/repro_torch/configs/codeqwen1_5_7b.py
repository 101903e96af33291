"""codeqwen1.5-7b [dense] — hf:Qwen/CodeQwen1.5-7B (qwen1.5 arch).

32L, d_model=4096, 32 heads (GQA kv=32 == MHA), d_ff=13440, vocab=92416,
QKV bias. SpGEMM applicability: none. long_500k: skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13_440,
    vocab_size=92_416,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=112,
    vocab_size=256,
    head_dim=16,
    qkv_bias=True,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (per-spec skip)"}

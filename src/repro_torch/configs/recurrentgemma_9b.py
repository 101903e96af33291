"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin/RG-LRU).

38L, d_model=4096, 16 heads (MQA kv=1), d_ff=12288, vocab=256000,
RG-LRU : local-attention at 2:1 (pattern rec,rec,attn), window 2048,
lru_width=4096. 38 = 12*(rec,rec,attn) + (rec,rec) tail.

SpGEMM applicability: none. long_500k: RUN — recurrence carries O(1) state
and local attention keeps a bounded 2048-token KV window.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    pattern=("rec", "rec", "local"),
    tail=("rec", "rec"),
    head_dim=256,
    window=2_048,
    lru_width=4096,
    tie_embeddings=True,
    act="gelu",
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    pattern=("rec", "rec", "local"),
    tail=("rec", "rec"),
    head_dim=16,
    window=16,
    lru_width=64,
    tie_embeddings=True,
    act="gelu",
)

SKIP_SHAPES = {}

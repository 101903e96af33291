"""hubert-xlarge [audio] — arXiv:2106.07447 (encoder-only, w2v2 arch).

48L, d_model=1280, 16 heads (kv=16 == MHA), d_ff=5120, vocab=504 (unit
targets). Audio frontend is a STUB: input_specs() supplies precomputed
conv-feature frame embeddings (T x 512) projected to d_model.

SpGEMM applicability: none. Encoder-only: no decode step -> decode_32k and
long_500k are skipped; prefill_32k runs as an encoder forward pass.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    causal=False,  # bidirectional encoder
    frontend="audio",
    frontend_dim=512,
    act="gelu2",  # classic 2-matrix transformer FFN
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    head_dim=16,
    causal=False,
    frontend="audio",
    frontend_dim=32,
    act="gelu2",  # classic 2-matrix transformer FFN
)

SKIP_SHAPES = {
    "decode_32k": "encoder-only arch: no decode step",
    "long_500k": "encoder-only arch: no decode step",
}

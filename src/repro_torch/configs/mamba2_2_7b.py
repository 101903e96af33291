"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

64L, d_model=2560, attention-free, vocab=50280, ssm_state=128,
expand=2 (d_inner=5120), head_dim=64 (80 SSD heads).

SpGEMM applicability: none (dense scans). long_500k: RUN — SSM decode is
O(1)-state per token (the arch this shape exists for).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,  # unused for ssm layers
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    pattern=("ssm",),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    conv_width=4,
    tie_embeddings=True,
)

SKIP_SHAPES = {}

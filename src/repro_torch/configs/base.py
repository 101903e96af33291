"""Model/run configuration system (the port's copy of ``repro/configs``:
pure Python, field for field the reference's).

One ``ModelConfig`` per assigned architecture (exact shapes from the public
sources cited in each config file), plus reduced smoke variants. Layer
heterogeneity (gemma2 local/global alternation, recurrentgemma's 1:2
RG-LRU:attention pattern) is expressed as a repeating ``pattern`` + optional
``tail`` so the layer stack scans over homogeneous pattern groups
(compile-time friendly for 94-layer models).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | vlm | audio | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # layer stacking: pattern repeated, then tail. kinds: attn | local |
    # global | rec | moe  (each kind = attention/recurrence + its FFN)
    pattern: tuple = ("attn",)
    tail: tuple = ()

    head_dim: Optional[int] = None
    window: Optional[int] = None  # sliding window for 'local' layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    causal: bool = True  # False => encoder (hubert)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: Optional[int] = None

    # modality frontend stub: None | "vision" | "audio"
    frontend: Optional[str] = None
    frontend_dim: int = 0
    num_patches: int = 0  # vision: patch embeddings prepended

    norm_eps: float = 1e-6
    act: str = "silu"  # silu (swiglu) | gelu

    def __post_init__(self):
        n_pat = len(self.pattern)
        reps, rem = divmod(self.num_layers - len(self.tail), n_pat)
        if rem:
            from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
            raise SpgemmConfigError(
                f"{self.name}: {self.num_layers} layers != "
                f"{n_pat}*k + {len(self.tail)}"
            )

    @property
    def pattern_repeats(self) -> int:
        return (self.num_layers - len(self.tail)) // len(self.pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def param_count(self) -> int:
        """Approximate total parameters (embeddings + per-layer)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.is_encoder:
            total += 32_768 * d  # learned positions (MAX_ENCODER_POS)
        if self.frontend:
            total += self.frontend_dim * d
        # silu/gelu are gated 3-matrix FFNs (SwiGLU/GeGLU); gelu2 is plain
        ffn = (2 if self.act == "gelu2" else 3) * d * self.d_ff
        kinds = list(self.pattern) * self.pattern_repeats + list(self.tail)
        for kind in kinds:
            if kind in ("attn", "local", "global"):
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
                    self.num_heads * hd * d
                )
                total += attn + ffn
            elif kind == "moe":
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
                    self.num_heads * hd * d
                )
                moe = d * self.num_experts + self.num_experts * 3 * d * self.moe_d_ff
                total += attn + moe
            elif kind == "rec":
                w = self.lru_width or d
                # block-diagonal gates: 2 * nh * (w/nh)^2 = 2 w^2 / nh
                rec = 2 * d * w + w * d + 2 * w * w // self.num_heads
                total += rec + ffn
            elif kind == "ssm":
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                total += d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d
            else:
                from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
                raise SpgemmConfigError(f"unknown block kind {kind!r}")
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        kinds = list(self.pattern) * self.pattern_repeats + list(self.tail)
        n_moe = sum(1 for k in kinds if k == "moe")
        all_experts = n_moe * self.num_experts * 3 * d * self.moe_d_ff
        active = n_moe * self.experts_per_token * 3 * d * self.moe_d_ff
        return full - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: train or serve lowering."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

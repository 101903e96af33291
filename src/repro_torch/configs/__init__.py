"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
)

_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4_2b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def skip_reason(arch: str, shape: str) -> str | None:
    """Non-None if this (arch, shape) cell is skipped (with the reason)."""
    mod = importlib.import_module(_MODULES[arch])
    return mod.SKIP_SHAPES.get(shape)


def all_cells():
    """Yield every runnable (arch, shape) dry-run cell."""
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if skip_reason(arch, shape) is None:
                yield arch, shape


__all__ = [
    "ARCH_IDS",
    "get_config",
    "skip_reason",
    "all_cells",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
]

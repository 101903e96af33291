"""Model zoo (port of ``repro.models``): configurable transformer / SSM /
hybrid / MoE stacks in plain torch, running where their params live."""
from repro_torch.models.model import (
    cache_shardings,
    cache_template,
    decode_step,
    forward,
    init_cache,
    init_params,
    model_template,
    param_shardings,
    param_specs,
    place,
    place_batch,
)
from repro_torch.models.sharding import NO_SHARDING, ShardingRules

__all__ = [
    "forward",
    "decode_step",
    "init_params",
    "init_cache",
    "param_specs",
    "param_shardings",
    "cache_template",
    "cache_shardings",
    "model_template",
    "place",
    "place_batch",
    "ShardingRules",
    "NO_SHARDING",
]

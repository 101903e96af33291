"""Dry-run cell construction: (arch x shape x mesh) -> a runnable closure
on meta DTensors (port of ``repro/launch/cells.py``).

``input_specs`` gives meta stand-ins for every model input (shapes and
dtypes, nothing allocated). ``build_cell`` returns the step, prefill or
decode function with its args placed on the mesh as meta DTensors at the
reference's specs (the spec trees are kept beside them, as the
reference's ``in_shardings``). ``Cell.run()`` takes the place of
``lower()``: eager torch has nothing to lower, so the dry run counts one
run of the function (``op_cost.count_ops``). The mesh is a
``compat.DTensorMesh`` on the ``meta`` device
(``launch.mesh.make_production_mesh(device="meta")`` under a fake process
group, ``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import _tree
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import dp_size, rules_for_mesh
from repro_torch.models import (
    cache_shardings,
    cache_template,
    decode_step,
    forward,
    param_shardings,
    param_specs,
    place,
)
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.train.optim import AdamWConfig, OptState, adamw_init, zero1_shardings
from repro_torch.train.step import train_step

MICROBATCHES = {"moe": 4, "ssm": 4}  # by family; at least 2 where the heads do not divide


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    fn: Callable
    args: tuple  # meta DTensor trees (decode's position: an int)
    in_specs: tuple  # spec trees matching args (the reference's in_shardings)
    out_specs: Any
    donate_argnums: tuple = ()  # args the function writes in place
    num_microbatches: int = 1

    def arg_specs(self) -> list:
        """Every arg leaf's spec, in the args' flattening order."""
        out = []
        for specs, arg in zip(self.in_specs, self.args):
            _tree.map_specs(lambda spec, _: out.append(spec), specs, arg)
        return out

    def run(self):
        """One call of the function on its args: the counterpart of
        ``lower()`` (``op_cost.count_ops(cell.call, *cell.args)`` counts it)."""
        return self.call(*self.args)

    def call(self, *args):
        """The function on ``args``: training under autograd, prefill and
        decode under ``torch.no_grad``."""
        if self.shape.kind == "train":
            return self.fn(*args)
        with torch.no_grad():
            return self.fn(*args)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool):
    """Meta stand-ins + specs for one batch."""
    gb, t = shape.global_batch, shape.seq_len
    specs: dict[str, Any] = {}
    shards: dict[str, Any] = {}
    if cfg.frontend == "audio":
        specs["frames"] = _meta((gb, t, cfg.frontend_dim), torch.float32)
        shards["frames"] = ("__dp__", None, None)
    else:
        specs["tokens"] = _meta((gb, t), torch.int32)
        shards["tokens"] = ("__dp__", None)
        if cfg.frontend == "vision":
            specs["patches"] = _meta((gb, cfg.num_patches, cfg.frontend_dim), torch.float32)
            shards["patches"] = ("__dp__", None, None)
    if with_labels:
        specs["labels"] = _meta((gb, t), torch.int32)
        shards["labels"] = ("__dp__", None)
    return specs, shards


def _resolve_dp(tree, dp, gb: int, dp_total: int):
    """Replace the '__dp__' placeholder; drop it if batch doesn't divide."""
    use = dp if gb % dp_total == 0 else None
    return {k: tuple(use if d == "__dp__" else d for d in spec) for k, spec in tree.items()}


def input_specs(arch: str, shape_name: str):
    """Public deliverable: abstract input stand-ins for an (arch, shape)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    specs, _ = batch_specs(cfg, shape, with_labels=shape.kind == "train")
    return specs


def build_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False) -> Cell:
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    rules = rules_for_mesh(mesh)
    dp = rules.dp
    dp_total = dp_size(mesh)
    gb, t = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        p_meta = param_specs(cfg, rules, dtype=torch.float32)
        p_shard = param_shardings(cfg, rules)
        zero1 = zero1_shardings(p_shard, rules.dp_axes, dict(mesh.shape), p_meta)
        params = place(p_meta, p_shard, mesh)
        opt = adamw_init(params, mesh, zero1)
        opt_shard = OptState(mu=zero1, nu=zero1, step=())
        b_meta, b_shard = batch_specs(cfg, shape, with_labels=True)
        b_shard = _resolve_dp(b_shard, dp, gb, dp_total)
        batch = place(b_meta, b_shard, mesh)
        opt_cfg = AdamWConfig()
        # Microbatching keeps the per-step working set under HBM: MoE carries
        # big routing/dispatch buffers; SSD materializes chunk decay blocks;
        # qwen2's replicated-attention fallback keeps full-T q/kv per shard.
        num_microbatches = MICROBATCHES.get(cfg.family, 1)
        if cfg.num_heads % rules.tp_size:
            num_microbatches = max(num_microbatches, 2)

        def fn(params, opt_state, batch):
            return train_step(params, opt_state, batch, cfg, rules, opt_cfg, mesh=mesh,
                              num_microbatches=num_microbatches)

        metrics_shard = {"grad_norm": (), "lr": (), "loss": ()}
        return Cell(arch=arch, shape=shape, fn=fn, args=(params, opt, batch),
                    in_specs=(p_shard, opt_shard, b_shard),
                    out_specs=(p_shard, opt_shard, metrics_shard), donate_argnums=(0, 1),
                    num_microbatches=num_microbatches)

    if shape.kind == "prefill":
        p_shard = param_shardings(cfg, rules)
        params = place(param_specs(cfg, rules, dtype=torch.bfloat16), p_shard, mesh)
        b_meta, b_shard = batch_specs(cfg, shape, with_labels=False)
        b_shard = _resolve_dp(b_shard, dp, gb, dp_total)
        batch = place(b_meta, b_shard, mesh)
        return_caches = cfg.causal  # encoder has no serving cache

        def fn(params, batch):
            return forward(params, batch, cfg, rules, mesh=mesh, return_caches=return_caches,
                           remat=False, max_len=t)

        return Cell(arch=arch, shape=shape, fn=fn, args=(params, batch),
                    in_specs=(p_shard, b_shard), out_specs=None)

    # decode
    long_ctx = gb % dp_total != 0
    rules = dataclasses.replace(rules, decode=True, long_context=long_ctx)
    p_shard = param_shardings(cfg, rules)
    params = place(param_specs(cfg, rules, dtype=torch.bfloat16), p_shard, mesh)
    c_shard = cache_shardings(cfg, rules, gb, t, long_context=long_ctx)
    caches = place(cache_template(cfg, gb, max_len=t, dtype=COMPUTE_DTYPE), c_shard, mesh)
    tok_shard = (dp if gb % dp_total == 0 else None, None)
    tokens = place({"tokens": _meta((gb, 1), torch.int32)}, {"tokens": tok_shard},
                    mesh)["tokens"]
    # the reference traces an int32 scalar; the port's decode_step takes the
    # position as an int: the last slot, every cache entry live
    pos = t - 1

    def fn(params, caches, tokens, position):
        return decode_step(params, caches, tokens, position, cfg, rules, mesh=mesh, max_len=t)

    logits_shard = (dp if gb % dp_total == 0 else None, None, None)
    return Cell(arch=arch, shape=shape, fn=fn, args=(params, caches, tokens, pos),
                in_specs=(p_shard, c_shard, tok_shard, ()),
                out_specs=(logits_shard, c_shard), donate_argnums=(1,))

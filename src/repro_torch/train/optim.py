"""AdamW with ZeRO-1 optimizer-state specs and gradient clipping (port of
``repro/train/optim.py``).

Written out as the reference writes it, not ``torch.optim.AdamW``: moments
are f32 whatever the params' dtype, the update is computed in f32 and cast
back to the param's dtype, weight decay applies to matrices only (leaves of
two or more dims), and the clip scale is ``min(1, clip / (norm + 1e-9))`` of
the raw global norm. ``adamw_update`` writes params, moments and the step
counter in place under ``torch.no_grad()`` and returns them: the port's
counterpart of the reference launcher's donated buffers, which spares a
second copy of the state. ``zero1_shardings`` is the reference's pure
function of specs and shapes, over the port's plain-tuple specs; placing the
moments by it needs the 2-D data x model mesh, which the port does not have
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor  # 0-d int32, on the params' device


def adamw_init(params) -> OptState:
    """Zero f32 moments shaped like ``params``, each on its leaf's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    leaves = _tree.leaves(params)
    device = leaves[0].device if leaves else None
    return OptState(mu=_tree.tree_map(zeros, params), nu=_tree.tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf (a 0-d tensor)."""
    total = None
    for leaf in _tree.leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: OptState, params, cfg: AdamWConfig):
    """One AdamW step. Writes ``params``, ``state.mu``, ``state.nu`` and
    ``state.step`` in place and returns (params, state, metrics); metrics
    are 0-d tensors on the params' device: ``grad_norm`` (before the clip)
    and ``lr``."""
    state.step.add_(1)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, state.step)
    stepf = state.step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    for g, m, v, p in zip(_tree.leaves(grads), _tree.leaves(state.mu), _tree.leaves(state.nu),
                          _tree.leaves(params)):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = m / b1c
        delta.div_((v / b2c).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only (standard)
            delta.add_(p.to(torch.float32), alpha=cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.to(torch.float32).sub_(delta))
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def zero1_shardings(param_shardings, dp_axes: tuple, mesh_shape: dict, param_specs) -> Any:
    """Optimizer-moment specs: the param's TP spec + the data axes on the
    first dimension that is unsharded and divides by the DP size.
    ``param_shardings`` is a tree of spec tuples, ``param_specs`` the
    matching tree of shaped tensors (``models.param_specs``)."""
    dp_size = 1
    for ax in dp_axes:
        dp_size *= mesh_shape[ax]
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def shard_one(spec: tuple, shape) -> tuple:
        dims = list(spec) + [None] * (len(shape) - len(spec))
        # skip leaves already using the data axes (e.g. FSDP'd experts)
        used = set()
        for s in dims:
            for name in (s if isinstance(s, tuple) else (s,)):
                used.add(name)
        if any(ax in used for ax in dp_axes):
            return tuple(dims)
        for i, (s, n) in enumerate(zip(dims, shape)):
            if s is None and n % dp_size == 0 and n > 0:
                dims[i] = dp
                return tuple(dims)
        return tuple(dims)

    def walk(specs, shapes):
        if _is_spec(specs):
            return shard_one(specs, tuple(shapes.shape))
        if isinstance(specs, dict):
            return {k: walk(specs[k], shapes[k]) for k in specs}
        return type(specs)(walk(s, t) for s, t in zip(specs, shapes))

    return walk(param_shardings, param_specs)

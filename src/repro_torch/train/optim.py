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
function of specs and shapes, over the port's plain-tuple specs.

On a data x model mesh params and moments are DTensors, the moments placed
by ``zero1_shardings`` (``adamw_init(params, mesh, specs)``): the param's
TP placement plus the data axes on a dim. The update first takes each grad
to its moment's placement (a local slice of a replicated grad; the data-axis
reduce-scatter where the grad is still a partial sum), reads the global
norm from those shards (a local sum of squares, then one scalar reduction),
forms the update there, brings it back to the param's placement and writes
the param in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial

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


def adamw_init(params, mesh=None, specs=None) -> OptState:
    """Zero f32 moments shaped like ``params``, each on its leaf's device
    (placed as its leaf, for DTensor params), or on ``mesh`` at ``specs``,
    a tree of spec tuples (``zero1_shardings``)."""
    leaves = _tree.leaves(params)
    device = leaves[0].device if leaves else None
    step = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is not None:
        zeros = lambda spec, p: mesh.zeros(p.shape, spec)  # noqa: E731
        return OptState(mu=_tree.map_specs(zeros, specs, params),
                        nu=_tree.map_specs(zeros, specs, params), step=step)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(mu=_tree.tree_map(zeros, params), nu=_tree.tree_map(zeros, params),
                    step=step)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf (a 0-d tensor; whole on
    every rank for DTensor leaves). A DTensor leaf's square sums on its own
    shard; each rank adds up its shares of every leaf, and the total is
    reduced once, a scalar. (A leaf that is itself a partial sum is reduced
    first: take grads to their moments' placements before.)"""
    total, mesh = None, None
    for leaf in _tree.leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        if isinstance(sq, DTensor):
            mesh, sq = sq.device_mesh, _share(sq)
        total = sq if total is None else total + sq
    if mesh is not None:
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim).full_tensor()
    return torch.sqrt(total)


def _share(x: DTensor) -> torch.Tensor:
    """This rank's share of a 0-d DTensor, such that the shares of all ranks
    sum to it: its local value on the first rank of each mesh dim where it
    is replicated, zero on the others (exact)."""
    coord = x.device_mesh.get_coordinate()
    first = all(c == 0 for c, q in zip(coord, x.placements) if not q.is_partial())
    local = x.to_local()
    return local if first else torch.zeros_like(local)


def as_placed(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` at ``like``'s placements (DTensors); a tensor as it is."""
    if isinstance(like, DTensor) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


@torch.no_grad()
def adamw_update(grads, state: OptState, params, cfg: AdamWConfig):
    """One AdamW step. Writes ``params``, ``state.mu``, ``state.nu`` and
    ``state.step`` in place and returns (params, state, metrics); metrics
    are 0-d tensors on the params' device: ``grad_norm`` (before the clip)
    and ``lr``."""
    state.step.add_(1)
    grads = [as_placed(g, m) for g, m in zip(_tree.leaves(grads), _tree.leaves(state.mu))]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, state.step)
    stepf = state.step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    for i, (m, v, p) in enumerate(zip(_tree.leaves(state.mu), _tree.leaves(state.nu),
                                      _tree.leaves(params))):
        g, grads[i] = grads[i].to(torch.float32) * scale, None
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = m / b1c
        delta.div_((v / b2c).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only (standard)
            delta.add_(as_placed(p, m).to(torch.float32), alpha=cfg.weight_decay)
        delta.mul_(lr)
        delta = as_placed(delta, p)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.to(torch.float32).sub_(delta))
    return params, state, {"grad_norm": gnorm, "lr": lr}


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

    return _tree.map_specs(lambda spec, like: shard_one(spec, tuple(like.shape)),
                           param_shardings, param_specs)

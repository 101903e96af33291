"""Training step: loss, grads, AdamW update; optional microbatch accumulation
(port of ``repro/train/step.py``).

The step runs eagerly where the params live. Gradients come from
``torch.autograd.grad`` over the param leaves (nothing accumulates in
``.grad``), through ``forward(..., remat=True)``, which recomputes each
pattern repeat in the backward pass (``torch.utils.checkpoint``). With
``num_microbatches`` > 1 the batch is split on its leading axis and the f32
grads are summed ``/ n``, as the reference's ``lax.scan`` sums them. The
update writes params and optimizer state in place (``optim.adamw_update``).

A ``mesh`` or an enabled ``ShardingRules`` raises ``SpgemmConfigError``: the
data x model mesh is not ported yet (``models/sharding.MESH_ITEM``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward
from repro_torch.models.sharding import MESH_ITEM, ShardingRules
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.train.optim import AdamWConfig, adamw_update


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits: (B, T, V); labels: (B, T) int32.

    Computed in f32 with the max subtracted (and held out of the gradient);
    the labels are cast to int64 only for the gather."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - gold)


def _check_mesh(rules: ShardingRules, mesh) -> None:
    if mesh is not None or rules.enabled:
        raise SpgemmConfigError(
            f"a training step over a mesh or with enabled sharding rules needs the data x "
            f"model mesh, which the port does not have yet ({MESH_ITEM}); use NO_SHARDING")


def _grads_one(params, batch: dict, cfg: ModelConfig, rules: ShardingRules, mesh):
    """(loss, grads as a list in leaf order) of one batch."""
    leaves = _tree.leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        logits, _ = forward(_tree.unflatten(params, live), batch, cfg, rules, mesh=mesh,
                            remat=True)
        loss = cross_entropy_loss(logits, batch["labels"])
        del logits
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def loss_and_grads(params, batch: dict, cfg: ModelConfig, rules: ShardingRules, *,
                   mesh=None, num_microbatches: int = 1):
    """(loss, grads): the reference's ``value_and_grad`` of the step's loss,
    grads as a tree like ``params`` (the params' dtype; f32 when summed
    over microbatches)."""
    _check_mesh(rules, mesh)
    if num_microbatches <= 1:
        loss, grads = _grads_one(params, batch, cfg, rules, mesh)
        return loss, _tree.unflatten(params, grads)
    n = num_microbatches
    mbs = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
           for i in range(n)]
    leaves = _tree.leaves(params)
    loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grad_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    for mb in mbs:
        loss, grads = _grads_one(params, mb, cfg, rules, mesh)
        loss_acc = loss_acc + loss / n
        for acc, g in zip(grad_acc, grads):
            acc.add_(g.to(torch.float32) / n)
        del grads
    return loss_acc, _tree.unflatten(params, grad_acc)


def train_step(params, opt_state, batch: dict, cfg: ModelConfig, rules: ShardingRules,
               opt_cfg: AdamWConfig, *, mesh=None, num_microbatches: int = 1):
    """One optimizer step. batch: {'tokens'|'frames', 'labels'}. Returns
    (params, opt_state, metrics), params and state updated in place."""
    loss, grads = loss_and_grads(params, batch, cfg, rules, mesh=mesh,
                                 num_microbatches=num_microbatches)
    params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
    metrics["loss"] = loss
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, rules: ShardingRules,
                    opt_cfg: Optional[AdamWConfig] = None, *, mesh=None,
                    num_microbatches: int = 1):
    opt_cfg = opt_cfg or AdamWConfig()
    _check_mesh(rules, mesh)

    def fn(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, rules, opt_cfg, mesh=mesh,
                          num_microbatches=num_microbatches)

    return fn

"""Training step: loss, grads, AdamW update; optional microbatch accumulation
(port of ``repro/train/step.py``).

The step runs eagerly where the params live. Gradients come from
``torch.autograd.grad`` over the param leaves (nothing accumulates in
``.grad``), through ``forward(..., remat=True)``, which recomputes each
pattern repeat in the backward pass (``torch.utils.checkpoint``). With
``num_microbatches`` > 1 the batch is split on its leading axis and the f32
grads are summed ``/ n``, as the reference's ``lax.scan`` sums them. The
update writes params and optimizer state in place (``optim.adamw_update``).

With enabled ``ShardingRules`` the step runs on a data x model mesh
(``mesh``, a ``compat.DTensorMesh``) over DTensor params and moments; the
batch is placed over the data axes where it divides. The gradient's
reduction over the data axes is DTensor's backward (a replicated param's
grad comes back a partial sum, reduced where the update takes it to its
moment's placement), as GSPMD inserts it in the reference. The metrics are
whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.compat import local_range, whole
from repro_torch.models import forward, place_batch
from repro_torch.models.model import active_mesh
from repro_torch.models.sharding import ShardingRules
from repro_torch.train.optim import AdamWConfig, adamw_update, as_placed


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits: (B, T, V); labels: (B, T) int32.

    Computed in f32 with the max subtracted (and held out of the gradient);
    the labels are cast to int64 only for the gather."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    if isinstance(lf, DTensor):
        lse = torch.log(_sum_exp_sharded(lf, m)) + m[..., 0]
        gold = _gather_sharded(lf, labels)
    else:
        lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
        gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - gold)


def _vocab_placements(lf):
    """``lf``'s placements with the mesh dims that split its vocab
    replicated, and with them partial."""
    v = lf.ndim - 1
    vocab = [isinstance(q, Shard) and q.dim == v for q in lf.placements]
    return (tuple(Replicate() if s else q for s, q in zip(vocab, lf.placements)),
            tuple(Partial() if s else q for s, q in zip(vocab, lf.placements)))


def _sum_exp_sharded(lf, m):
    """``sum(exp(lf - m), -1)`` on DTensor logits, shard-local
    (``local_map``): each shard sums the vocab range it holds, a partial
    sum over the vocab's mesh axes, and its backward stays on the shard.
    Through DTensor's own ops the backward meets a whole gradient with the
    vocab-sharded exp, and torch 2.11's DTensor gathers the exp over the
    vocab for it (two f32 (B, T, V) tensors a rank: 31 GiB each at
    llama3.2-1b ``train_4k`` on 16 x 16)."""
    whole, part = _vocab_placements(lf)
    return local_map(lambda lf_l, m_l: torch.sum(torch.exp(lf_l - m_l), dim=-1),
                     out_placements=list(part), in_placements=(lf.placements, whole),
                     in_grad_placements=(lf.placements, whole), device_mesh=lf.device_mesh,
                     )(lf, m.redistribute(lf.device_mesh, whole))


def _gather_sharded(lf, labels):
    """``lf[..., labels]`` on DTensor logits, shard-local (``local_map``):
    each shard gathers the labels in the vocab range it holds, zero
    elsewhere, and the shards' values are a partial sum over the vocab's
    mesh axes, as GSPMD gathers from a sharded dim. (DTensor's own gather
    gives a masked partial sum that it fails to reduce into a sharded
    placement: ROADMAP Queue 3 item 11.)"""
    mesh, v = lf.device_mesh, lf.ndim - 1
    lab_pl, out_pl = _vocab_placements(lf)
    first, count = local_range(lf, v)

    def local(lf_l, lab_l):
        idx = lab_l.to(torch.int64) - first
        held = (idx >= 0) & (idx < count)
        got = torch.gather(lf_l, -1, idx.clamp(0, max(count - 1, 0))[..., None])[..., 0]
        return torch.where(held, got, 0.0)

    labels = labels.redistribute(mesh, lab_pl) if isinstance(labels, DTensor) \
        else DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    return local_map(local, out_placements=list(out_pl), in_placements=(lf.placements, lab_pl),
                     in_grad_placements=(lf.placements, lab_pl), device_mesh=mesh)(lf, labels)


def _grads_one(params, batch: dict, cfg: ModelConfig, rules: ShardingRules, mesh):
    """(loss, grads as a list in leaf order) of one batch."""
    leaves = _tree.leaves(params)
    if mesh is not None:
        batch = place_batch(batch, rules, mesh)
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
    over microbatches). On a mesh the loss is whole and each grad a DTensor
    (a partial sum over the data axes where its param is replicated).

    Microbatch ``i`` is rows ``[i B/n, (i+1) B/n)`` of the batch, the
    reference's ``reshape(n, B // n, ...)``. On a mesh the batch may come
    sharded over the data axes, and DTensor cannot reshape a sharded batch
    into n rows of microbatches unless the data size divides n (GSPMD can).
    So the split is a redistribution: the batch is gathered whole once a
    step (its token ids and labels, 8 B a token; an audio model's frames),
    each microbatch's rows sliced from it and placed over the data axes
    where they divide (``place_batch``). Splitting each rank's local rows
    instead would move nothing, but it needs n to divide every rank's rows
    and groups rows otherwise than the reference; this way any n that
    divides B works on any mesh, and each microbatch holds the reference's
    rows, so the sum over microbatches is ``NO_SHARDING``'s with the same
    n up to the order of f32 adds."""
    mesh = active_mesh(rules, mesh)
    if num_microbatches <= 1:
        loss, grads = _grads_one(params, batch, cfg, rules, mesh)
        return whole(loss), _tree.unflatten(params, grads)
    n = num_microbatches
    batch = {k: whole(v) for k, v in batch.items()}
    mbs = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
           for i in range(n)]
    leaves = _tree.leaves(params)
    loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grad_acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    for mb in mbs:
        loss, grads = _grads_one(params, mb, cfg, rules, mesh)
        loss_acc = loss_acc + whole(loss) / n
        for acc, g in zip(grad_acc, grads):
            acc.add_(as_placed(g, acc).to(torch.float32) / n)
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
    mesh = active_mesh(rules, mesh)

    def fn(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, rules, opt_cfg, mesh=mesh,
                          num_microbatches=num_microbatches)

    return fn

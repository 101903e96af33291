"""Mixture-of-Experts block (port of ``repro/models/moe.py``): the paper's
two-phase discipline applied to token -> expert dispatch.

  * symbolic phase — routing: top-k expert ids and in-expert positions from
    a stable sort by expert (counts only, no FLOPs on activations);
    capacity bounds each expert's buffer and overflowing assignments drop;
  * numeric phase — scatter tokens into (E_local, C, d) expert buffers, run
    the expert FFNs as three batched products, and combine weighted by the
    router's probabilities.

As in the reference, the numeric phase is plain batched products: the
hand-written grouped matmul is reached through ``kernels.ops.expert_matmul``
only. On a data x model mesh (``compat.DTensorMesh``) the block is expert
parallel, step for step the reference's ``shard_map``, here a
``local_map``: experts over 'model', tokens over the data axes, each
shard's capacity from its own tokens, the FSDP'd expert weights gathered
over the data axes in bf16, the sequence-parallel tokens gathered over
'model' on the way in; each shard's output is a partial sum over 'model'
(its experts' share), reduce-scattered over the sequence on the way out
(all-reduced when the sequence does not divide).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import gelu, rms_norm
from repro_torch.models.sharding import ShardingRules, check_mesh
from repro_torch.runtime.validate import SpgemmConfigError


def moe_params_template(cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": ((d, e), "norm"),
        "w1": ((e, d, f), "moe"),
        "w3": ((e, d, f), "moe"),
        "w2": ((e, f, d), "moe"),
        "norm": ((d,), "norm"),
    }


def routing_symbolic(logits: torch.Tensor, k: int, capacity: int,
                     num_experts: int):
    """Symbolic phase: (weights, expert_ids, slot_pos, keep_mask).

    logits: (T, E). slot_pos[t, j] = position of assignment j of token t
    inside its expert's capacity buffer; keep = slot_pos < capacity.
    Positions come from a stable sort of the assignment stream by expert
    and each assignment's rank within its expert's run.

    Top-k is a stable descending sort: tied probabilities go to the lower
    expert id first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order). Ties are real: ``init_params`` gives the router the
    role "norm", so its logits start all zero.
    """
    t = logits.shape[0]
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]  # (T, k)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    flat_ids = ids.reshape(-1)  # (T*k,) — assignment stream
    n = flat_ids.shape[0]
    sorted_ids, order = torch.sort(flat_ids, stable=True)
    # a scatter-add of ones, the reference's ``.at[sorted_ids].add(1)``
    # (``torch.bincount`` has no meta kernel, and the dry run runs on meta)
    counts = torch.zeros(num_experts, dtype=torch.int64, device=logits.device).scatter_add_(
        0, sorted_ids, torch.ones_like(sorted_ids))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=logits.device) - starts[sorted_ids]
    slot = torch.empty_like(rank_sorted)
    slot[order] = rank_sorted
    keep = slot < capacity
    return weights, ids, slot.reshape(t, k), keep.reshape(t, k)


def moe_ffn_local(x, router_w, w1, w3, w2, *, k: int, capacity: int,
                  num_experts: int, e_start, act):
    """Numeric phase for the experts [e_start, e_start + E_local).
    x: (T, d) tokens (full d)."""
    t, d = x.shape
    e_local = w1.shape[0]
    logits = x.float() @ router_w.float()  # (T, E)
    weights, ids, slot, keep = routing_symbolic(logits, k, capacity, num_experts)

    local = (ids >= e_start) & (ids < e_start + e_local) & keep  # (T, k)
    local_e = torch.where(local, ids - e_start, 0)
    local_slot = torch.where(local, slot, capacity)  # capacity slot == dropped

    # scatter token rows into (E_local, capacity+1, d); slot 'capacity' is
    # the drop bin (many writers, discarded). Each kept (expert, slot) has
    # one writer, so its row is the token's exactly.
    buf = torch.zeros((e_local, capacity + 1, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        buf.index_put_((local_e[:, j], local_slot[:, j]),
                       torch.where(local[:, j][:, None], x, 0), accumulate=True)
    xe = buf[:, :capacity]  # (E_local, C, d)

    # expert FFNs: three batched products
    gate_act = F.silu if act == "silu" else gelu
    h = gate_act(torch.einsum("ecd,edf->ecf", xe, w1.to(xe.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", xe, w3.to(xe.dtype))
    ye = torch.einsum("ecf,efd->ecd", h, w2.to(xe.dtype))  # (E_local, C, d)

    # combine: gather each assignment's output row, weight, sum over k
    ye_pad = torch.cat([ye, torch.zeros((e_local, 1, d), dtype=ye.dtype, device=ye.device)],
                       dim=1)
    out = torch.zeros((t, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        rows = ye_pad[local_e[:, j], local_slot[:, j]]  # (T, d)
        rows = rows * weights[:, j][:, None].to(rows.dtype)
        out = out + torch.where(local[:, j][:, None], rows, 0)
    return out


def moe_layer(p, x, cfg: ModelConfig, rules: ShardingRules,
              mesh=None, capacity_factor: float = 1.25):
    """Full MoE block: norm -> EP-sharded expert FFN -> residual delta.

    x: (B, T, d). With a mesh and a tp axis: experts split over 'model',
    tokens over the data axes (the module docstring). Without a mesh, or
    with sharding off: every expert on this device.
    """
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    b, t, d = h.shape
    k = cfg.experts_per_token
    e = cfg.num_experts

    def capacity_for(tokens: int, e_local: int) -> int:
        cap = int(tokens * k / e * capacity_factor) + 1
        return max(-(-cap // 8) * 8, 8)

    if mesh is None or not rules.enabled or rules.tp_axis is None:
        cap = capacity_for(b * t, e)
        y = moe_ffn_local(
            h.reshape(b * t, d), p["router"], p["w1"], p["w3"], p["w2"],
            k=k, capacity=cap, num_experts=e, e_start=0, act=cfg.act,
        )
        return y.reshape(b, t, d)

    check_mesh(mesh)
    if not isinstance(h, DTensor):
        raise SpgemmConfigError(
            f"expert parallelism over {rules.tp_axis!r} takes DTensor activations on the "
            f"mesh, got a plain {tuple(h.shape)} tensor")
    tp = rules.tp_axis
    dp = rules.dp_axes
    tp_size = rules.tp_size
    if e % tp_size:
        raise SpgemmConfigError(f"{e} experts do not split over the {tp_size} shards of {tp!r}")
    e_local = e // tp_size
    dp_size = 1
    for ax in dp:
        dp_size *= mesh.shape[ax]
    tokens_local = (b // dp_size) * t
    cap = capacity_for(tokens_local, e_local)
    # FSDP on expert weights: at rest each shard holds E/tp experts'
    # (d/dp)-slice; the full expert block is gathered over the data axes, in
    # bf16, per layer, and its grads come back reduce-scattered
    dp_flat = dp if len(dp) > 1 else dp[0]
    fsdp = (d % dp_size == 0) and (cfg.moe_d_ff % dp_size == 0) and dp_size > 1
    # sequence-parallel boundary: tokens arrive seq-sharded over 'model',
    # gathered in, the partial sums reduce-scattered out
    sp = t % tp_size == 0 and tp_size > 1
    h_spec = (dp_flat, tp if sp else None, None)

    def partial_over(spec, axes):
        out = list(mesh.placements(spec))
        for ax in axes:
            out[mesh.axis_names.index(ax)] = Partial()
        return tuple(out)

    h_in = mesh.placements((dp_flat, None, None))
    w_in = mesh.placements((tp, None, None))
    rep = mesh.placements((None, None))
    weights = [p[name].to(torch.bfloat16) if fsdp else p[name] for name in ("w1", "w3", "w2")]
    weights = [w.redistribute(mesh.device_mesh, w_in) for w in weights]

    def shard_fn(h_sh, router_w, w1, w3, w2):
        # h_sh: (B_loc, T, d), every token of this data shard; w: (E_local, ., .)
        e_start = mesh.local_index(tp) * e_local
        y = moe_ffn_local(
            h_sh.reshape(-1, d), router_w, w1, w3, w2,
            k=k, capacity=cap, num_experts=e, e_start=e_start, act=cfg.act,
        )
        return y.reshape(h_sh.shape)

    # each shard's output, and its grad of the tokens, are its experts'
    # share (partial over 'model'); its grads of the router and of its
    # experts' weights, its tokens' share (partial over the data axes)
    w_grad = partial_over((tp, None, None), dp)
    y = local_map(
        shard_fn,
        out_placements=list(partial_over((dp_flat, None, None), (tp,))),
        in_placements=(h_in, rep, w_in, w_in, w_in),
        in_grad_placements=(partial_over((dp_flat, None, None), (tp,)),
                            partial_over((None, None), (*dp, tp)), w_grad, w_grad, w_grad),
        device_mesh=mesh.device_mesh,
    )(h.redistribute(mesh.device_mesh, h_in),
      p["router"].redistribute(mesh.device_mesh, rep), *weights)
    return y.redistribute(mesh.device_mesh, mesh.placements(h_spec))

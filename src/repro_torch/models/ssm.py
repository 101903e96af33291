"""Mamba2 block (port of ``repro/models/ssm.py``): SSD (state-space duality)
with a chunked scan.

arXiv:2405.21060's minimal SSD: a decay-masked attention-like block within
each chunk plus a state recurrence across chunks, as a Python loop over
chunks (the reference's ``lax.scan``), so peak memory is one (B, Q, Q, H)
decay block. Decode is the O(1) state update.

Projections stay separate per component (z / x / BC / dt), as in the
reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.sharding import ShardingRules


class SSMCache(NamedTuple):
    state: torch.Tensor  # (B, H, P, N) f32
    conv_x: torch.Tensor  # (B, conv_w - 1, d_in)
    conv_bc: torch.Tensor  # (B, conv_w - 1, 2N)


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads


def ssm_params_template(cfg: ModelConfig):
    d = cfg.d_model
    d_in, n_heads = _dims(cfg)
    n = cfg.ssm_state
    k = cfg.conv_width
    return {
        "in_z": ((d, d_in), "ffn_in"),
        "in_x": ((d, d_in), "ffn_in"),
        "in_bc": ((d, 2 * n), "norm"),
        "in_dt": ((d, n_heads), "norm"),
        "conv_x_w": ((k, d_in), "conv_ch"),
        "conv_x_b": ((d_in,), "conv_ch1"),
        "conv_bc_w": ((k, 2 * n), "norm"),
        "conv_bc_b": ((2 * n,), "norm"),
        "a_log": ((n_heads,), "norm"),
        "d_skip": ((n_heads,), "norm"),
        "dt_bias": ((n_heads,), "norm"),
        "gate_norm": ((d_in,), "conv_ch1"),
        "out_proj": ((d_in, d), "ffn_out"),
        "norm": ((d,), "norm"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, T, C); w: (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _conv_step(window, w, b):
    """window: (B, K, C) -> (B, 1, C)."""
    out = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    return out[:, None, :]


def ssm_layer(p, x, cfg: ModelConfig, rules: ShardingRules, *,
              cache: SSMCache | None = None, return_cache: bool = False):
    """Pre-norm Mamba2 block. x: (B, T, d). Returns (delta, new_cache|None).

    cache given => decode (T == 1, O(1) state update). return_cache on the
    full-sequence path hands back the final state (prefill -> decode).
    """
    d_in, n_heads = _dims(cfg)
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    b_sz, t, _ = x.shape

    h = rules.gathered(rms_norm(x, p["norm"], cfg.norm_eps))
    z = h @ p["in_z"].to(h.dtype)  # (B, T, d_in) gate branch
    xs = h @ p["in_x"].to(h.dtype)  # (B, T, d_in)
    bc = h @ p["in_bc"].to(h.dtype)  # (B, T, 2N)
    dt_raw = h @ p["in_dt"].to(h.dtype)  # (B, T, H)
    if rules.enabled and rules.tp_axis and not rules.decode:
        tp_d = rules._tp_if(d_in)
        tp_h = rules._tp_if(n_heads)
        z = rules.constraint(z, (rules.dp, None, tp_d))
        xs = rules.constraint(xs, (rules.dp, None, tp_d))
        bc = rules.constraint(bc, (rules.dp, None, None))
        dt_raw = rules.constraint(dt_raw, (rules.dp, None, tp_h))

    new_cache = None
    if cache is None:
        xs_c = _causal_conv(xs, p["conv_x_w"].to(xs.dtype), p["conv_x_b"].to(xs.dtype))
        bc_c = _causal_conv(bc, p["conv_bc_w"].to(bc.dtype), p["conv_bc_b"].to(bc.dtype))
    else:
        win_x = torch.cat([cache.conv_x, xs], dim=1)
        win_bc = torch.cat([cache.conv_bc, bc], dim=1)
        xs_c = _conv_step(win_x, p["conv_x_w"], p["conv_x_b"]).to(xs.dtype)
        bc_c = _conv_step(win_bc, p["conv_bc_w"], p["conv_bc_b"]).to(bc.dtype)
    xs_c = F.silu(xs_c)
    bc_c = F.silu(bc_c)
    b_in, c_out = bc_c[..., :n], bc_c[..., n:]  # (B, T, N) each
    xh = xs_c.reshape(b_sz, t, n_heads, hd)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B, T, H)
    a = -torch.exp(p["a_log"].float())  # (H,)
    da = dt * a[None, None, :]  # (B, T, H) — log-decay per step
    dx = xh.float() * dt[..., None]  # dt-scaled input

    if cache is None:
        if rules.enabled and rules.tp_axis and not rules.decode:
            tp_h = rules._tp_if(n_heads)
            dx = rules.constraint(dx, (rules.dp, None, tp_h, None))
            da = rules.constraint(da, (rules.dp, None, tp_h))
        y, final_state = _ssd_shards(
            dx, da, b_in.float(), c_out.float(), chunk=min(cfg.ssm_chunk, t),
        )
        if return_cache:
            kw = cfg.conv_width - 1
            new_cache = SSMCache(
                state=final_state, conv_x=xs[:, -kw:], conv_bc=bc[:, -kw:]
            )
    else:
        # decode: S = exp(da) * S + dx (x) b ;  y = C . S
        s = cache.state  # (B, H, P, N)
        decay = torch.exp(da[:, 0])  # (B, H)
        s = s * decay[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", dx[:, 0], b_in[:, 0].float()
        )
        y = torch.einsum("bhpn,bn->bhp", s, c_out[:, 0].float())
        y = y[:, None]  # (B, 1, H, P)
        new_cache = SSMCache(state=s, conv_x=win_x[:, 1:], conv_bc=win_bc[:, 1:])

    y = y + xh.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b_sz, t, d_in)
    # gated RMSNorm then out projection
    y = rms_norm(y.to(x.dtype), p["gate_norm"], cfg.norm_eps)
    y = y * F.silu(z.to(y.dtype))
    delta = y @ p["out_proj"].to(y.dtype)
    return rules.gathered(delta), new_cache


def _ssd_shards(dx, da, b_in, c_out, chunk: int):
    """``_ssd_chunked`` of DTensors shard by shard (``local_map``): each
    batch row and head scans on its own (B and C are shared by the heads,
    so their gradients are partial sums over a split of the heads).
    DTensor's own batched matmuls would view batch and heads as one dim,
    which it cannot do when both are split (torch 2.11 refuses it). Plain
    tensors run as they are."""
    if not isinstance(dx, DTensor):
        return _ssd_chunked(dx, da, b_in, c_out, chunk)
    mesh = dx.device_mesh
    # batch and heads as dx has them, the time axis whole, B and C by batch
    xs_pl = [q if isinstance(q, Shard) and q.dim in (0, 2) else Replicate()
             for q in dx.placements]
    bc_pl = [q if q == Shard(0) else Replicate() for q in xs_pl]
    dx, da = dx.redistribute(mesh, xs_pl), da.redistribute(mesh, xs_pl)
    b_in, c_out = b_in.redistribute(mesh, bc_pl), c_out.redistribute(mesh, bc_pl)
    heads = [q == Shard(2) for q in xs_pl]
    state = [Shard(1) if h else q for h, q in zip(heads, xs_pl)]
    bc_grad = [Partial() if h else q for h, q in zip(heads, bc_pl)]
    return local_map(
        lambda *a: _ssd_chunked(*a, chunk=chunk), out_placements=(xs_pl, state),
        in_placements=(xs_pl, xs_pl, bc_pl, bc_pl),
        in_grad_placements=(xs_pl, xs_pl, bc_grad, bc_grad), device_mesh=mesh,
    )(dx, da, b_in, c_out)


def _ssd_chunked(dx, da, b_in, c_out, chunk: int):
    """Minimal SSD: dx (B,T,H,P), da (B,T,H), b/c (B,T,N).

    Returns (y (B,T,H,P) f32, final state (B,H,P,N)).
    """
    b_sz, t, n_heads, hd = dx.shape
    n = b_in.shape[-1]
    pad = (-t) % chunk
    if pad:
        dx = F.pad(dx, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_out = F.pad(c_out, (0, 0, 0, pad))
    tp = t + pad
    nc = tp // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dx.device))
    state = torch.zeros((b_sz, n_heads, hd, n), dtype=torch.float32, device=dx.device)
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        dxq, daq, bq, cq = dx[:, sl], da[:, sl], b_in[:, sl], c_out[:, sl]
        da_cs = torch.cumsum(daq, dim=1)  # (B,Q,H)
        # intra-chunk: L[l,s] = exp(da_cs[l] - da_cs[s]) for l >= s; masked
        # before the exp (exp(-inf) = 0, the reference's zeros), so that the
        # l < s entries, which can overflow to inf, give a zero gradient
        # where the reference's where-after-exp gives NaN
        ldiff = da_cs[:, :, None, :] - da_cs[:, None, :, :]  # (B,Q,Q,H)
        l_mat = torch.exp(torch.where(tri[None, :, :, None], ldiff, float("-inf")))
        scores = torch.einsum("bln,bsn->bls", cq, bq)  # (B,Q,Q)
        y_diag = torch.einsum("bls,blsh,bshp->blhp", scores, l_mat, dxq)
        # contribution of incoming state
        state_decay = torch.exp(da_cs)  # (B,Q,H)
        y_off = torch.einsum("bln,bhpn,blh->blhp", cq, state, state_decay)
        # update state
        chunk_decay = torch.exp(da_cs[:, -1, :])  # (B,H)
        in_decay = torch.exp(da_cs[:, -1:, :] - da_cs)  # (B,Q,H)
        state = state * chunk_decay[:, :, None, None] + torch.einsum(
            "bsn,bsh,bshp->bhpn", bq, in_decay, dxq
        )
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)
    return y[:, :t], state

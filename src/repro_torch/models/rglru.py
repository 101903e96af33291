"""RG-LRU recurrent block (port of ``repro/models/rglru.py``; recurrentgemma /
Griffin, arXiv:2402.19427).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(c * log(sigmoid(L)) * r_t),  r/i = input-dependent gates.

A full sequence runs the linear recurrence as a log-depth doubling scan over
T (the reference's ``associative_scan``; torch has no public one): it
differs from a step-by-step loop only by reassociation. Decode is the O(1)
per-token update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import gelu, rms_norm
from repro_torch.models.sharding import ShardingRules

LRU_C = 8.0  # Griffin's fixed exponent scale


class RGLRUCache(NamedTuple):
    state: torch.Tensor  # (B, W) f32
    conv: torch.Tensor  # (B, conv_w - 1, W)


def rglru_params_template(cfg: ModelConfig):
    """Gates are block-diagonal over heads — (H, W/H, W/H) blocks."""
    d = cfg.d_model
    w = cfg.lru_width or d
    nh = cfg.num_heads
    bw = w // nh
    return {
        "proj_x": ((d, w), "ffn_in"),
        "proj_gate": ((d, w), "ffn_in"),
        "conv_w": ((cfg.conv_width, w), "conv_ch"),
        "conv_b": ((w,), "conv_ch1"),
        "gate_a_w": ((nh, bw, bw), "gate_block"),
        "gate_a_b": ((w,), "conv_ch1"),
        "gate_i_w": ((nh, bw, bw), "gate_block"),
        "gate_i_b": ((w,), "conv_ch1"),
        "lam": ((w,), "conv_ch1"),
        "proj_out": ((w, d), "ffn_out"),
        "norm": ((d,), "norm"),
    }


def _causal_conv(x, w, b):
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _gates(p, xs):
    """a and the gated input, in f32, via block-diagonal (per-head) weights.

    xs: (B, T, W) -> reshaped (B, T, H, W/H)."""
    nh, bw, _ = p["gate_a_w"].shape
    b, t, w = xs.shape
    xf = xs.float().reshape(b, t, nh, bw)
    r = torch.sigmoid(
        torch.einsum("bthw,hwv->bthv", xf, p["gate_a_w"].float()).reshape(b, t, w)
        + p["gate_a_b"].float()
    )
    i = torch.sigmoid(
        torch.einsum("bthw,hwv->bthv", xf, p["gate_i_w"].float()).reshape(b, t, w)
        + p["gate_i_b"].float()
    )
    log_a0 = -F.softplus(-p["lam"].float())  # log sigmoid(L)
    log_a = LRU_C * log_a0[None, None, :] * r  # (B, T, W)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i * xs.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over dim 1 with h_{-1} = 0, in ceil(log2 T)
    doubling passes: after the pass of offset d, (a_t, b_t) composes the
    steps (t - 2d, t]."""
    t = a.shape[1]
    d = 1
    while d < t:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_layer(p, x, cfg: ModelConfig, rules: ShardingRules, *,
                cache: RGLRUCache | None = None, return_cache: bool = False):
    """Pre-norm recurrent block. x: (B, T, d). Returns (delta, cache|None)."""
    h = rules.gathered(rms_norm(x, p["norm"], cfg.norm_eps))
    xs = h @ p["proj_x"].to(h.dtype)  # (B, T, W)
    gate = h @ p["proj_gate"].to(h.dtype)
    if rules.enabled and rules.tp_axis and cache is None:
        tp_w = rules._tp_if(xs.shape[-1])
        xs = rules.constraint(xs, (rules.dp, None, tp_w))
        gate = rules.constraint(gate, (rules.dp, None, tp_w))

    new_cache = None
    if cache is None:
        xs_c = _causal_conv(xs, p["conv_w"].to(xs.dtype), p["conv_b"].to(xs.dtype))
        a, b_term = _gates(p, xs_c)
        hseq = linear_scan(a, b_term)
        y = hseq
        if return_cache:
            new_cache = RGLRUCache(
                state=hseq[:, -1], conv=xs[:, -(p["conv_w"].shape[0] - 1):]
            )
    else:
        window = torch.cat([cache.conv, xs], dim=1)
        xs_c = (
            torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
            + p["conv_b"].float()
        )[:, None, :].to(xs.dtype)
        a, b_term = _gates(p, xs_c)  # (B, 1, W)
        s = cache.state * a[:, 0] + b_term[:, 0]
        y = s[:, None, :]
        new_cache = RGLRUCache(state=s, conv=window[:, 1:])

    y = y.to(x.dtype) * gelu(gate)
    delta = y @ p["proj_out"].to(y.dtype)
    return rules.gathered(delta), new_cache

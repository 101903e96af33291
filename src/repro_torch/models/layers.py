"""Core transformer layers (port of ``repro/models/layers.py``): norms, RoPE,
blockwise attention, FFN.

Attention is blockwise in plain torch, as the reference's is in XLA: a
Python loop over static query chunks and, inside each, over KV blocks with
an online softmax, so a long prefill never materializes a (T, T) score
matrix. The chunks, blocks, window starts and padding masks are the
reference's, in its order. The reference's models call no kernel here, and
neither does the port: the hand-written attention kernel is reached through
``kernels.ops.attention`` only.

GQA is computed in full query-head space (KV repeated to Hq, each KV head
``group`` times in a row). RoPE and the attention math run in f32 and cast
back to the activations' dtype.

On a decode step ``attention_layer`` writes the new K/V into the cache it is
given and returns that cache: the port's counterpart of the reference's
donated cache buffers (ROADMAP Queue 3). A DTensor cache (a data x model
mesh) is written shard by shard: each rank writes the slots it holds.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.compat import local_range, replicated
from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import ShardingRules

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -2.0 ** 30


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (T,) int32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = replicated(torch.exp(
        -math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half
    ), x)
    angles = positions.float()[:, None] * freqs  # (T, half)
    cos = torch.cos(angles)[None, :, None, :]  # (1, T, 1, half)
    sin = torch.sin(angles)[None, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return s
    return torch.tanh(s / cap) * cap


def repeat_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """(B, T, Hkv, hd) -> (B, T, Hq, hd): each KV head ``group`` times in a
    row (``jnp.repeat``, not ``Tensor.repeat``)."""
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=2)


# --------------------------------------------------------------------------
# blockwise attention (train / prefill)
# --------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, causal: bool, window: Optional[int],
                        softcap: Optional[float], q_chunk: int = 1024,
                        k_block: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """q/k/v: (B, T, H, hd), same H (KV pre-repeated) -> (B, Tq, H, hd).

    Query chunks in a Python loop, each with its static KV extent (causal and
    window blocks past it are skipped); KV blocks in an inner loop with an
    online softmax, so the largest temporary is a (B, H, q_chunk, k_block)
    score tile. The queries are positions ``q_offset`` on of the keys' (a
    shard of the sequence). Plain tensors: on a mesh ``attention_shards``
    runs it on each shard's.
    """
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, tq)
    k_block = min(k_block, tk)
    dev = q.device

    out_chunks = []
    n_chunks = -(-tq // q_chunk)
    for ci in range(n_chunks):
        s_q = ci * q_chunk
        e_q = min(s_q + q_chunk, tq)
        cq = e_q - s_q
        kv_end = tk if not causal else min(tk, q_offset + e_q)
        kv_start = 0
        if window is not None:
            kv_start = (max(0, q_offset + s_q - window + 1) // k_block) * k_block
        nb = max(-(-(kv_end - kv_start) // k_block), 1)

        qc = q[:, s_q:e_q].float() * scale  # (B,cq,H,hd)
        end = min(kv_start + nb * k_block, tk)
        k_sl = k[:, kv_start:end]
        v_sl = v[:, kv_start:end]
        pad = nb * k_block - k_sl.shape[1]
        if pad:
            k_sl = F.pad(k_sl, (0, 0, 0, 0, 0, pad))
            v_sl = F.pad(v_sl, (0, 0, 0, 0, 0, pad))

        qpos = q_offset + s_q + torch.arange(cq, dtype=torch.int32, device=dev)
        m_prev = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        l_prev = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        for bi in range(nb):
            kblk = k_sl[:, bi * k_block:(bi + 1) * k_block]
            vblk = v_sl[:, bi * k_block:(bi + 1) * k_block]
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kblk.float())
            s = _softcap(s, softcap)
            kpos = kv_start + bi * k_block + torch.arange(k_block, dtype=torch.int32, device=dev)
            mask = (kpos < tk)[None, :].expand(cq, k_block)  # padding
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_cur = torch.maximum(m_prev, torch.amax(s, dim=-1))
            p = torch.exp(s - m_cur[..., None])
            alpha = torch.exp(m_prev - m_cur)
            l_prev = l_prev * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk.float())
            m_prev = m_cur
        l_f = torch.where(l_prev == 0.0, 1.0, l_prev)
        oc = (acc / l_f[..., None]).transpose(1, 2)  # (B,cq,H,hd)
        out_chunks.append(oc.to(q.dtype))
    return torch.cat(out_chunks, dim=1)


def attention_shards(q, k, v, **kw) -> torch.Tensor:
    """``blockwise_attention`` of DTensors shard by shard (``local_map``):
    every batch row and head is independent, so each shard runs the plain
    blockwise attention on the rows and heads it holds; a query shard of
    the sequence (heads that do not split) starts at its offset, against
    whole keys, whose gradient is then a partial sum over that axis.
    DTensor's own batched matmuls would view batch and heads as one dim,
    which it cannot do when both are split (torch 2.11 refuses it). Plain
    tensors run as they are."""
    if not isinstance(q, DTensor):
        return blockwise_attention(q, k, v, **kw)
    first, _ = local_range(q, 1)
    kv_grad = [Partial() if isinstance(a, Shard) and a.dim == 1 and not isinstance(b, Shard)
               else b for a, b in zip(q.placements, k.placements)]
    return local_map(
        lambda ql, kl, vl: blockwise_attention(ql, kl, vl, q_offset=first, **kw),
        out_placements=list(q.placements), in_placements=(q.placements, k.placements, v.placements),
        in_grad_placements=(q.placements, kv_grad, kv_grad), device_mesh=q.device_mesh,
    )(q, k, v)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: Optional[int],
                     softcap: Optional[float], ring: bool = False) -> torch.Tensor:
    """One-token attention against a (possibly ring-buffer) cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, S, H, hd) (KV pre-repeated);
    pos: the query's absolute position (cache holds pos' <= pos).
    ring=True: S == window and slot i holds absolute position
    pos - ((pos - i) mod S).
    """
    b, s, h, hd = k_cache.shape
    scale = 1.0 / math.sqrt(hd)
    qs = q.float() * scale
    scores = torch.einsum("bqhd,bshd->bhqs", qs, k_cache.float())  # (B,H,1,S)
    scores = _softcap(scores, softcap)
    idx = replicated(torch.arange(s, dtype=torch.int32, device=q.device), q)
    if ring:
        abs_pos = pos - torch.remainder(pos - idx, s)
        mask = (abs_pos >= 0) & (abs_pos <= pos)
        if window is not None:
            mask = mask & (pos - abs_pos < window)
    else:
        mask = idx <= pos
        if window is not None:
            mask = mask & (pos - idx < window)
    scores = torch.where(mask[None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, v_cache.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# attention layer (QKV/O + rope + norm)
# --------------------------------------------------------------------------


def write_slots(buf: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``buf[:, slot:slot + n] = new`` for (B, S, ...) ``buf`` and (B, n, ...)
    ``new``. On a DTensor ``buf``, ``new`` is taken to ``buf``'s placements
    with its dim 1 whole, and each rank writes the slots of dim 1 it holds
    (DTensor's slicing of a sharded dim would gather it into a copy)."""
    n = new.shape[1]
    if not isinstance(buf, DTensor):
        buf[:, slot:slot + n] = new
        return
    whole = [Replicate() if isinstance(q, Shard) and q.dim == 1 else q for q in buf.placements]
    new = new.to(buf.dtype).redistribute(buf.device_mesh, whole).to_local()
    first, count = local_range(buf, 1)
    lo, hi = max(slot, first), min(slot + n, first + count)
    if lo < hi:
        buf.to_local()[:, lo - first:hi - first] = new[:, lo - slot:hi - slot]


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, S, Hkv, hd)
    v: torch.Tensor


def attn_params_template(cfg: ModelConfig):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    t = {
        "wq": ((d, hq, hd), "wq"),
        "wk": ((d, hkv, hd), "wkv"),
        "wv": ((d, hkv, hd), "wkv"),
        "wo": ((hq, hd, d), "wo"),
        "norm": ((d,), "norm"),
    }
    if cfg.qkv_bias:
        t["bq"] = ((hq, hd), "norm")
        t["bk"] = ((hkv, hd), "norm")
        t["bv"] = ((hkv, hd), "norm")
    if cfg.qk_norm:
        t["q_norm"] = ((hd,), "norm")
        t["k_norm"] = ((hd,), "norm")
    return t


def attention_layer(p, x, cfg: ModelConfig, rules: ShardingRules, *,
                    window: Optional[int], positions: torch.Tensor,
                    cache: Optional[AttnCache] = None,
                    pos: Optional[int] = None,
                    ring: bool = False,
                    return_cache: bool = False):
    """Pre-norm attention block. Returns (residual_delta, new_cache|None).

    Prefill/train: cache None -> full-sequence blockwise attention; with
    return_cache=True the fresh (k, v) are handed back (prefill serving).
    Decode: cache given, x is (B, 1, d), ``pos`` the absolute position; the
    new K/V are written into ``cache`` at the position's slot (clamped to
    the cache, as ``dynamic_update_slice`` clamps), and ``cache`` returned.
    """
    group = cfg.num_heads // cfg.num_kv_heads
    h = rules.gathered(rms_norm(x, p["norm"], cfg.norm_eps))
    q = torch.einsum("btd,dhk->bthk", h, p["wq"].to(h.dtype))
    k = torch.einsum("btd,dhk->bthk", h, p["wk"].to(h.dtype))
    v = torch.einsum("btd,dhk->bthk", h, p["wv"].to(h.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.causal:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = rules.attn_activations(q, cfg.num_heads)

    new_cache = None
    if cache is None:
        kr = rules.attn_kv(repeat_kv(k, group), cfg.num_heads)
        vr = rules.attn_kv(repeat_kv(v, group), cfg.num_heads)
        out = attention_shards(q, kr, vr, causal=cfg.causal, window=window,
                               softcap=cfg.attn_softcap)
        if return_cache:  # at the decode caches' layout: the sequence split
            spec = rules.kv_cache_spec(k.shape[0], k.shape[2])
            new_cache = AttnCache(k=rules.constraint(k, spec), v=rules.constraint(v, spec))
    else:
        s = cache.k.shape[1]
        slot = pos % s if ring else pos
        slot = min(max(slot, 0), s - k.shape[1])
        write_slots(cache.k, k, slot)
        write_slots(cache.v, v, slot)
        k_c = rules.kv_cache_constraint(cache.k)
        v_c = rules.kv_cache_constraint(cache.v)
        out = decode_attention(
            q, repeat_kv(k_c, group), repeat_kv(v_c, group), pos,
            window=window, softcap=cfg.attn_softcap, ring=ring,
        )
        new_cache = cache
    out = rules.attn_activations(out, cfg.num_heads)
    delta = torch.einsum("bthk,hkd->btd", out, p["wo"].to(out.dtype))
    return rules.gathered(delta), new_cache


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------


def ffn_params_template(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu2":  # plain 2-matrix FFN (hubert)
        return {
            "w1": ((d, f), "ffn_in"),
            "w2": ((f, d), "ffn_out"),
            "norm": ((d,), "norm"),
        }
    return {
        "w1": ((d, f), "ffn_in"),
        "w3": ((d, f), "ffn_in"),
        "w2": ((f, d), "ffn_out"),
        "norm": ((d,), "norm"),
    }


def ffn_layer(p, x, cfg: ModelConfig, rules: ShardingRules):
    h = rules.gathered(rms_norm(x, p["norm"], cfg.norm_eps))
    if cfg.act == "gelu2":
        u = gelu(h @ p["w1"].to(h.dtype))
        return rules.gathered(u @ p["w2"].to(h.dtype))
    gate_act = F.silu if cfg.act == "silu" else gelu
    u = gate_act(h @ p["w1"].to(h.dtype)) * (h @ p["w3"].to(h.dtype))
    return rules.gathered(u @ p["w2"].to(h.dtype))

"""Serving engine (port of ``repro/serve/engine.py``): batched prefill, then
decode with static-shape caches.

The prefill -> decode handoff pads full-length prefill KV into the max_len
decode buffers (ring-compacting 'local' layers to their window). Decode is
eager: each step writes into the caches in place (the reference donates
them to a jitted step). The engine runs where its params live; with enabled
``rules`` on a data x model ``mesh`` the params are DTensors (``models.place``),
prompts are placed over the data axes, the decode caches are taken to
``cache_shardings`` after the handoff, and ``generate`` returns whole tokens.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.compat import whole
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache_shardings, decode_step, forward, place
from repro_torch.models.layers import AttnCache
from repro_torch.models.model import _cache_len, active_mesh
from repro_torch.models.sharding import NO_SHARDING, ShardingRules


def _pad_attn_cache(prefill_c: AttnCache, kind: str, cfg: ModelConfig,
                    t: int, max_len: int, stacked: bool) -> AttnCache:
    """Place (B, T, Hkv, hd) prefill KV into the (B, S, Hkv, hd) decode
    buffer. Local layers keep the last `window` positions at ring slots
    consistent with absolute positions."""
    s = _cache_len(cfg, kind, max_len)
    t_axis = 2 if stacked else 1

    def place(x):
        n = x.shape[t_axis]
        if s >= n:
            pad = [0, 0] * (x.ndim - t_axis - 1) + [0, s - n]
            return F.pad(x, pad)
        # ring: keep last s positions; absolute position p -> slot p % s
        start = n - s
        sl = x.narrow(t_axis, start, s)
        return torch.roll(sl, start % s, dims=t_axis)

    return AttnCache(k=place(prefill_c.k), v=place(prefill_c.v))


def prefill_to_cache(prefill_caches, cfg: ModelConfig, t: int, max_len: int):
    """Convert forward(return_caches=True) output into decode buffers."""
    out_blocks = []
    for kind, c in zip(cfg.pattern, prefill_caches["blocks"]):
        if isinstance(c, AttnCache):
            out_blocks.append(_pad_attn_cache(c, kind, cfg, t, max_len, True))
        else:
            out_blocks.append(c)  # ssm / rec states are already final
    out_tail = []
    for kind, c in zip(cfg.tail, prefill_caches["tail"]):
        if isinstance(c, AttnCache):
            out_tail.append(_pad_attn_cache(c, kind, cfg, t, max_len, False))
        else:
            out_tail.append(c)
    return {"blocks": out_blocks, "tail": out_tail}


class ServeEngine:
    """Minimal batched serving: prefill a prompt batch, then greedy (or
    sampled) decode."""

    def __init__(self, params, cfg: ModelConfig,
                 rules: Optional[ShardingRules] = None, mesh=None,
                 max_len: int = 512):
        self.params = params
        self.cfg = cfg
        self.rules = rules or NO_SHARDING
        self.mesh = mesh
        self.max_len = max_len
        active_mesh(self.rules, mesh, params)  # enabled rules: params on a data x model mesh
        self._decode = partial(decode_step, cfg=cfg, rules=self.rules, mesh=mesh,
                               max_len=max_len)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens: (B, T). Returns (last_logits, caches, next_pos)."""
        t = tokens.shape[1]
        logits, caches = forward(
            self.params, {"tokens": tokens}, self.cfg, self.rules,
            mesh=self.mesh, return_caches=True, remat=False,
            max_len=self.max_len,
        )
        caches = prefill_to_cache(caches, self.cfg, t, self.max_len)
        if self.rules.enabled:
            specs = cache_shardings(self.cfg, self.rules, tokens.shape[0], self.max_len,
                                    long_context=self.rules.long_context)
            caches = place(caches, specs, self.mesh)
        return logits[:, -1], caches, t

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, steps: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """Greedy (or, at temperature > 0, sampled from ``generator``)
        continuation of a (B, T) prompt batch: (B, steps) int32 tokens. On a
        mesh every rank samples from the whole logits, so each rank's
        ``generator`` starts in the same state."""
        last, caches, pos = self.prefill(prompts)
        outs = []
        tok = whole(torch.argmax(last, dim=-1)[:, None].to(torch.int32))
        for i in range(steps):
            outs.append(tok)
            logits, caches = self._decode(self.params, caches, tok, pos + i)
            lg = logits[:, 0]
            if temperature > 0:
                # whole logits on every rank: each draws the plain path's tokens
                probs = torch.softmax(whole(lg).float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator).to(torch.int32)
            else:
                tok = whole(torch.argmax(lg, dim=-1)[:, None].to(torch.int32))
        return torch.cat(outs, dim=1)

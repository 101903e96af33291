"""Model assembly (port of ``repro/models/model.py``): param templates, init,
forward (train/prefill), decode.

The layer stack is the config's repeating ``pattern`` over
``pattern_repeats`` plus an unstacked ``tail``. Params are the reference's
nested dict: each ``blocks`` entry stacks its pattern position's leaves over
the repeats on a leading axis, and a loop over repeats indexes that axis
(the reference's ``lax.scan``). Caches mirror the same structure; 'local'
attention caches are ring buffers of the window size when max_len exceeds
the window.

Everything runs where the params and inputs live; ``init_params`` and
``init_cache`` take the device, "cuda" unless the caller asks for the CPU.
``decode_step`` writes the new K/V and states into the caches it is given
and returns them (the port's counterpart of the reference's donated cache
buffers).

On a data x model mesh (``compat.DTensorMesh``, enabled ``ShardingRules``)
params and caches are DTensors placed by ``place`` from ``param_shardings``
and ``cache_shardings`` (the port's ``device_put`` with ``NamedSharding``s);
``forward`` and ``decode_step`` place plain inputs over the data axes where
the batch divides (``place_batch``) and return DTensor logits.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from repro_torch import _tree
from repro_torch.compat import replicated
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    AttnCache,
    attention_layer,
    attn_params_template,
    ffn_layer,
    ffn_params_template,
    rms_norm,
)
from repro_torch.models.sharding import ShardingRules, check_mesh
from repro_torch.runtime.validate import SpgemmConfigError

MAX_ENCODER_POS = 32_768  # learned positions for encoder-only archs

ATTN_KINDS = ("attn", "local", "global", "moe")


# --------------------------------------------------------------------------
# trees: dicts, lists and NamedTuples of leaves
# --------------------------------------------------------------------------


def _tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves, called in the reference's flattening order
    (dict keys sorted, as ``jax.tree`` orders them)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_tree_map(fn, v, is_leaf) for v in tree]
    if isinstance(tree, tuple):  # a cache NamedTuple
        return type(tree)(*(_tree_map(fn, v, is_leaf) for v in tree))
    return fn(tree)


def _index(tree, r: int):
    """The repeat ``r`` of a stacked tree: views, no copy."""
    return _tree_map(lambda x: x[r], tree)


# --------------------------------------------------------------------------
# templates
# --------------------------------------------------------------------------


def layer_template(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("attn", "local", "global"):
        return {"attn": attn_params_template(cfg), "ffn": ffn_params_template(cfg)}
    if kind == "moe":
        return {"attn": attn_params_template(cfg), "moe": moe_mod.moe_params_template(cfg)}
    if kind == "rec":
        return {"rec": rglru_mod.rglru_params_template(cfg), "ffn": ffn_params_template(cfg)}
    if kind == "ssm":
        return {"ssm": ssm_mod.ssm_params_template(cfg)}
    raise SpgemmConfigError(f"unknown block kind {kind!r}")


def _is_template_leaf(x):
    return (
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
        and isinstance(x[1], str)
    )


def model_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    t: dict[str, Any] = {
        "embed": ((cfg.vocab_size, d), "embed"),
        "final_norm": ((d,), "norm"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ((d, cfg.vocab_size), "lm_head")
    if cfg.frontend in ("vision", "audio"):
        t["frontend_proj"] = ((cfg.frontend_dim, d), "norm")
    if cfg.is_encoder:
        t["pos_embed"] = ((MAX_ENCODER_POS, d), "norm")

    def stack(template, n):
        return _tree_map(lambda leaf: ((n,) + leaf[0], leaf[1]), template,
                         is_leaf=_is_template_leaf)

    t["blocks"] = [
        stack(layer_template(cfg, kind), cfg.pattern_repeats)
        for kind in cfg.pattern
    ]
    t["tail"] = [layer_template(cfg, kind) for kind in cfg.tail]
    return t


def param_specs(cfg: ModelConfig, rules: ShardingRules, dtype=torch.float32):
    """The param tree as tensors on the ``meta`` device: shapes and dtype,
    nothing allocated."""
    return _tree_map(lambda leaf: torch.empty(leaf[0], dtype=dtype, device="meta"),
                     model_template(cfg), is_leaf=_is_template_leaf)


def param_shardings(cfg: ModelConfig, rules: ShardingRules):
    """Spec tree matching param_specs. Stacked (pattern) leaves get a
    leading None for the repeat dim."""
    t = model_template(cfg)
    out: dict[str, Any] = {}
    for key, sub in t.items():
        if key == "blocks":
            out["blocks"] = [
                _tree_map(lambda leaf: (None, *rules.spec_for(leaf[1], leaf[0][1:])),
                          blk, is_leaf=_is_template_leaf)
                for blk in sub
            ]
        elif key == "tail":
            out["tail"] = [
                _tree_map(lambda leaf: rules.spec_for(leaf[1], leaf[0]),
                          blk, is_leaf=_is_template_leaf)
                for blk in sub
            ]
        else:
            out[key] = rules.spec_for(sub[1], sub[0])
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32,
                device="cuda"):
    """Random params on ``device``: each matrix leaf normal x 0.02 drawn in
    f32 from ``generator`` (which lives on ``device``), then cast to
    ``dtype``; norms and 1-D leaves zero. Leaves are drawn in the
    reference's flattening order; JAX's random bits are not reproduced, so
    parity tests carry the reference's params across (``convert``)."""
    def init_leaf(leaf):
        shape, role = leaf
        if role == "norm" or len(shape) == 1:
            return torch.zeros(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
                * 0.02).to(dtype)

    return _tree_map(init_leaf, model_template(cfg), is_leaf=_is_template_leaf)


def place(tree, specs, mesh):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` at its spec in
    ``specs``, a matching tree of spec tuples (``param_shardings``,
    ``cache_shardings``, ``zero1_shardings``): a whole tensor (the same on
    every rank) keeps this rank's slice, a DTensor is redistributed."""
    check_mesh(mesh)

    def one(spec, leaf):
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh.device_mesh, mesh.placements(spec))
        return mesh.distribute(leaf, spec)

    return _tree.map_specs(one, specs, tree)


def batch_spec(x: torch.Tensor, rules: ShardingRules) -> tuple:
    """An input's spec: its batch dim over the data axes where it divides
    (the reference's ``cells._resolve_dp``), else replicated."""
    return ((rules.dp if x.shape[0] % rules.dp_size == 0 else None),) + (None,) * (x.ndim - 1)


def place_batch(batch: dict, rules: ShardingRules, mesh) -> dict:
    """Each plain input of ``batch`` on ``mesh`` at ``batch_spec``; DTensors
    stay as they are."""
    check_mesh(mesh)
    return {k: v if isinstance(v, DTensor) else mesh.distribute(v, batch_spec(v, rules))
            for k, v in batch.items()}


def active_mesh(rules: ShardingRules, mesh, placed=None):
    """The mesh the model paths run over: ``mesh`` with enabled rules (which
    need one, and every leaf of ``placed`` a DTensor on it), else None (the
    reference's MoE takes the local path then)."""
    if not rules.enabled:
        return None
    check_mesh(mesh)
    plain = [path for path, leaf in _tree.leaves_with_path(placed)
             if not isinstance(leaf, DTensor)]
    if plain:
        raise SpgemmConfigError(
            f"enabled sharding rules need every param and cache on the mesh, and "
            f"{'/'.join(plain[0])} (of {len(plain)}) is a plain tensor: place them "
            f"(models.place with param_shardings / cache_shardings)")
    return mesh


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.window is not None:
        return min(max_len, cfg.window)
    return max_len


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kind_cache_template(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                         dtype):
    hd = cfg.resolved_head_dim
    if kind in ATTN_KINDS:
        s = _cache_len(cfg, kind, max_len)
        shp = (batch, s, cfg.num_kv_heads, hd)
        return AttnCache(k=_meta(shp, dtype), v=_meta(shp, dtype))
    if kind == "rec":
        w = cfg.lru_width or cfg.d_model
        return rglru_mod.RGLRUCache(
            state=_meta((batch, w), torch.float32),
            conv=_meta((batch, cfg.conv_width - 1, w), dtype),
        )
    if kind == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        n_heads = d_in // cfg.ssm_head_dim
        return ssm_mod.SSMCache(
            state=_meta((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
            conv_x=_meta((batch, cfg.conv_width - 1, d_in), dtype),
            conv_bc=_meta((batch, cfg.conv_width - 1, 2 * cfg.ssm_state), dtype),
        )
    raise SpgemmConfigError(f"unknown block kind {kind!r}")


def cache_template(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=COMPUTE_DTYPE):
    """The decode cache as tensors on the ``meta`` device (stacked like
    params)."""
    def stack(tmpl, n):
        return _tree_map(lambda s: _meta((n,) + tuple(s.shape), s.dtype), tmpl)

    return {
        "blocks": [
            stack(_kind_cache_template(cfg, kind, batch, max_len, dtype),
                  cfg.pattern_repeats)
            for kind in cfg.pattern
        ],
        "tail": [
            _kind_cache_template(cfg, kind, batch, max_len, dtype)
            for kind in cfg.tail
        ],
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=COMPUTE_DTYPE,
               device="cuda"):
    return _tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                     cache_template(cfg, batch, max_len, dtype))


def cache_shardings(cfg: ModelConfig, rules: ShardingRules, batch: int,
                    max_len: int, *, long_context: bool = False):
    def kind_spec(kind, stacked: bool):
        lead = (None,) if stacked else ()
        if kind in ATTN_KINDS:
            kv = rules.kv_cache_spec(batch, cfg.num_kv_heads,
                                     long_context=long_context)
            return AttnCache(k=(*lead, *kv), v=(*lead, *kv))
        if kind == "rec":
            w_tp = rules._tp_if((cfg.lru_width or cfg.d_model))
            return rglru_mod.RGLRUCache(
                state=(*lead, rules.dp if not long_context else None, w_tp),
                conv=(*lead, rules.dp if not long_context else None, None, w_tp),
            )
        if kind == "ssm":
            d_in = cfg.ssm_expand * cfg.d_model
            n_heads = d_in // cfg.ssm_head_dim
            h_tp = rules._tp_if(n_heads)
            dp = rules.dp if not long_context else None
            return ssm_mod.SSMCache(
                state=(*lead, dp, h_tp, None, None),
                conv_x=(*lead, dp, None, rules._tp_if(d_in)),
                conv_bc=(*lead, dp, None, None),
            )
        raise SpgemmConfigError(f"unknown block kind {kind!r}")

    return {
        "blocks": [kind_spec(kind, True) for kind in cfg.pattern],
        "tail": [kind_spec(kind, False) for kind in cfg.tail],
    }


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------


def apply_layer(kind: str, p, x, cfg: ModelConfig, rules: ShardingRules, *,
                positions, mesh=None, cache=None, pos=None, max_len=None,
                return_cache: bool = False):
    """One block of the given kind. Returns (x, new_cache)."""
    window = cfg.window if kind == "local" else None
    if kind in ATTN_KINDS:
        ring = (
            kind == "local" and cfg.window is not None and max_len is not None
            and max_len > cfg.window
        )
        delta, new_c = attention_layer(
            p["attn"], x, cfg, rules, window=window, positions=positions,
            cache=cache, pos=pos, ring=ring, return_cache=return_cache,
        )
        x = rules.residual(x + delta)
        if kind == "moe":
            x = rules.residual(x + moe_mod.moe_layer(p["moe"], x, cfg, rules, mesh=mesh))
        else:
            x = rules.residual(x + ffn_layer(p["ffn"], x, cfg, rules))
        return x, new_c
    if kind == "rec":
        delta, new_c = rglru_mod.rglru_layer(
            p["rec"], x, cfg, rules, cache=cache, return_cache=return_cache
        )
        x = rules.residual(x + delta)
        x = rules.residual(x + ffn_layer(p["ffn"], x, cfg, rules))
        return x, new_c
    if kind == "ssm":
        delta, new_c = ssm_mod.ssm_layer(
            p["ssm"], x, cfg, rules, cache=cache, return_cache=return_cache
        )
        x = rules.residual(x + delta)
        return x, new_c
    raise SpgemmConfigError(f"unknown block kind {kind!r}")


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------


def embed_inputs(params, batch: dict, cfg: ModelConfig, rules: ShardingRules):
    """batch: {'tokens': (B,T) int, optional 'patches'/'frames'}.
    Returns (x (B,T,d) compute-dtype, positions (T,))."""
    emb = params["embed"]
    if cfg.frontend == "audio":
        frames = batch["frames"]  # (B, T, frontend_dim)
        x = frames.to(COMPUTE_DTYPE) @ params["frontend_proj"].to(COMPUTE_DTYPE)
        t = x.shape[1]
        if cfg.is_encoder:
            x = x + params["pos_embed"][:t].to(COMPUTE_DTYPE)[None]
        return x, replicated(torch.arange(t, dtype=torch.int32, device=x.device), x)
    tokens = batch["tokens"]
    # a gather of rows: on a vocab-sharded table each shard looks up its own
    # rows and the rest sum in at the next constraint
    x = F.embedding(tokens, emb).to(COMPUTE_DTYPE)
    if cfg.frontend == "vision" and "patches" in batch:
        patches = batch["patches"]  # (B, P, frontend_dim)
        pe = patches.to(COMPUTE_DTYPE) @ params["frontend_proj"].to(COMPUTE_DTYPE)
        npatch = pe.shape[1]
        if isinstance(x, DTensor):  # the vocab shards' rows summed in first
            x = x.redistribute(x.device_mesh, pe.placements)
        x = torch.cat([pe, x[:, npatch:]], dim=1)
    t = x.shape[1]
    return x, replicated(torch.arange(t, dtype=torch.int32, device=x.device), x)


def lm_logits(params, x, cfg: ModelConfig, rules: ShardingRules):
    x = rules.gathered(rms_norm(x, params["final_norm"], cfg.norm_eps))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.final_softcap is not None:
        logits = (torch.tanh(logits.float() / cfg.final_softcap)
                  * cfg.final_softcap).to(logits.dtype)
    return rules.logits(logits)


# --------------------------------------------------------------------------
# forward (train / prefill) and decode
# --------------------------------------------------------------------------


def _stack_caches(per_repeat: list):
    """Per-repeat caches (one NamedTuple each) -> one NamedTuple of stacks."""
    if per_repeat[0] is None:
        return None
    return type(per_repeat[0])(*(torch.stack(f) for f in zip(*per_repeat)))


def forward(params, batch: dict, cfg: ModelConfig, rules: ShardingRules, *,
            mesh=None, return_caches: bool = False, max_len: int | None = None,
            remat: bool = True):
    """Full-sequence forward. Returns (logits, caches|None).

    ``remat`` recomputes each repeat's blocks in the backward pass
    (``torch.utils.checkpoint``) when autograd is recording; under
    ``torch.no_grad()`` it changes nothing. With enabled rules ``mesh`` is a
    data x model mesh and plain inputs are placed on it."""
    mesh = active_mesh(rules, mesh, params)
    if mesh is not None:
        batch = place_batch(batch, rules, mesh)
    x, positions = embed_inputs(params, batch, cfg, rules)
    x = rules.residual(x)
    max_len = max_len or x.shape[1]

    def block_step(x, block_params):
        caches = []
        for pos_i, kind in enumerate(cfg.pattern):
            x, c = apply_layer(
                kind, block_params[pos_i], x, cfg, rules, positions=positions,
                mesh=mesh, max_len=max_len, return_cache=return_caches,
            )
            caches.append(c)
        return x, caches

    per_repeat = []
    for r in range(cfg.pattern_repeats):
        block_params = [_index(bp, r) for bp in params["blocks"]]
        if remat and torch.is_grad_enabled():
            x, caches = torch.utils.checkpoint.checkpoint(
                block_step, x, block_params, use_reentrant=False)
        else:
            x, caches = block_step(x, block_params)
        per_repeat.append(caches)

    tail_caches = []
    for blk_params, kind in zip(params["tail"], cfg.tail):
        x, c = apply_layer(
            kind, blk_params, x, cfg, rules, positions=positions, mesh=mesh,
            max_len=max_len, return_cache=return_caches,
        )
        tail_caches.append(c)

    logits = lm_logits(params, x, cfg, rules)
    caches = None
    if return_caches:
        caches = {"blocks": [_stack_caches([c[i] for c in per_repeat])
                             for i in range(len(cfg.pattern))],
                  "tail": tail_caches}
    return logits, caches


def _write_back(dest, new) -> None:
    """Copy a layer's new cache fields into the given cache's tensors where
    the layer made new ones (recurrent and SSM states); attention writes
    its K/V in place itself. A DTensor field keeps its placement."""
    for d, n in zip(dest, new):
        if n is d:
            continue
        if isinstance(d, DTensor):
            n = n.redistribute(d.device_mesh, d.placements)
        d.copy_(n)


def decode_step(params, caches, tokens, pos: int, cfg: ModelConfig,
                rules: ShardingRules, *, mesh=None, max_len: int):
    """One decode step. tokens: (B, 1); pos: the absolute position (an int).
    Returns (logits (B, 1, V), caches), the given caches updated in place.
    With enabled rules the caches are DTensors on ``mesh``
    (``place(..., cache_shardings(...), mesh)``)."""
    mesh = active_mesh(rules, mesh, (params, caches))
    if mesh is not None:
        tokens = place_batch({"tokens": tokens}, rules, mesh)["tokens"]
    pos = int(pos)
    x = F.embedding(tokens, params["embed"]).to(COMPUTE_DTYPE)
    positions = replicated(torch.full((1,), pos, dtype=torch.int32, device=x.device), x)
    x = rules.constraint(x, (rules.dp, None, None)) if rules.enabled else x

    for r in range(cfg.pattern_repeats):
        for pos_i, kind in enumerate(cfg.pattern):
            cache = _index(caches["blocks"][pos_i], r)
            x, c = apply_layer(
                kind, _index(params["blocks"][pos_i], r), x, cfg, rules,
                positions=positions, mesh=mesh, cache=cache, pos=pos, max_len=max_len,
            )
            _write_back(cache, c)

    for blk_params, kind, cache in zip(params["tail"], cfg.tail, caches["tail"]):
        x, c = apply_layer(
            kind, blk_params, x, cfg, rules, positions=positions, mesh=mesh,
            cache=cache, pos=pos, max_len=max_len,
        )
        _write_back(cache, c)

    return lm_logits(params, x, cfg, rules), caches

"""Roofline terms of a dry-run cell, and the LM paths' bounds on one card
(port of ``repro/launch/roofline.py``).

Three terms per (arch, shape, mesh), in seconds, for one H100 rank:
  compute    = bf16 flops / 989e12 + f32 flops / 67e12
  memory     = bytes / 3.35e12
  collective = NVLink bytes / 450e9 + network bytes / 50e9

The counts are ``op_cost``'s, one rank's (the local shapes of one eager
run on meta DTensors); the record keeps the reference's keys
(``hlo_flops_per_chip``, ``hlo_bytes_per_chip``, ...) so that ``report``
reads records of both packages, and in the port they hold those per-rank
counts. The reference has one peak; the port's cells run their attention
and, in training, their params in f32, so the compute term adds the two
dtypes' times.

The constants are NVIDIA's datasheet figures, not measured on the card:
the H100 SXM5 datasheet's dense bf16 tensor-core peak (989 TFLOP/s), its
f32 peak outside the tensor cores (67 TFLOP/s) and its HBM3 bandwidth
(3.35 TB/s); the link bandwidths a direction a GPU are the H100 SXM5
datasheet's NVLink 4 (900 GB/s both ways: 450 one way) for a collective
whose group fits in one 8-GPU node (``op_cost.NODE_GPUS``), and the DGX
H100 datasheet's one 400 Gb/s NDR InfiniBand port a GPU (50 GB/s) for a
larger group. On the 16 x 16 mesh every axis has 16 ranks, so both axes
take the network.
There is one card here; no link was measured.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.launch.op_cost import OpCost

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 (and f16) tensor-core peak
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
NVLINK_BYTES_PER_S = 450e9  # NVLink 4, one direction a GPU (H100 SXM5 datasheet)
NETWORK_BYTES_PER_S = 50e9  # one 400 Gb/s NDR port a GPU (DGX H100 datasheet)
LINK_BYTES_PER_S = {"nvlink": NVLINK_BYTES_PER_S, "network": NETWORK_BYTES_PER_S}


def collective_bytes(cost: OpCost) -> dict:
    """Per-kind result bytes of every collective of one rank's run:
    {'all-gather': bytes, ..., 'total': bytes, 'count': n} (the
    reference's dict, from ``op_cost``'s records in place of HLO text)."""
    return cost.coll_breakdown()


def terms(flops_bf16: float, flops_f32: float, byts: float, link_bytes: dict) -> tuple:
    """(compute, memory, collective) seconds of one rank's counts."""
    return (flops_bf16 / BF16_FLOPS_PER_S + flops_f32 / F32_FLOPS_PER_S,
            byts / HBM_BYTES_PER_S,
            sum(b / LINK_BYTES_PER_S[k] for k, b in link_bytes.items()))


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per rank: op_cost's matmul flops, both dtypes
    hlo_bytes: float
    coll_bytes_per_chip: float
    coll_breakdown: dict
    bytes_per_chip_peak: float  # op_cost's peak live bytes
    model_flops: float  # 6*N*D (or 6*N_active*D)
    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    link_bytes: dict = dataclasses.field(default_factory=dict)

    def _terms(self) -> tuple:
        return terms(self.flops_bf16, self.flops_f32, self.hlo_bytes, self.link_bytes)

    @property
    def t_compute(self) -> float:
        return self._terms()[0]

    @property
    def t_memory(self) -> float:
        return self._terms()[1]

    @property
    def t_collective(self) -> float:
        return self._terms()[2]

    @property
    def dominant(self) -> str:
        t = dict(zip(("compute", "memory", "collective"), self._terms()))
        return max(t, key=t.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.chips * self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """compute term / the largest term (1.0: compute-bound at the
        roofline)."""
        bound = max(self._terms())
        return self.t_compute / bound if bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "model_flops": self.model_flops,
            "xla_flops_raw": None,  # no XLA cost analysis in eager torch
            "xla_bytes_raw": None,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_chip_peak": self.bytes_per_chip_peak,
            "coll_breakdown": self.coll_breakdown,
            "flops_bf16_per_chip": self.flops_bf16,
            "flops_f32_per_chip": self.flops_f32,
            "coll_link_bytes": self.link_bytes,
        }


def model_flops_for(cfg, shape) -> float:
    """6*N*D per the spec: N = (active) params, D = tokens per step.

    decode steps process global_batch tokens; train/prefill process
    global_batch * seq_len.
    """
    n = cfg.active_param_count()
    if shape.kind == "decode":
        d = shape.global_batch
    else:
        d = shape.global_batch * shape.seq_len
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n * d)


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[n]) for n in mesh.axis_names)


def analyze(cost: OpCost, *, arch: str, shape, mesh, cfg) -> Roofline:
    """The roofline of one rank's ``op_cost`` counts of a cell."""
    chips = 1
    for n in mesh.axis_names:
        chips *= mesh.shape[n]
    coll = collective_bytes(cost)
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name(mesh), chips=chips,
        hlo_flops=float(cost.flops), hlo_bytes=float(cost.bytes),
        coll_bytes_per_chip=float(coll["total"]), coll_breakdown=coll,
        bytes_per_chip_peak=float(cost.peak_bytes), model_flops=model_flops_for(cfg, shape),
        flops_bf16=float(cost.flops_bf16), flops_f32=float(cost.flops_f32),
        link_bytes=dict(cost.link_bytes),
    )


# ---------------------------------------------------------------------------
# the LM paths' bounds on one card (chip_smoke.py phases 17-20)
# ---------------------------------------------------------------------------

ADAMW_BYTES = 28  # a param's AdamW traffic in f32: p, g, m, v read, p, m, v written


def live_pairs(t, causal, window) -> int:
    """(query, key) pairs that a causal / windowed mask leaves live, T x T."""
    q = np.arange(t, dtype=np.int64)
    hi = q if causal else np.full(t, t - 1)
    lo = np.zeros(t, np.int64) if window is None else np.maximum(0, q - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def lm_matmul_flops(cfg, tokens: int) -> int:
    """bf16 matmul operations of a forward over ``tokens`` tokens (no
    patches): 2 x the weights each token multiplies, from the config's own
    count (MoE at its active experts; norms and biases left out)."""
    n = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model  # the token embedding is a gather
    if cfg.is_encoder:
        n -= 32_768 * cfg.d_model  # the learned positions too
    if cfg.frontend == "vision":
        n -= cfg.frontend_dim * cfg.d_model  # patches, not tokens
    return 2 * n * tokens


def lm_attention_flops(cfg, b: int, t: int) -> int:
    """f32 operations of the blockwise attention over the live (query, key)
    pairs of a T-token forward: q.k and p.v, 2 x head_dim each a pair and a
    head, summed over the attention layers."""
    kinds = list(cfg.pattern) * cfg.pattern_repeats + list(cfg.tail)
    total = 0
    for kind in kinds:
        if kind in ("attn", "local", "global", "moe"):
            window = cfg.window if kind == "local" else None
            total += (4 * b * cfg.num_heads * cfg.resolved_head_dim
                      * live_pairs(t, cfg.causal, window))
    return total


def lm_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tree.leaves(tree))


def lm_read_bytes(cfg, params, rows: int, t: int, expert_share: float) -> int:
    """Param bytes a pass must read: every weight once, but the gathered
    tables at the rows gathered (``rows`` distinct tokens of an untied
    embedding, ``t`` of the encoder's positions; an audio model reads no
    token row) and the MoE experts at the share the routing used."""
    total = lm_bytes(params)
    row = cfg.d_model * params["embed"].element_size()
    if cfg.frontend == "audio":
        total -= cfg.vocab_size * row + (params["pos_embed"].shape[0] - t) * row
    elif not cfg.tie_embeddings:
        total -= (cfg.vocab_size - rows) * row
    for kind, blk in zip(cfg.pattern, params["blocks"]):
        if kind == "moe":
            total -= (1 - expert_share) * lm_bytes([blk["moe"][w] for w in ("w1", "w3", "w2")])
    return int(total)


def lm_prefill_bound(cfg, params, tokens, expert_share=1.0) -> tuple:
    """(bound ms, 'bytes' or 'operations') of a prefill of ``tokens`` (B, T):
    the params it reads and the (B, T, V) bf16 logits written at 3.35 TB/s,
    against the bf16 matmuls at 989 TFLOP/s plus the f32 attention over the
    live pairs at 67 TFLOP/s."""
    b, t = tokens.shape[:2]
    rows = int(torch.unique(tokens).numel()) if tokens.dtype == torch.int32 else 0
    t_bytes = ((lm_read_bytes(cfg, params, rows, t, expert_share) + b * t * cfg.vocab_size * 2)
               / HBM_BYTES_PER_S * 1e3)
    t_ops = (lm_matmul_flops(cfg, b * t) / BF16_FLOPS_PER_S
             + lm_attention_flops(cfg, b, t) / F32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_decode_bound(cfg, params, caches, tok, pos: int, expert_share: float) -> tuple:
    """(bound ms, kind) of one decode step at ``pos``: the params it reads,
    the live slots of each KV cache (positions <= pos) and the recurrent
    states once, the logits written; against the matmuls of B tokens."""
    b = tok.shape[0]
    cache = 0
    for c in caches["blocks"] + caches["tail"]:
        nbytes = lm_bytes(c)
        if type(c).__name__ == "AttnCache":  # (..., S, Hkv, hd)
            s = c.k.shape[-3]
            nbytes = nbytes * min(pos + 1, s) // s
        cache += nbytes
    rows = int(torch.unique(tok).numel())
    t_bytes = ((lm_read_bytes(cfg, params, rows, 1, expert_share) + cache
                + b * cfg.vocab_size * 2) / HBM_BYTES_PER_S * 1e3)
    t_ops = lm_matmul_flops(cfg, b) / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def last_matmul_params(cfg, kind: str) -> int:
    """Weights of a layer's last matmul: the FFN's down projection, the
    MoE's at its active experts, the SSM's output projection."""
    if kind == "moe":
        return cfg.experts_per_token * cfg.moe_d_ff * cfg.d_model
    if kind == "ssm":
        return cfg.ssm_expand * cfg.d_model * cfg.d_model
    return cfg.d_ff * cfg.d_model


def lm_train_bound(cfg, params, b: int, t: int) -> tuple:
    """(bound ms, 'operations' or 'bytes', parts) of one training step on B x
    T tokens with remat: the blocks' bf16 matmuls forward, recomputed and
    backward (4 x their forward, less each repeat's last matmul, which the
    recompute skips: ``torch.utils.checkpoint`` stops once the backward's
    saved tensors are back, and that matmul's output is none of them), the
    head's (3 x: it is not recomputed) at 989 TFLOP/s, the f32 attention
    over the live pairs 4 x at 67 TFLOP/s, then AdamW's 28 B a param at
    3.35 TB/s. The update runs after the backward pass, so the two parts'
    bounds add; the larger names the kind. (A config's tail is not
    recomputed either; the card's phases bound llama3.2-1b, which has
    none.)"""
    tokens = b * t
    head = 2 * cfg.vocab_size * cfg.d_model * tokens
    blocks = lm_matmul_flops(cfg, tokens) - head
    skipped = 2 * tokens * cfg.pattern_repeats * last_matmul_params(cfg, cfg.pattern[-1])
    bf16 = 4 * blocks - skipped + 3 * head
    gemm = bf16 / BF16_FLOPS_PER_S * 1e3
    attn = 4 * lm_attention_flops(cfg, b, t) / F32_FLOPS_PER_S * 1e3
    n = sum(x.numel() for x in _tree.leaves(params))
    adamw = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3
    parts = {"bf16_gemm_ms": gemm, "f32_attention_ms": attn, "adamw_ms": adamw,
             "bf16_tflop": bf16 / 1e12,
             "f32_attention_tflop": 4 * lm_attention_flops(cfg, b, t) / 1e12}
    return gemm + attn + adamw, ("operations" if gemm + attn >= adamw else "bytes"), parts

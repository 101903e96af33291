"""Compressed collectives for bandwidth-bound mesh exchanges (port of
``repro/dist/collectives.py``).

Two standard compressions, as in the reference:

* **int8 quantized all-reduce** (``compressed_psum``): each shard scales
  its operand per last-axis group to int8, the int8 payload (and one scale
  per group) is all-gathered over the mesh axis (4x fewer wire bytes than
  f32), and every shard dequantizes and reduces locally into the mean;
* **top-k sparsification** (``topk_compress``/``topk_decompress``): keep the
  k largest-magnitude entries plus a local residual, the error-feedback
  scheme of gradient-sparsification training.

Where the reference's ``compressed_psum`` runs inside a ``shard_map`` body,
the port's takes the mesh and this process's local stack (see
``repro_torch.compat``).
"""
from __future__ import annotations

import math

import torch


def quantize_int8(x: torch.Tensor):
    """Per last-axis-group symmetric int8 quantization -> (q, scale)."""
    s = x.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of ``quantize_int8``."""
    return (q.to(s.dtype) * s).reshape(shape)


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Mean over the mesh axis with an int8 wire format.

    ``x`` is this process's local stack ``(S_loc, ...)``, one operand a
    shard; each shard quantizes its own (per last-axis group), the int8
    payloads and their scales are all-gathered, and the mean of the
    dequantized operands comes back as ``(S_loc, ...)``, every shard's row
    the same: about 1e-2 absolute error for unit-scale operands.
    """
    q, s = quantize_int8(x)
    qg = mesh.all_gather(q, axis)  # (S, ...) int8 on the wire
    sg = mesh.all_gather(s, axis)
    mean = (qg.to(s.dtype) * sg).mean(0, keepdim=True)
    return mean.expand_as(x).clone()


def topk_compress(x: torch.Tensor, k: int):
    """Keep the k largest-|x| entries -> (values, flat_indices, residual),
    with ``topk_decompress(values, indices) + residual == x`` exactly."""
    flat = x.reshape(-1)
    idx = torch.topk(flat.abs(), k).indices
    vals = flat[idx]
    dec = torch.zeros_like(flat).index_put_((idx,), vals)
    return vals, idx, (flat - dec).reshape(x.shape)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """Scatter compressed entries back into a dense tensor of ``shape``."""
    n = math.prod(shape)
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_put_(
        (idx,), vals).reshape(shape)

"""Building blocks shared by the SpGEMM phases (port of ``repro/core/utils.py``).

torch has no associative scan and no bitwise-or scatter reduction, so the
segmented scan is a log-step (Hillis-Steele) scan over (flag, value) pairs:
ceil(log2 n) passes of one shifted combine each. torch has no population
count either; ``popcount`` is the SWAR bit count.

Bitmasks in the port are int32 tensors holding the reference's uint32 bits
(torch's ``uint32`` has few operations on the CPU or the card).
"""
from __future__ import annotations

import torch


def segmented_scan(values: torch.Tensor, seg_heads: torch.Tensor, op) -> torch.Tensor:
    """Inclusive segmented scan: restart the scan at every ``seg_heads`` True.

    The last element of each segment holds the segment's full reduction.
    ``op(earlier, later)`` must be associative. O(n log n) work, as the
    reference's ``associative_scan``; for integer and bitwise ops the result
    is exact, for float sums the order of the adds differs.
    """
    flags = seg_heads.to(torch.bool)
    out = values
    n = values.shape[0]
    d = 1
    while d < n:
        nxt = out.clone()
        nxt[d:] = torch.where(flags[d:], out[d:], op(out[:-d], out[d:]))
        nflags = flags.clone()
        nflags[d:] = flags[d:] | flags[:-d]
        out, flags = nxt, nflags
        d *= 2
    return out


def segment_ends(seg_heads: torch.Tensor) -> torch.Tensor:
    """True at the last element of each segment."""
    ends = torch.ones_like(seg_heads, dtype=torch.bool)
    ends[:-1] = seg_heads[1:].to(torch.bool)
    return ends


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 holding uint32 bits, or a
    non-negative int64 below 2^32), as int32. SWAR count in int64, where
    every shift is logical."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    if x.shape[0] > 1:
        out[1:] = torch.cumsum(x, 0, dtype=x.dtype)[:-1]
    return out


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def bit_of(col: torch.Tensor) -> torch.Tensor:
    """``1 << (col & 31)`` as the int32 bit pattern of the uint32 word (bit
    31 is -2^31), computed without relying on an overflowing shift."""
    v = torch.ones_like(col, dtype=torch.int64) << (col.to(torch.int64) & 31)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def block_until_ready(out):
    """The reference's ``jax.block_until_ready``: wait until the card has
    finished ``out`` (a tensor, or the first tensor of a tuple or list);
    nothing to wait for on the CPU. Returns ``out``."""
    first = next((x for x in out if isinstance(x, torch.Tensor)), None) if isinstance(
        out, (tuple, list)) else out
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.synchronize(first.device)
    return out

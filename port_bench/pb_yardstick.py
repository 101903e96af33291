"""The benchmark's yardstick for kernels: the chip's peaks and the work that
any implementation of an operation must do, counted from the operation's
shapes and never from the program's plan.

Peaks are NVIDIA's published figures for one H100 SXM (dense, at its full
700 W power limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores. A card set below 700 W runs slower under load; every run
prints the card's power limit beside its numbers.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
PEAKS_SOURCE = "NVIDIA H100 SXM datasheet: 3.35 TB/s HBM3, 67 TFLOP/s f32 (no tensor cores), 700 W"

INDEX_BYTES = 4  # int32 row pointers and column indices


def numeric_phase_work(m_a: int, nnz_a: int, m_b: int, nnz_b: int, m_c: int,
                       nnz_c: int, products: int, itemsize: int = 4,
                       batch: int = 1) -> tuple[int, int]:
    """(bytes, flops) of the numeric phase of C = A·B on a fixed structure
    for ``batch`` value sets: A's and B's row pointers and column indices
    read once, their values once a set; C's row pointers and column indices
    read once, C's values written once a set; two flops (a multiply and an
    add) per product a set. Whatever plan an implementation keeps, it moves
    at least this."""
    structure = INDEX_BYTES * (m_a + 1 + nnz_a + m_b + 1 + nnz_b + m_c + 1 + nnz_c)
    values = itemsize * (nnz_a + nnz_b + nnz_c)
    return structure + batch * values, 2 * products * batch


def bound_s(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time the chip could take: the larger of bytes over the HBM
    rate and flops over the f32 rate, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")

"""The kernel-backed two-phase path (port of ``repro/kernels/ops.py``).

These wrappers own the format plumbing (CSR -> ELL and bitmask) and the
numeric kernel's dispatch. Numeric-phase selection is the paper's GPU rule
(``core.meta.choose_kernel``): ``kernel="auto"`` sends modest rows (average
row flops < 256) to the dense-accumulator kernel K4 (``"dense_acc"``) and
flop-heavy rows to the LP-hash kernel K3 (``"flat_lp"``); f64 and integer
operands go to the plain ``"xla"`` path, since the kernels accumulate in
f32. ``KERNEL_COUNTS`` records every resolved dispatch.

``attention`` (K8, flash attention) and ``expert_matmul`` (K7, the MoE
grouped matmul) keep the reference's ``impl`` names: "auto" and "pallas"
run the CUDA kernel for CUDA tensors and its plain version for CPU tensors,
"xla" the plain version wherever the tensors live.

What the reference has and this slice does not: ``tune="measure"`` (the
port's autotune slice) and the degradation ladder of
``on_kernel_failure="fallback"`` and its fault points (the runtime slice).
A kernel that fails raises ``KernelFallbackError``; nothing falls back.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.core.compression import bitmask_rows, flops_stats
from repro_torch.core.meta import choose_kernel, f32_accumulation_ok
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_plain
from repro_torch.kernels.spgemm_lp import spgemm_lp_bucketed
from repro_torch.kernels.spgemm_numeric import (spgemm_numeric_bucketed,
                                                spgemm_numeric_ref)
from repro_torch.kernels.spgemm_symbolic import spgemm_symbolic_bucketed
from repro_torch.runtime.validate import (KernelFallbackError, SpgemmConfigError,
                                          SpgemmError)
from repro_torch.sparse.formats import CSR, csr_to_ell

NUMERIC_KERNELS = ("auto", "dense_acc", "flat_lp", "xla")
IMPLS = ("auto", "pallas", "xla")  # attention / expert_matmul

# Dispatch telemetry: resolved kernel name per numeric_values call.
KERNEL_COUNTS: Counter = Counter()


def reset_kernel_counts() -> None:
    KERNEL_COUNTS.clear()


def resolve_numeric_kernel(a: CSR, b: CSR, kernel: str = "auto",
                           fm: int | None = None) -> str:
    """Resolve ``kernel`` to a concrete numeric-phase implementation.

    "auto" applies ``core.meta.choose_kernel`` (the static avg-row-flops
    rule; the tie at 256 goes to "flat_lp") after the dtype guard: f64 and
    integer operands resolve to "xla". An explicit kernel name with such
    operands raises ``SpgemmConfigError``. ``fm``: the total multiplication
    count, if the caller has it (saves a ``flops_stats`` pass and a sync).
    """
    if kernel not in NUMERIC_KERNELS:
        raise SpgemmConfigError(
            f"unknown kernel {kernel!r}; expected one of {NUMERIC_KERNELS}")
    f32_ok = f32_accumulation_ok(a.values.dtype, b.values.dtype)
    if kernel != "auto":
        if kernel != "xla" and not f32_ok:
            raise SpgemmConfigError(
                f"kernel={kernel!r} accumulates in f32 and cannot take "
                f"{a.values.dtype}/{b.values.dtype} operands exactly; "
                f"use kernel='xla' (what 'auto' resolves to for them)")
        return kernel
    if not f32_ok:
        return "xla"
    if fm is None:
        fm = int(flops_stats(a, b.row_nnz())[0])
    return choose_kernel(a, b, {"fm": fm})


def symbolic_rowsizes(a: CSR, b: CSR, *, pad_policy: str | None = None) -> torch.Tensor:
    """Kernel-backed symbolic phase (K5): (m,) int32 row sizes of C = A*B
    from A's ELL structure and B's bitmask rows. The bitmask holds
    n * ceil(k/32) words: 2 GiB for a 262,144 x 65,536 B."""
    ell = csr_to_ell(a)
    return spgemm_symbolic_bucketed(ell.indices, ell.row_nnz, bitmask_rows(b),
                                    pad_policy=pad_policy)


def numeric_values(a: CSR, b: CSR, c_idx: torch.Tensor, c_nnz: torch.Tensor, *,
                   pad_policy: str | None = None, kernel: str = "auto",
                   fm: int | None = None, tune: str | None = None,
                   on_kernel_failure: str = "raise") -> torch.Tensor:
    """Kernel-backed numeric phase: ELL-layout values of C at the symbolic
    structure ``c_idx``/``c_nnz`` (the Reuse entry point). Widths bucketed.

    kernel: "auto" (meta-algorithm rule + dtype guard, see
    ``resolve_numeric_kernel``), "dense_acc" (K4, out in A's dtype),
    "flat_lp" (K3, out in ``promote_types(a, b)``) or "xla" (plain torch,
    exact for f64/int). Replay loops should pass a concrete ``kernel`` or a
    precomputed ``fm``.

    tune: only None; "measure" comes with the port's autotune slice.
    on_kernel_failure: only "raise" (a failure raises
    ``KernelFallbackError``); "fallback" comes with the runtime slice.
    """
    if tune is not None:
        raise SpgemmConfigError(
            f"tune={tune!r} comes with the port's autotune slice (ROADMAP "
            f"Queue 1); this slice uses the static paper thresholds")
    if on_kernel_failure == "fallback":
        raise SpgemmConfigError(
            "on_kernel_failure='fallback': the port has no degradation ladder "
            "until its runtime/ slice (ROADMAP Queue 1), so a failed kernel "
            "always raises KernelFallbackError ('raise')")
    if on_kernel_failure != "raise":
        raise SpgemmConfigError(
            f"on_kernel_failure must be 'fallback' or 'raise', got "
            f"{on_kernel_failure!r}")
    if kernel == "auto" and fm is None:
        fm = int(flops_stats(a, b.row_nnz())[0])
    resolved = resolve_numeric_kernel(a, b, kernel, fm=fm)
    if kernel == "auto" and resolved == "xla":  # only the dtype guard gives "xla"
        from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

        FALLBACK_COUNTS["dtype:numeric_auto->xla"] += 1
    ea = csr_to_ell(a)
    eb = csr_to_ell(b)
    try:
        if resolved == "xla":
            out = spgemm_numeric_ref(ea.indices, ea.values, ea.row_nnz, eb.indices,
                                     eb.values, c_idx, c_nnz, k=b.k)
        elif resolved == "flat_lp":
            out = spgemm_lp_bucketed(ea.indices, ea.values, ea.row_nnz, eb.indices,
                                     eb.values, eb.row_nnz, c_idx, c_nnz,
                                     pad_policy=pad_policy, k=b.k)
        else:
            out = spgemm_numeric_bucketed(ea.indices, ea.values, ea.row_nnz,
                                          eb.indices, eb.values, c_idx, c_nnz, k=b.k,
                                          pad_policy=pad_policy, b_nnz=eb.row_nnz)
    except SpgemmError:
        raise  # typed errors (bad operands, a failed launch) pass as they are
    except Exception as e:
        raise KernelFallbackError(
            f"numeric kernel {resolved!r} failed and on_kernel_failure='raise'") from e
    KERNEL_COUNTS[resolved] += 1
    return out


def pallas_spgemm(a: CSR, b: CSR, *,
                  kernel: str = "auto") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full two-phase kernel pipeline. Returns (c_nnz, c_idx, c_val) with C
    in ELL layout; the host decides rC between the phases (two-phase
    contract). K5 sizes C's rows, the core sort path extracts the structure,
    and the numeric kernel follows ``kernel`` (default: the meta-algorithm
    rule). The name is the reference's; the kernels are CUDA here."""
    from repro_torch.core.spgemm import host_fm_cap, numeric_fresh

    sizes = symbolic_rowsizes(a, b)
    r_c = max(int(sizes.max()) if sizes.numel() else 0, 1)
    # one flops_stats pass serves both the expansion cap and the selection
    fm = int(flops_stats(a, b.row_nnz())[0])
    fm_cap = host_fm_cap(a, b, fm=fm)
    nnz = int(sizes.sum())
    nnz_cap = max(-(-nnz // 8) * 8, 8)
    c, _ = numeric_fresh(a, b, fm_cap, nnz_cap)
    c_ell = csr_to_ell(c, r_pad=r_c)
    c_nnz, c_idx = c_ell.row_nnz, c_ell.indices
    del c, c_ell  # C's CSR and ELL values: only the structure goes on
    vals = numeric_values(a, b, c_idx, c_nnz, kernel=kernel, fm=fm)
    return c_nnz, c_idx, vals


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise SpgemmConfigError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, softcap: float | None = None,
              impl: str = "auto", segment_pos=None) -> torch.Tensor:
    """Multi-head attention over (H, T, D) tensors with GQA broadcast.

    impl: "auto" or "pallas" (the CUDA kernel K8 for CUDA tensors, its plain
    version on the CPU), "xla" (the plain version). ``segment_pos`` (decode
    positions) always takes the plain version, as in the reference. Blocks
    are the reference's ``min(128, T)``.
    """
    _check_impl(impl)
    if impl == "xla" or segment_pos is not None:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, segment_pos=segment_pos)
    return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                           block_q=min(128, q.shape[1]), block_k=min(128, k.shape[1]))


def expert_matmul(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """Grouped (expert) matmul for expert-sorted token blocks of width 128.

    impl: "auto" or "pallas" (the CUDA kernel K7 for CUDA tensors, its plain
    version on the CPU), "xla" (the plain version)."""
    _check_impl(impl)
    if impl == "xla":
        return grouped_matmul_plain(x, w, block_expert)
    return grouped_matmul(x, w, block_expert)

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

``numeric_values`` runs the reference's selection and degradation ladder:
``tune="measure"`` times the eligible kernels on the real operands and
caches the winner per structure-stats bucket (``core.autotune``); with
``on_kernel_failure="fallback"`` (the default) a kernel failure — a launch
that returns a CUDA error (``_build.KernelLaunchError``) or an armed
failpoint (``runtime.faults``) — steps to the next rung on the same device
(``runtime.ladder``), counted in ``FALLBACK_COUNTS["fault:<kernel>-><next>"]``
and recorded in the flight recorder. On the CPU the rungs are the
reference's (resolved pick, then the static ``choose_kernel`` pick, then
"xla"); on the card they are kernels only, K4 and K3 each the other's rung,
and the plain "xla" path is neither a rung nor a measured candidate there
(it runs only where the dtype guard or an explicit ``kernel="xla"`` sends
the operands). Typed errors pass through untouched, among them the
``KernelFallbackError`` of a kernel library that cannot be built or loaded:
a broken build is never a rung.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.core import autotune
from repro_torch.core.compression import bitmask_rows, flops_stats
from repro_torch.core.meta import choose_kernel, f32_accumulation_ok
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_plain
from repro_torch.kernels.spgemm_lp import spgemm_lp_bucketed
from repro_torch.kernels.spgemm_numeric import (spgemm_numeric_bucketed,
                                                spgemm_numeric_ref)
from repro_torch.kernels.spgemm_symbolic import spgemm_symbolic_bucketed
from repro_torch.runtime import faults, ladder
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.sparse.formats import CSR, csr_to_ell

NUMERIC_KERNELS = ("auto", "dense_acc", "flat_lp", "xla")
IMPLS = ("auto", "pallas", "xla")  # attention / expert_matmul

# On the card a failed f32 kernel steps to the other one.
OTHER_KERNEL = {"dense_acc": "flat_lp", "flat_lp": "dense_acc"}

# Dispatch telemetry: resolved kernel name per numeric_values call.
KERNEL_COUNTS: Counter = Counter()


def reset_kernel_counts() -> None:
    KERNEL_COUNTS.clear()


def resolve_numeric_kernel(a: CSR, b: CSR, kernel: str = "auto",
                           fm: int | None = None) -> str:
    """Resolve ``kernel`` to a concrete numeric-phase implementation.

    "auto" applies ``core.meta.choose_kernel`` (the avg-row-flops rule,
    static or fitted; the tie at the cutoff goes to "flat_lp") after the
    dtype guard: f64 and integer operands resolve to "xla". When the
    autotuner holds a measured winner for this problem's structure-stats
    bucket (recorded by ``numeric_values(..., tune="measure")``), that
    winner takes precedence: measured beats fitted beats static. An
    explicit kernel name with f64/int operands raises
    ``SpgemmConfigError``. ``fm``: the total multiplication count, if the
    caller has it (saves a ``flops_stats`` pass and a sync).
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
    measured = autotune.lookup_measured(autotune.bucket_key(
        a.m, b.k, fm, a.values.dtype, b.values.dtype, table="numeric",
        device=a.device))
    if measured is not None:
        return measured
    return choose_kernel(a, b, {"fm": fm})


def numeric_ladder(resolved: str, static_pick: str | None, on_card: bool) -> list[str]:
    """The rungs of ``numeric_values``' degradation ladder, in order.

    On the CPU, the reference's: the resolved pick, then the static
    ``choose_kernel`` pick (auto modes pass it), then "xla", deduplicated.
    On the card every rung is a kernel: a K4 or K3 pick has the other as
    its one further rung; "xla" is a rung only when it is the pick itself
    (the dtype guard, or an explicit ``kernel="xla"``).
    """
    if on_card:
        return [resolved, OTHER_KERNEL[resolved]] if resolved in OTHER_KERNEL else [resolved]
    rungs = [resolved]
    for name in (static_pick, "xla"):
        if name is not None and name not in rungs:
            rungs.append(name)
    return rungs


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
                   on_kernel_failure: str = "fallback") -> torch.Tensor:
    """Kernel-backed numeric phase: ELL-layout values of C at the symbolic
    structure ``c_idx``/``c_nnz`` (the Reuse entry point). Widths bucketed.

    kernel: "auto" (meta-algorithm rule + dtype guard, see
    ``resolve_numeric_kernel``), "dense_acc" (K4, out in A's dtype),
    "flat_lp" (K3, out in ``promote_types(a, b)``) or "xla" (plain torch,
    exact for f64/int). Replay loops should pass a concrete ``kernel`` or a
    precomputed ``fm``.

    tune="measure" (with kernel="auto" only) replaces the threshold rule by
    a first-sight micro-bench: when ``f32_accumulation_ok`` holds,
    "dense_acc" and "flat_lp" (and on the CPU "xla") are timed on these
    operands, else "xla" alone; the winner runs and is recorded in the autotuner's bucket table — later
    same-bucket calls (through here or ``resolve_numeric_kernel``) dispatch
    it with zero re-tuning.

    on_kernel_failure: "fallback" (default) walks the degradation ladder
    (``numeric_ladder``) on a kernel failure of a rung (a CUDA error of a
    launch, an armed ``kernel:<name>`` failpoint), recording each step as
    ``FALLBACK_COUNTS["fault:<failed>-><next>"]`` and a flight-recorder
    "fallback" event; "raise" turns the first failure into
    ``KernelFallbackError``, as does running out of rungs. Other errors
    (bad operands, a kernel library that cannot be built or loaded) pass
    through untouched.
    """
    from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

    autotune.validate_tune(tune)
    if tune == "measure" and kernel != "auto":
        raise SpgemmConfigError(
            f"tune='measure' requires kernel='auto' (got kernel={kernel!r}):"
            f" measure mode picks the kernel empirically, an explicit pin "
            f"contradicts it")
    ladder.check_policy(on_kernel_failure)
    on_card = ladder.kernels_only(a.values.device)
    f32_ok = f32_accumulation_ok(a.values.dtype, b.values.dtype)
    ea = csr_to_ell(a)
    eb = csr_to_ell(b)

    def run(kname: str) -> torch.Tensor:
        if kname == "xla":
            return spgemm_numeric_ref(ea.indices, ea.values, ea.row_nnz, eb.indices,
                                      eb.values, c_idx, c_nnz, k=b.k)
        if kname == "flat_lp":
            return spgemm_lp_bucketed(ea.indices, ea.values, ea.row_nnz, eb.indices,
                                      eb.values, eb.row_nnz, c_idx, c_nnz,
                                      pad_policy=pad_policy, k=b.k)
        return spgemm_numeric_bucketed(ea.indices, ea.values, ea.row_nnz, eb.indices,
                                       eb.values, c_idx, c_nnz, k=b.k,
                                       pad_policy=pad_policy, b_nnz=eb.row_nnz)

    def checked(kname: str) -> torch.Tensor:
        faults.check(f"kernel:{kname}")
        return run(kname)

    # the auto paths need fm anyway (selection rule, bucket key, the
    # ladder's static rung)
    if kernel == "auto" and fm is None:
        fm = int(flops_stats(a, b.row_nnz())[0])
    if tune == "measure":
        bkey = autotune.bucket_key(a.m, b.k, fm, a.values.dtype, b.values.dtype,
                                   table="numeric", device=a.device)
        resolved = autotune.lookup_measured(bkey)
        if resolved is None:
            # candidates: the dtype-eligible rows of the selection table; on
            # the card the kernels only, unless the dtype guard leaves "xla"
            names = (["xla"] if not (on_card and f32_ok) else []) + (
                ["dense_acc", "flat_lp"] if f32_ok else [])
            resolved, _ = autotune.measure_and_record(
                bkey, {n: (lambda n=n: checked(n)) for n in names})
    else:
        resolved = resolve_numeric_kernel(a, b, kernel, fm=fm)
        if kernel == "auto" and resolved == "xla" and not f32_ok:
            FALLBACK_COUNTS["dtype:numeric_auto->xla"] += 1

    static_pick = (choose_kernel(a, b, {"fm": fm})
                   if kernel == "auto" or tune == "measure" else None)
    out, ran = ladder.walk(numeric_ladder(resolved, static_pick, on_card), run,
                           on_kernel_failure=on_kernel_failure, site="numeric_values",
                           what="numeric kernel", kernel_span=True)
    KERNEL_COUNTS[ran] += 1
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

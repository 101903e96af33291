#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it end to end.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --kernels-only   # phases 1-2: build + kernels vs plain
    python3 chip_smoke.py --profile        # adds a device-time breakdown per path

Phases, in order:
  1. the card (name and power limit from nvidia-smi) and the kernel build
     (one nvcc per CUDA source, all started together);
  2. each replay kernel against its plain torch version on synthetic plans
     (fm not a multiple of the tile, a sentinel tail, one segment spanning
     many blocks; f32, bf16, f16 and mixed values) and on edge plans: ids
     that skip (the gaps must read 0), negative ids at the head, sentinels
     only, fm below, at and one past whole tiles, one segment over many tiles
     begun mid-tile, plan arrays as views at offsets 1-3 (misaligned for
     int4 loads), each call made right after a NaN-filled tensor of the
     output's size is freed (a slot left unwritten shows); and K5, K4 and K3
     against theirs on synthetic ELL operands (widths of no tile, garbage
     past a_nnz/b_nnz, k = 70,001 with windows past K4's shared columns,
     rows whose LP tables live in device memory, a forced 16-slot L1 that
     spills, k < 32; the same dtypes); K4 alone on rows of every window
     class (k = 70,001, 65,536 and 5,000; empty rows, unsorted C columns, C
     and B columns outside [0, k); with and without b_nnz), and K5 bitwise
     against its plain version with its nonzero-word index against
     symbolic_index (all-zero and dense B rows, clamped column ids, k32 of
     1, 37 and 2,048, past the warps' accumulators, past shared memory);
     then K3 alone on rows of every size class
     (log-uniform widths), with and without a forced 4-slot L1 that makes
     rows of every class spill, on rows whose keys all share one home slot
     of K3's hash, and on keys that are multiples of 2^16, logging the rows
     per class; K3 on rows whose structure lists fewer columns than their
     products reach (the tables fill: those rows run again), and with
     l1_size=65,536 on multigrid 512^2 A*P (no row in device memory);
  3. multigrid Reuse, the paper's R*A*P: galerkin_triple(2048, 2048, 4).
     Fresh AP = A*P and RAP = R*AP through spgemm(method="sparse"), held
     against scipy (structure exactly, values in float64), then five time
     steps replayed through ReuseExecutor(backend="pallas") — kernel K1 —
     each held against the plain version;
  4. power-law A*A: rmat_csr(16, 8). spgemm(method="lp") and three
     ReuseExecutor(backend="pallas_lp") replays — kernel K2 — held against
     the plain version and scipy;
  5. times on the card: each kernel and the plain version at the shapes of
     phases 3 and 4, each kernel's bound at 3.35 TB/s, a fresh spgemm and a
     replay end to end, and torch.sparse.mm on the same operands as a
     yardstick for the fresh multiply (the port never calls it);
  6. the kernel-backed two-phase path (kernels/ops) on the same RMAT-16
     A*A: pallas_spgemm(kernel="auto") runs K5 + K3, numeric_values(kernel=
     "dense_acc") K4 on the same structure; K5's row sizes against the sort
     path and scipy exactly, both value sets against scipy, each kernel
     against its plain version on a row sample with the widest rows;
  7. the same on multigrid A*P, galerkin_triple(512, 512, 4) (B's bitmask is
     n * ceil(k/32) words: 2 GiB here, 512 GiB at phase 3's grid): "auto"
     runs K5 + K4, "flat_lp" K3; plain versions on every row;
  8. spgemm(method="auto") on rmat_csr(13, 8) A*A picks the dense method
     (plain torch; the reference has no kernel there), against scipy;
  9. K3, K4 and K5 timed at the shapes of phases 6 and 7 beside their plain
     versions, bounds (K3/K4: the (m, rC) output counted whole),
     torch.sparse.mm (K3, K4), K3 / torch.sparse.mm and choose_kernel's pick,
     K3 and K4 on each K3 size class's rows alone, and K4 on each of its
     window classes' rows alone, with the rows, products and C entries of
     each class;
 10. K6 on the block multigrid: the 5-point operator of galerkin_triple(512,
     512, 4) as 262,144 block rows of 8 x 8 f32 blocks, squared at block
     granularity through plan_bsr_numeric (once) and bsr_spgemm_numeric (two
     sets of block values), each against the plain version, C against
     scipy's bsr_matrix product in float64; then bs = 16 on the 128^2 grid;
 11. K7 through ops.expert_matmul at qwen3-moe-30b-a3b widths (d_model
     2,048, expert width 768, 128 experts, top-8): 4,096 tokens routed by
     seeded router logits, sorted by expert and padded per expert to 128
     rows; one layer's up projection x @ w1 and down projection (768 ->
     2,048, on x @ w1's output) in bf16, f16 and f32, against the plain
     version, each with its variant;
 12. K8 through ops.attention at T = 8,192: gemma2-9b widths (softcap 50; a
     local layer with its 4,096 window and a global layer; bf16 and f32),
     llama3.2-1b and qwen3-moe-30b-a3b widths (causal, bf16), against the
     plain version;
 13. K6, K7 and K8 timed at those shapes beside their plain versions, bounds
     and one PyTorch call where one computes the same function
     (torch.sparse.mm on the scalar CSR for K6, torch.bmm over w[block_expert]
     for K7, scaled_dot_product_attention for K8 where there is no softcap);
     K6 also at bs 16 f32 on the 512^2 plan, against the plain version;
 14. the selection and robustness layer at full data size: (a)
     spgemm(tune="measure") at phase 3's A*P (one micro-bench of the replay
     candidates, the winner a kernel whose launches moved; a second call
     from the plan-cache entry; an executor in measure mode hits the bucket;
     values against the plain replay); (b) numeric_values(tune="measure")
     at RMAT-16 A*A and 512^2 A*P (the candidates K3 and K4 only, the
     winner one of them, C against scipy, each candidate's time beside the
     plain version's and the peak memory logged); (c) fit_thresholds
     on phase 9's K3 and K4 times, stamped with this card, active, its
     picks no slower in total than the static rule's, its JSON printed; (d)
     the degradation ladder, whose rungs on the card are kernels only: each
     kernel failpoint armed in turn (values within F32_TOL of the other
     kernel run directly, exactly one fault:<k>-><other>, one recorder
     event, the failed kernel never launched), "raise" raising
     KernelFallbackError, a NaN in P under nan_guard rerun through the
     other kernel and flagged as data; (e) every data fault raising its
     typed error under validate="device" and "host", validate="off"
     calling check_csr never and adding nothing; (f) spgemm(trace="on") and a
     traced replay (spans, Chrome export under build/), "xprof" spans in
     torch.profiler, traced against untraced replay host time;
 15. the serving tier (repro_torch.serve) at full data size, on the
     multigrid A*P of phase 3 and the RMAT-16 A*A of phase 4, each request
     with fresh seeded values: (a) 16 requests alternating the two at
     max_batch 8 with backend "pallas", validate="host": every group one
     batched K1 launch, nothing else launched, no plain stage, no fault/
     dtype/nan_guard key, each response within F32_TOL of the plain replay
     of its own values, one per structure against scipy; (b) the same
     through K2 ("pallas_lp"); (c) singletons at max_batch 1, one single K1
     launch each; (d) chaos at A*P with kernel:pallas armed, a fake clock
     and breaker_threshold 2, traced: degraded singletons step to K2, the
     open breaker short-circuits a singleton and a batched group to K2, the
     probe under the failure reopens it, the probe after disarming closes
     it, serve.dispatch spans say "pallas->pallas_lp" and nothing says xla
     (Chrome export build/chip_smoke_serve_trace.json); (e) a fresh plan
     cache warmed from (a)'s traffic log; (f) overload: a full queue, an
     infeasible and an expired deadline, every request accounted for; (g)
     the admission split, per-request latency, the batched launches' times
     at batch 4 and 8 beside batch x the single launch and the plain
     batched replay;
 16. one JSON line of the kernels (K1 and K2 with their batched launches'
     times, launches and shape); the last line is the result.

Phase 2 also holds each batched replay launch (K1, K2) against the
executor's plain _replay_batched at F32_TOL: every edge plan with batch 3,
A shared, B shared, rows as views at offsets 1-3 right after a NaN-filled
tensor of the output's size is freed, and a stack of 1; K1's batched rows
against its single launch bit for bit.
Phase 2 also holds K6, K7 and K8 against their plain versions on synthetic
inputs (K7 in f32, bf16, f16 and two mixed pairs, so both of its variants:
"wgmma" for bf16 x bf16 and f16 x f16, "fma" for the others; K8 in f32,
bf16 and f16 at every head dim, so each of its variants: "fma" for f32,
"mma" for bf16/f16 at D 16 and 32, "wgmma" at D 64-256). Every K7 output
is held to K7_TOL and to a relative Frobenius bound (K7_FRO), every K8
output to K8_TOL and K8_FRO; where q and k are scaled by 8 under a softcap,
the output without the softcap must fail that check.
Phases 11-13 log the K7 and K8 variant of each shape and, in 13, its share
of the bound. Phase 1 logs ptxas's registers and spills per K7 and K8
instantiation. f32 products on the card keep allow_tf32 off (checked), so the
plain versions' matmuls are full f32.

The launch counters are set to 0 just before phases 3, 4, 6, 7 and 10-12
drive the main path and read just after, and so is FALLBACK_COUNTS: with the
degradation ladder on by default, each of those phases requires that no
fault:* or nan_guard:* key (and no dtype:* key it does not expect) appears;
so does every timed sweep that goes through an entry point (phases 5 and
14), so that no kernel's time is another rung's. Phase 15 sets the counts to
0 before each of its runs (a)-(f) and reads them after; the JSON line's
batched_launches add up its runs.
Any failed check raises, so the script exits
non-zero and prints no result. It needs torch, numpy and scipy; it exits
non-zero when no CUDA card is visible or when the repo's src/ is missing.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
F32_TOL = (1e-4, 1e-6)  # |kernel - plain| <= 1e-4 * S + 1e-6 (atomics reorder adds)
BF16_TOL = (8e-3, 1e-6)  # one bf16 ulp of the result


class SmokeFailure(AssertionError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn`` run to completion (synchronised)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tolerance_check(name, got, plain, scale, tol) -> float:
    """Hold ``got`` to ``plain`` within tol[0] * scale + tol[1]; return the
    largest |got - plain|."""
    err = (got.double() - plain.double()).abs()
    bound = tol[0] * scale.double() + tol[1]
    worst = float((err / bound).max()) if err.numel() else 0.0
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    require(worst <= 1.0, f"{name}: |kernel - plain| exceeds the tolerance "
                          f"(worst ratio {worst:.3g})")
    return float(err.max()) if err.numel() else 0.0


class Phase:
    """Times a phase and reports its peak device memory."""

    def __init__(self, title: str):
        self.title = title

    def __enter__(self):
        log(f"== {self.title}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            torch.cuda.synchronize()
            log(f"   {self.title}: {time.perf_counter() - self.t0:.2f} s, peak device "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        return False


def synthetic_plan(fm: int, nnz_cap: int, na: int, nb: int, tail: int,
                   long_run: int, seed: int):
    """Sorted seg_ids with random runs, one run of ``long_run`` products and
    ``tail`` sentinel products at the end; random slots."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    live = fm - tail
    seg = torch.sort(torch.randint(0, nnz_cap, (live,), generator=g,
                                   device="cuda")).values
    if long_run and live > long_run + 10:
        s0 = live // 3
        seg[s0:s0 + long_run] = seg[s0]
    seg = torch.cat([seg, torch.full((tail,), nnz_cap, device="cuda",
                                     dtype=seg.dtype)]).to(torch.int32)
    a_slot = torch.randint(0, na, (fm,), generator=g, device="cuda", dtype=torch.int32)
    b_slot = torch.randint(0, nb, (fm,), generator=g, device="cuda", dtype=torch.int32)
    return a_slot, b_slot, seg


def random_values(n: int, dtype, g) -> torch.Tensor:
    return torch.randn(n, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def to_scipy(csr, values=None):
    import scipy.sparse as sp

    nnz = int(csr.indptr[-1])
    vals = (csr.values if values is None else values)[:nnz]
    return sp.csr_matrix((vals.double().cpu().numpy(), csr.indices[:nnz].cpu().numpy(),
                          csr.indptr.cpu().numpy()), shape=csr.shape)


def _keys(indptr, indices, k) -> np.ndarray:
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    return rows * k + indices.astype(np.int64)


def _values_on(name, keys, mat) -> np.ndarray:
    """scipy matrix ``mat`` read at the sorted entry ``keys`` (0 where it has
    no entry); every entry of ``mat`` must be among ``keys``."""
    mat.sort_indices()
    mkeys = _keys(mat.indptr, mat.indices, mat.shape[1])
    pos = np.searchsorted(keys, mkeys)
    inside = pos < len(keys)
    require(bool(inside.all()) and bool(np.all(keys[pos] == mkeys)),
            f"{name}: scipy has entries outside the port's structure")
    out = np.zeros(len(keys))
    out[pos] = mat.data
    return out


def check_against_scipy(name, c, ref, scale=None) -> None:
    """Hold C to scipy's float64 product ``ref``.

    Without ``scale`` (positive operands, so no sum cancels and scipy drops
    nothing) C's structure must equal ``ref``'s exactly. With ``scale``,
    scipy's product of the operands' absolute values, C's values must lie
    within 1e-4 * scale + 1e-6 of ``ref``'s, both read on C's structure:
    scipy drops an entry whose sum is exactly 0, the port keeps it.
    """
    nnz = int(c.indptr[-1])
    indptr, indices = c.indptr.cpu().numpy(), c.indices[:nnz].cpu().numpy()
    if scale is None:
        ref.sort_indices()
        require(np.array_equal(indptr, ref.indptr), f"{name}: indptr differs from scipy")
        require(np.array_equal(indices, ref.indices), f"{name}: indices differ from scipy")
        log(f"   {name}: nnz {nnz}, structure == scipy")
        return
    keys = _keys(indptr, indices, c.shape[1])
    exact = _values_on(name, keys, ref)
    bound = F32_TOL[0] * _values_on(name, keys, scale) + F32_TOL[1]
    err = np.abs(c.values[:nnz].double().cpu().numpy() - exact)
    worst = float((err / bound).max()) if nnz else 0.0
    require(worst <= 1.0, f"{name}: values differ from scipy float64 "
                          f"(worst ratio {worst:.3g})")
    log(f"   {name}: nnz {nnz} (scipy {ref.nnz}, |.| product {scale.nnz}), max |port - "
        f"scipy f64| {float(err.max()):.3e} (worst ratio to tolerance {worst:.3f})")


def replay_bytes(fm_live: int, na: int, nb: int, nnz_c: int, itemsize: int) -> int:
    """Bytes a replay must move: each plan entry of a live product, each
    operand value and each output value once."""
    return 12 * fm_live + itemsize * (na + nb) + 4 * nnz_c


def bound_ms(fm_live: int, na: int, nb: int, nnz_c: int, itemsize: int = 4):
    """(bound in ms, what bounds it): the larger of bytes over HBM rate and
    the 2 flops per product over the f32 rate."""
    t_bytes = replay_bytes(fm_live, na, nb, nnz_c, itemsize) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fm_live / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
        + ", ".join(p.name for p in paths.values()))
    for name, text in build.BUILD_LOG.items():
        if name in ("flash_attention", "grouped_matmul"):  # one line per instantiation
            for fn, regs, spills in ptxas_functions(text):
                log(f"   nvcc[{name}]: {fn}: {regs} registers, {spills}")
            for code, what, fn in dict.fromkeys(re.findall(
                    r"\((C75\d\d)\) Potential Performance Loss: (.*?) (?:in|for) the function "
                    r"'(\w+)'", text)):
                log(f"   nvcc[{name}]: {code} in {short_name(fn)}: {what}")
            continue
        lines = dict.fromkeys(line.strip() for line in text.splitlines()
                              if "registers" in line or "spill" in line)
        for line in lines:  # one line per distinct report, not per instantiation
            log(f"   nvcc[{name}]: {line}")
    return smi


def short_name(mangled: str) -> str:
    """kernel<args> of a mangled kernel template name whose arguments are
    ints and dtypes (kernel<D, dtype>, kernel<dtype, dtype>), else the name."""
    types = {"f": "f32", "6__half": "f16", "13__nv_bfloat16": "bf16"}
    m = re.search(r"(\w+?)I((?:Li\d+E|f|6__half|13__nv_bfloat16)+)E", mangled)
    if m:  # the name is the suffix <len><name> of the prefix whose length fits
        args = [d or types[t] for d, t in
                re.findall(r"Li(\d+)E|(f|6__half|13__nv_bfloat16)", m.group(2))]
        prefix = m.group(1)
        for i in range(len(prefix)):
            n = re.match(r"\d+", prefix[i:])
            if n and len(prefix) - i - len(n.group()) == int(n.group()):
                return f"{prefix[i + len(n.group()):]}<{', '.join(args)}>"
    return mangled


def ptxas_functions(text: str) -> list:
    """(kernel<D, dtype>, registers, spill text) per entry function of an
    ``nvcc -Xptxas -v`` report."""
    out, fn, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = short_name(line.split("'")[1])
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and fn:
            out.append((fn, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            fn = None
    return out


# each replay kernel's products a tile (kTile in its .cu), which the edge
# plans are cut to; phase 2 holds each built library to it
REPLAY_TILES = {"segsum_reuse": 2048, "lp_reuse": 1024}


# the edge plans of the replay kernels, in the order edge_plans builds them
EDGE_CASES = ("skips", "negative_head", "sentinels_only", "below_tile", "one_tile",
              "past_two_tiles", "long_segment", "views_123", "views_333")


def _stepped(fm: int, g, dev, hold=None) -> torch.Tensor:
    """Sorted ids from 0 in steps of 0 or 1, as spgemm's plans have them; no
    step inside ``hold`` (start, stop)."""
    steps = (torch.rand(fm, generator=g, device=dev) < 0.55).long()
    steps[0] = 0
    if hold:
        steps[hold[0] + 1:hold[1]] = 0
    return torch.cumsum(steps, 0)


def edge_plans(tile: int, g, dev="cuda") -> list:
    """(case, a_slot, b_slot, seg_ids, nnz_cap, na, nb) for each of
    EDGE_CASES, a replay kernel's tiles holding ``tile`` products: ids that
    skip (the gaps read 0); negative ids at the head and ids past nnz_cap at
    the tail; sentinels only; fm below, at and one past two whole tiles; one
    segment over many tiles begun mid-tile, with a sentinel tail; that plan
    again as views at element offsets 1, 2, 3 (each array misaligned for int4
    loads) and 3, 3, 3. Slots reach past the value buffers (clamped). Shared
    with tests/test_torch_kernels.py."""
    def full(n, v):
        return torch.full((n,), v, dtype=torch.int64, device=dev)

    live = _stepped(4600, g, dev)
    head = int(live[-1]) + 21
    segs = [(torch.sort(torch.randint(0, 40000, (3000,), generator=g, device=dev)).values,
             40000),
            (torch.cat([torch.sort(torch.randint(-40, 0, (300,), generator=g,
                                                 device=dev)).values,
                        live, full(60, head), full(40, head + 3)]), head),
            (full(2 * tile + 1, 777), 777)]
    for fm in (tile - 24, tile, 2 * tile + 1):
        seg = _stepped(fm, g, dev)
        segs.append((seg, int(seg[-1]) + 29))
    seg = _stepped(20000 - 50, g, dev, hold=(3000, 15000))
    cap = int(seg[-1]) + 29
    segs.append((torch.cat([seg, full(50, cap)]), cap))
    na, nb = 700, 900
    out = []
    for case, (seg, cap) in zip(EDGE_CASES, segs):
        arrays = [torch.randint(-3, na + 5, seg.shape, generator=g, device=dev),
                  torch.randint(-3, nb + 5, seg.shape, generator=g, device=dev), seg]
        out.append((case, *(x.to(torch.int32) for x in arrays), cap, na, nb))
    for case, offsets in zip(EDGE_CASES[-2:], ((1, 2, 3), (3, 3, 3))):
        views = []
        for x, off in zip(out[6][1:4], offsets):
            padded = torch.cat([torch.zeros(off, dtype=torch.int32, device=dev), x])
            views.append(padded[off:])
            require(views[-1].data_ptr() % 16 == 4 * off, f"{case}: view not at its offset")
        out.append((case, *views, cap, na, nb))
    return out


def plan_arrays(a_slot, b_slot, seg, nnz_cap: int):
    """Raw plan arrays as the executor's plain replays read a plan (its
    ``indices`` only for nnz_cap). Shared with tests/test_torch_kernels.py."""
    return SimpleNamespace(a_slot_s=a_slot, b_slot_s=b_slot, seg_ids=seg,
                           indices=torch.empty(nnz_cap, dtype=torch.int32, device=seg.device))


def phase_kernels_vs_plain(seg_mod, lp_mod, seed: int) -> dict:
    worst = {"segsum_reuse": 0.0, "lp_reuse": 0.0}
    kernels = {"segsum_reuse": (seg_mod.segsum_reuse_arrays, seg_mod.segsum_reuse_plain),
               "lp_reuse": (lp_mod.lp_reuse_arrays, lp_mod.lp_reuse_plain)}
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = [  # (fm, nnz_cap, na, nb, tail, long_run)
        (1_000_003, 300_007, 200_000, 150_000, 777, 20_000),
        (37, 11, 9, 13, 5, 0),
    ]
    dtypes = [(torch.float32, torch.float32, F32_TOL),
              (torch.bfloat16, torch.bfloat16, BF16_TOL),
              (torch.float16, torch.float16, BF16_TOL),
              (torch.bfloat16, torch.float32, F32_TOL)]
    for ci, (fm, nnz_cap, na, nb, tail, long_run) in enumerate(cases):
        a_slot, b_slot, seg = synthetic_plan(fm, nnz_cap, na, nb, tail, long_run,
                                             seed + ci)
        for adt, bdt, tol in dtypes:
            a = random_values(na, adt, g)
            b = random_values(nb, bdt, g)
            scale = seg_mod.segsum_reuse_plain(a_slot, b_slot, seg, a.float().abs(),
                                               b.float().abs(), nnz_cap)
            for name, (kernel, plain) in kernels.items():
                got = kernel(a_slot, b_slot, seg, a, b, nnz_cap=nnz_cap)
                want = plain(a_slot, b_slot, seg, a, b, nnz_cap)
                require(got.dtype == want.dtype == torch.promote_types(adt, bdt),
                        f"{name}: output dtype {got.dtype}")
                err = tolerance_check(f"{name} fm={fm} {adt}x{bdt}", got, want,
                                      scale, tol)
                if tol is F32_TOL and adt == bdt:
                    worst[name] = max(worst[name], err)
                log(f"   {name} fm={fm} nnz_cap={nnz_cap} {str(adt)[6:]}x{str(bdt)[6:]}: "
                    f"max |kernel - plain| {err:.3e}")
    for name, (kernel, plain) in kernels.items():
        tile = REPLAY_TILES[name]
        require(seg_mod.tile_products(name) == tile,
                f"{name}: the library's tile is {seg_mod.tile_products(name)}, not {tile}")
        for case, a_slot, b_slot, seg, nnz_cap, na, nb in edge_plans(tile, g):
            errs = []
            for adt, bdt, tol in dtypes:
                a = random_values(na, adt, g)
                b = random_values(nb, bdt, g)
                want = plain(a_slot, b_slot, seg, a, b, nnz_cap)
                scale = plain(a_slot, b_slot, seg, a.float().abs(), b.float().abs(), nnz_cap)
                junk = torch.full((nnz_cap,), float("nan"), device="cuda")
                del junk  # the caching allocator hands its block to the output
                got = kernel(a_slot, b_slot, seg, a, b, nnz_cap=nnz_cap)
                require(got.dtype == want.dtype, f"{name} {case}: output dtype {got.dtype}")
                errs.append(tolerance_check(f"{name} {case} {adt}x{bdt}", got, want, scale,
                                            tol))
                if tol is F32_TOL and adt == bdt:
                    worst[name] = max(worst[name], errs[-1])
            log(f"   {name} (tile {tile}) {case}: fm {seg.shape[0]}, nnz_cap {nnz_cap}; "
                f"max |kernel - plain| over f32, bf16, f16, bf16xf32 {max(errs):.3e}")
    torch.cuda.synchronize()
    return worst


# how phase 2 stacks the values of a batched launch: (case, rows, A stacked,
# B stacked, element offset of the stacked rows in their buffer)
BATCH_STACKS = (("batch3", 3, True, True, 0), ("a_shared", 3, False, True, 0),
                ("b_shared", 3, True, False, 0), ("views_1", 3, True, True, 1),
                ("views_2", 3, True, True, 2), ("views_3", 3, True, True, 3),
                ("stack_of_1", 1, True, True, 0))


def stacked_values(n, rows, stacked, offset, dtype, g):
    """(rows, n) values as a view ``offset`` elements into a larger buffer,
    or one shared (n,) row."""
    if not stacked:
        return random_values(n, dtype, g)
    return random_values(offset + rows * n, dtype, g)[offset:].view(rows, n)


def carries_in_fixed_order(seg, nnz_cap: int, tile: int) -> bool:
    """Whether K1's adds come in a fixed order on this plan: no live segment
    spans more than two tiles (tiles shifted by seg_ids' misalignment), so
    no slot takes two carries, whose atomic adds replay_ends makes in no
    fixed order."""
    off = (seg.data_ptr() % 16) // 4
    live = (seg >= 0) & (seg < nnz_cap)
    tiles = (torch.arange(seg.shape[0], device=seg.device) + off) // tile
    s, t = seg[live].long(), tiles[live]
    if s.numel() == 0:
        return True
    first = torch.full((nnz_cap,), 2**62, dtype=torch.long, device=seg.device)
    last = torch.full((nnz_cap,), -1, dtype=torch.long, device=seg.device)
    first.scatter_reduce_(0, s, t, "amin")
    last.scatter_reduce_(0, s, t, "amax")
    return bool(((last - first) <= 1).all())


def phase_batched_vs_plain(seg_mod, lp_mod, ex_mod, seed: int) -> dict:
    """Each batched launch against the executor's plain ``_replay_batched``
    at F32_TOL: every edge plan of each kernel in each stacking of
    BATCH_STACKS (A shared, B shared, rows as views at offsets 1-3, a stack
    of 1), f32 and bf16 x f32 values, each call right after a NaN-filled
    tensor of the output's size is freed, and phase 2's 1,000,003-product
    plan at batch 3. K1's batched rows must equal its single launch on the
    row's values bit for bit where its adds come in a fixed order
    (``carries_in_fixed_order``) and its single launch repeats itself bit
    for bit (checked here); the count of equal rows is logged either way."""
    kernels = {"segsum_reuse": (seg_mod.segsum_reuse_batched_arrays, seg_mod.segsum_reuse_arrays),
               "lp_reuse": (lp_mod.lp_reuse_batched_arrays, lp_mod.lp_reuse_arrays)}
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    worst = {f"batched_{name}": 0.0 for name in kernels}
    bitwise = {"rows": 0, "equal": 0, "fixed_rows": 0, "single_repeats": True}
    for name, (batched, single) in kernels.items():
        plans = [(case, a_slot, b_slot, seg, cap, na, nb) for case, a_slot, b_slot, seg, cap, na, nb
                 in edge_plans(REPLAY_TILES[name], g)]
        big = synthetic_plan(1_000_003, 300_007, 200_000, 150_000, 777, 20_000, seed)
        plans.append(("synthetic_1M", *big, 300_007, 200_000, 150_000))
        for case, a_slot, b_slot, seg, cap, na, nb in plans:
            plan = plan_arrays(a_slot, b_slot, seg, cap)
            stacks = BATCH_STACKS if case != "synthetic_1M" else BATCH_STACKS[:1]
            errs = []
            for label, rows, a_st, b_st, off in stacks:
                for bdt in (torch.float32, torch.bfloat16):
                    a = stacked_values(na, rows, a_st, off, torch.float32, g)
                    b = stacked_values(nb, rows, b_st, off, bdt, g)
                    want = ex_mod._replay_batched(plan, a, b)
                    scale = ex_mod._replay_batched(plan, a.abs(), b.float().abs())
                    junk = torch.full((rows, cap), float("nan"), device="cuda")
                    del junk  # the caching allocator hands its block to the output
                    got = batched(a_slot, b_slot, seg, a, b, nnz_cap=cap)
                    require(got.shape == (rows, cap) and got.dtype == torch.float32,
                            f"batched {name} {case} {label}: output {got.shape} {got.dtype}")
                    errs.append(tolerance_check(f"batched {name} {case} {label}", got, want,
                                                scale, F32_TOL))
                    if name != "segsum_reuse":
                        continue
                    fixed = carries_in_fixed_order(seg, cap, REPLAY_TILES[name])
                    for i in range(rows):
                        x, y = (a[i] if a.ndim == 2 else a), (b[i] if b.ndim == 2 else b)
                        one = single(a_slot, b_slot, seg, x, y, nnz_cap=cap)
                        again = single(a_slot, b_slot, seg, x, y, nnz_cap=cap)
                        repeats = torch.equal(one, again)
                        bitwise["single_repeats"] &= repeats
                        bitwise["rows"] += 1
                        bitwise["fixed_rows"] += fixed
                        bitwise["equal"] += torch.equal(got[i], one)
                        require(torch.equal(got[i], one) or not (fixed and repeats),
                                f"batched segsum_reuse {case} {label} row {i}: not bitwise "
                                f"the single launch")
            worst[f"batched_{name}"] = max(worst[f"batched_{name}"], *errs)
            log(f"   batched {name} {case}: fm {seg.shape[0]}, nnz_cap {cap}, stackings "
                f"{[s[0] for s in stacks]}; max |batched - _replay_batched| over f32, "
                f"bf16 B {max(errs):.3e}")
    log(f"   K1 batched rows bitwise equal to its single launch: {bitwise['equal']} of "
        f"{bitwise['rows']} rows ({bitwise['fixed_rows']} rows of plans whose adds come in "
        f"a fixed order, held to it); single launch repeats itself bit for bit: "
        f"{bitwise['single_repeats']}")
    torch.cuda.synchronize()
    worst["k1_rows_bitwise"] = bitwise
    return worst


def with_values(csr, values):
    from repro_torch.sparse import CSR

    return CSR(csr.indptr, csr.indices, values, csr.shape)


def phase_multigrid(rt, seg_mod, lp_mod, seed: int, out: dict) -> None:
    import scipy.sparse  # noqa: F401  (fail early if scipy is missing)

    t0 = time.perf_counter()
    r, a, p = rt.galerkin_triple(2048, 2048, agg_size=4, device="cuda")
    log(f"   galerkin_triple(2048, 2048, 4): A {a.shape} nnz {int(a.indptr[-1])}, "
        f"P {p.shape}, R {r.shape}; made in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(seed)
    nnz_a = int(a.indptr[-1])
    a_pos = with_values(a, torch.rand(a.nnz_cap, generator=g, device="cuda") + 0.5)
    a_nrm = with_values(a, torch.randn(a.nnz_cap, generator=g, device="cuda"))
    log(f"   values: {int((a_nrm.values == 0).sum())} exact zeros among A's normal values")

    seg_mod.LAUNCHES = 0
    lp_mod.LAUNCHES = 0
    rt.telemetry.FALLBACK_COUNTS.clear()
    # the main path: fresh products, plan-cache hits, pinned K1 replays
    ap_pos = rt.spgemm(a_pos, p, method="sparse")
    rap_pos = rt.spgemm(r, ap_pos.c, method="sparse")
    ap = rt.spgemm(a_nrm, p, method="sparse")
    rap = rt.spgemm(r, ap.c, method="sparse")
    require(ap.stats["cache"] == "hit" and rap.stats["cache"] == "hit",
            f"second AP/RAP should hit the plan cache: {ap.stats['cache']}, "
            f"{rap.stats['cache']}")
    ex_ap = rt.ReuseExecutor.from_matrices(a_nrm, p, backend="pallas")
    ex_rap = rt.ReuseExecutor.from_matrices(r, ap.c, backend="pallas")
    steps, replays, worst = 5, 0, 0.0
    for step in range(steps):
        av = torch.randn(nnz_a, generator=g, device="cuda")
        apv = ex_ap.apply(av, p.values)
        rapv = ex_rap.apply(r.values, apv)
        replays += 2
        for name, ex, x, y, got in (("AP", ex_ap, av, p.values, apv),
                                    ("RAP", ex_rap, r.values, apv, rapv)):
            pl = ex.plan
            want = seg_mod.segsum_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids,
                                              x, y, ex.nnz_cap)
            scale = seg_mod.segsum_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids,
                                               x.abs(), y.abs(), ex.nnz_cap)
            worst = max(worst, tolerance_check(f"{name} replay {step}", got, want,
                                               scale, F32_TOL))
    torch.cuda.synchronize()
    launches = {"segsum_reuse": seg_mod.LAUNCHES, "lp_reuse": lp_mod.LAUNCHES}
    log(f"   launches on the multigrid path: {launches} for {replays} replays")
    require(launches["segsum_reuse"] == replays,
            f"segsum_reuse launched {launches['segsum_reuse']} times for {replays} replays")
    require(launches["lp_reuse"] == 0, "lp_reuse launched on the multigrid path")
    check_fallbacks(rt, "multigrid path")
    log(f"   AP: fm {ap.stats['fm']} fm_cap {ap.stats['fm_cap']} nnz {ap.stats['nnz_c']} "
        f"nnz_cap {ap.stats['nnz_cap']} kernel {ap.stats['kernel']}; RAP: fm "
        f"{rap.stats['fm']} fm_cap {rap.stats['fm_cap']} nnz {rap.stats['nnz_c']}")
    log(f"   K1 replays vs plain: max |kernel - plain| {worst:.3e}")

    # scipy: structure with positive values, values with normal ones
    t0 = time.perf_counter()
    a_s, p_s, r_s = to_scipy(a_pos), to_scipy(p), to_scipy(r)
    ap_s = a_s @ p_s
    check_against_scipy("AP (positive)", ap_pos.c, ap_s)
    check_against_scipy("RAP (positive)", rap_pos.c, r_s @ ap_s)
    a_n = to_scipy(a_nrm)
    ap_n = a_n @ p_s
    abs_ap = abs(a_n) @ abs(p_s)
    check_against_scipy("AP (normal)", ap.c, ap_n, abs_ap)
    check_against_scipy("RAP (normal)", rap.c, r_s @ ap_n, abs(r_s) @ abs_ap)
    log(f"   scipy checks: {time.perf_counter() - t0:.2f} s")

    out.update(multigrid_launches=launches, multigrid_worst=worst,
               r=r, a=a_nrm, p=p, ap=ap, ex_ap=ex_ap, ex_rap=ex_rap, nnz_a=nnz_a)


def phase_powerlaw(rt, seg_mod, lp_mod, seed: int, out: dict) -> None:
    t0 = time.perf_counter()
    a = rt.rmat_csr(16, 8, seed=0, device="cuda")
    nnz = int(a.indptr[-1])
    log(f"   rmat_csr(16, 8): {a.shape} nnz {nnz}; made in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)

    seg_mod.LAUNCHES = 0
    lp_mod.LAUNCHES = 0
    rt.telemetry.FALLBACK_COUNTS.clear()
    res = rt.spgemm(a, a, method="lp")
    ex = rt.ReuseExecutor.from_matrices(a, a, backend="pallas_lp")
    replays = [res.c.values]
    inputs = [a.values]
    for _ in range(3):
        av = torch.randn(a.nnz_cap, generator=g, device="cuda")
        replays.append(ex.apply(av, av))
        inputs.append(av)
    torch.cuda.synchronize()
    launches = {"segsum_reuse": seg_mod.LAUNCHES, "lp_reuse": lp_mod.LAUNCHES}
    log(f"   launches on the power-law path: {launches} for 1 lp multiply + 3 replays")
    require(launches["lp_reuse"] == 4, f"lp_reuse launched {launches['lp_reuse']} times, not 4")
    require(launches["segsum_reuse"] == 0, "segsum_reuse launched on the power-law path")
    check_fallbacks(rt, "power-law path")
    st = res.stats
    require(st["lp_backend"] == "pallas" and st["kernel"] == "flat_lp",
            f"lp method stats: {st['lp_backend']}, {st['kernel']}")
    log(f"   A*A: fm {st['fm']} fm_cap {st['fm_cap']} avg row flops "
        f"{st['avg_row_flops']:.1f} -> {st['kernel']}; nnz {st['nnz_c']} nnz_cap "
        f"{st['nnz_cap']}; peak so far {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    pl = ex.plan
    worst = 0.0
    for i, (x, got) in enumerate(zip(inputs, replays)):
        want = lp_mod.lp_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids, x, x, ex.nnz_cap)
        scale = lp_mod.lp_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids, x.abs(),
                                      x.abs(), ex.nnz_cap)
        worst = max(worst, tolerance_check(f"A*A lp replay {i}", got, want, scale, F32_TOL))
    log(f"   K2 vs plain: max |kernel - plain| {worst:.3e}")
    t0 = time.perf_counter()
    a_s = to_scipy(a)
    ref, scale = a_s @ a_s, abs(a_s) @ abs(a_s)
    check_against_scipy("A*A (normal)", res.c, ref, scale)
    log(f"   scipy check: {time.perf_counter() - t0:.2f} s")
    out.update(powerlaw_launches=launches, powerlaw_worst=worst, rmat=a, rmat_res=res,
               rmat_ex=ex, rmat_nnz=nnz, rmat_scipy=(ref, scale))


def phase_times(rt, seg_mod, lp_mod, seed: int, mg: dict, pw: dict) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    shapes = {
        "multigrid AP": (mg["ex_ap"].plan, mg["nnz_a"], int(mg["p"].indptr[-1]),
                         mg["ap"].stats, mg["a"].nnz_cap, mg["p"].values),
        # A*A reads one value buffer for both operands: its bytes count once
        "power-law A*A": (pw["rmat_ex"].plan, pw["rmat_nnz"], 0,
                          pw["rmat_res"].stats, pw["rmat"].nnz_cap, None),
    }
    times = {}
    for label, (plan, na_live, nb_live, st, na_cap, b_vals) in shapes.items():
        a_vals = random_values(na_cap, torch.float32, g)
        b_vals = a_vals if b_vals is None else b_vals
        args = (plan.a_slot_s, plan.b_slot_s, plan.seg_ids, a_vals, b_vals)
        nnz_cap = plan.indices.shape[0]
        row = {
            "segsum_reuse": time_ms(lambda: seg_mod.segsum_reuse_arrays(*args, nnz_cap=nnz_cap)),
            "lp_reuse": time_ms(lambda: lp_mod.lp_reuse_arrays(*args, nnz_cap=nnz_cap)),
            "plain": time_ms(lambda: seg_mod.segsum_reuse_plain(*args, nnz_cap)),
        }
        bnd, by = bound_ms(st["fm"], na_live, nb_live, st["nnz_c"])
        row.update(bound_ms=bnd, bound_by=by, fm=st["fm"],
                   fm_cap=st["fm_cap"], nnz_c=st["nnz_c"])
        times[label] = row
        log(f"   {label} (fm {st['fm']}, fm_cap {st['fm_cap']}, nnz(C) {st['nnz_c']}): "
            f"segsum_reuse {row['segsum_reuse']:.3f} ms, lp_reuse {row['lp_reuse']:.3f} ms, "
            f"plain {row['plain']:.3f} ms; bound {bnd:.3f} ms ({by}: plan of live "
            f"products + operands + C once, at 3.35 TB/s)")
        log(f"   {label}: no single PyTorch call computes the replay (library_ms null)")

    a, p, r = mg["a"], mg["p"], mg["r"]
    rm = pw["rmat"]
    rt.telemetry.FALLBACK_COUNTS.clear()
    e2e = {
        "fresh AP spgemm(sparse)": wall_ms(
            lambda: rt.spgemm(a, p, method="sparse", plan_cache=False)),
        "fresh A*A spgemm(lp)": wall_ms(
            lambda: rt.spgemm(rm, rm, method="lp", plan_cache=False)),
        "replay AP (pallas)": wall_ms(
            lambda: mg["ex_ap"].apply(a.values, p.values), reps=7),
        "replay A*A (pallas_lp)": wall_ms(
            lambda: pw["rmat_ex"].apply(rm.values, rm.values), reps=7),
    }
    check_fallbacks(rt, "end-to-end times")

    from repro_torch.core.plan_cache import structure_key
    from repro_torch.core.spgemm import prepare_sparse_inputs

    a_pad, p_pad, _, _, fm_cap = prepare_sparse_inputs(a, p, "pow2")
    e2e["structure_key AP (host copy + hash, part of fresh AP)"] = wall_ms(
        lambda: structure_key(a_pad, p_pad, fm_cap, "pow2"))
    e2e["torch.sparse.mm A*P (yardstick)"] = wall_ms(sparse_mm(a, p))
    e2e["torch.sparse.mm A*A (yardstick)"] = wall_ms(sparse_mm(rm, rm))
    for k, v in e2e.items():
        log(f"   {k}: {v:.3f} ms (host clock, median, synchronised)")
    times["end_to_end"] = e2e
    return times


def phase_profile(rt, mg: dict, pw: dict) -> None:
    """Where the time goes: device time by kernel under torch.profiler for a
    fresh multiply and a replay of each path, and the device's idle share
    of the synchronised host interval."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, p, rm = mg["a"], mg["p"], pw["rmat"]
    runs = {
        "fresh AP spgemm(sparse)": lambda: rt.spgemm(a, p, method="sparse", plan_cache=False),
        "replay AP (pallas)": lambda: mg["ex_ap"].apply(a.values, p.values),
        "fresh A*A spgemm(lp)": lambda: rt.spgemm(rm, rm, method="lp", plan_cache=False),
        "replay A*A (pallas_lp)": lambda: pw["rmat_ex"].apply(rm.values, rm.values),
    }
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels, copies): an aten op's row repeats
        # the device time of the kernels it launched
        rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
        rows.sort(reverse=True)
        dev_us = sum(r[0] for r in rows)
        log(f"   {label}: host {wall_us / 1e3:.3f} ms, device busy {dev_us / 1e3:.3f} ms, "
            f"idle share {1 - dev_us / wall_us:.3f} (profiled run)")
        for us, count, key in rows[:8]:
            log(f"      {us / 1e3:9.3f} ms  x{count:<3d} {key[:90]}")
        host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), reverse=True)
        for us, count, key in host[:4]:
            log(f"      {us / 1e3:9.3f} ms  x{count:<3d} host: {key[:84]}")


# ---------------------------------------------------------------------------
# The kernel-backed two-phase path (kernels/ops): K5, K4 and K3
# ---------------------------------------------------------------------------

ELL_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float16, torch.float16), (torch.bfloat16, torch.float32)]
OPS_KERNELS = ("spgemm_symbolic", "spgemm_numeric", "spgemm_lp")


def ell_tol(dtype):
    return F32_TOL if dtype == torch.float32 else BF16_TOL


def reset_launches(km) -> None:
    km.seg.LAUNCHES = km.lp.LAUNCHES = km.lp.NUMERIC_LAUNCHES = 0
    km.sym.LAUNCHES = km.num.LAUNCHES = 0
    km.ops.reset_kernel_counts()
    km.telemetry.FALLBACK_COUNTS.clear()


def read_launches(km) -> dict:
    return {"segsum_reuse": km.seg.LAUNCHES, "lp_reuse": km.lp.LAUNCHES,
            "spgemm_symbolic": km.sym.LAUNCHES, "spgemm_numeric": km.num.LAUNCHES,
            "spgemm_lp": km.lp.NUMERIC_LAUNCHES}


def check_fallbacks(rt, name, dtype_keys=()) -> None:
    """With the degradation ladder on by default a failed kernel would step
    to the plain path and the launch counts alone might not show it: the
    main path must leave no ``fault:*`` or ``nan_guard:*`` key in
    ``FALLBACK_COUNTS`` (set to 0 with the launch counts), and no ``dtype:*``
    key but ``dtype_keys``."""
    got = dict(rt.telemetry.FALLBACK_COUNTS)
    bad = {k: v for k, v in got.items()
           if k.startswith(("fault:", "nan_guard:")) or (k.startswith("dtype:")
                                                         and k not in dtype_keys)}
    require(not bad, f"{name}: fallbacks on the main path {got}")
    log(f"   {name}: FALLBACK_COUNTS {got} (no fault:* or nan_guard:* key)")


def _widths(count, top, g, dev, log_widths):
    """``count`` widths in [0, top]: uniform, or log-uniform (floor of
    exp(U * ln(top + 1)) - 1), which puts as many widths in [1, 2] as in
    [top / 2, top]."""
    if not log_widths:
        return torch.randint(0, top + 1, (count,), generator=g, device=dev, dtype=torch.int32)
    u = torch.rand(count, generator=g, device=dev)
    return (torch.exp(u * math.log(top + 1)) - 1).floor().clamp(0, top).to(torch.int32)


def synthetic_ell(m, n, k, r_a, r_b, g, dev, log_widths=False):
    """ELL operands with garbage past a_nnz and b_nnz: A's padded slots hold
    column ids up to 3n, B's up to 2k (the kernels mask them; K4's contract
    gives B's padded slots the value 0, set by the caller). A row's live B
    columns are distinct (base + step * t mod k). Row m // 2 of A is full, so
    its C row is among the widest. ``log_widths`` draws the A and B widths
    log-uniformly, so C's row sizes span every K3 size class."""
    a_nnz = _widths(m, r_a, g, dev, log_widths)
    a_nnz[m // 2] = r_a
    a_live = torch.arange(r_a, device=dev)[None, :] < a_nnz[:, None]
    a_idx = torch.randint(0, 3 * n, (m, r_a), generator=g, device=dev)
    a_idx = torch.where(a_live, a_idx % n, a_idx).to(torch.int32)
    b_nnz = _widths(n, r_b, g, dev, log_widths)
    b_live = torch.arange(r_b, device=dev)[None, :] < b_nnz[:, None]
    base = torch.randint(0, k, (n, 1), generator=g, device=dev)
    step = torch.randint(1, max(k // r_b, 1) + 1, (n, 1), generator=g, device=dev)
    cols = (base + step * torch.arange(r_b, device=dev)[None, :]) % k
    junk = torch.randint(0, 2 * k, (n, r_b), generator=g, device=dev)
    b_idx = torch.where(b_live, cols, junk).to(torch.int32)
    return a_idx, a_nnz, b_idx, b_nnz, b_live


def ell_structure(a_idx, a_nnz, b_idx, b_nnz, k, drop=None):
    """C's symbolic structure from ELL operands: (c_idx, c_nnz), each row's
    distinct columns in ascending order; B slots where ``drop`` holds are
    left out."""
    m, r_a = a_idx.shape
    dev = a_idx.device
    rows, rs = torch.nonzero(torch.arange(r_a, device=dev)[None, :] < a_nnz[:, None],
                             as_tuple=True)
    j = a_idx[rows, rs].long()
    ok = torch.arange(b_idx.shape[1], device=dev)[None, :] < b_nnz[j][:, None]
    if drop is not None:
        ok &= ~drop[j]
    keys = torch.unique((rows[:, None] * k + b_idx[j].long())[ok])
    c_rows = keys // k
    c_nnz = torch.bincount(c_rows, minlength=m).to(torch.int32)
    start = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(c_nnz, 0)
    c_idx = torch.zeros(m, max(int(c_nnz.max()), 1), dtype=torch.int32, device=dev)
    c_idx[c_rows, torch.arange(keys.shape[0], device=dev) - start[c_rows]] = (
        keys % k).to(torch.int32)
    return c_idx, c_nnz


def ell_csr(rt, nnz, idx, vals, shape):
    """The live slots of an ELL array as a CSR (rows in order)."""
    mask = torch.arange(idx.shape[1], device=idx.device)[None, :] < nnz[:, None]
    indptr = torch.zeros(shape[0] + 1, dtype=torch.int32, device=idx.device)
    indptr[1:] = torch.cumsum(nnz, 0)
    return rt.CSR(indptr, idx[mask], vals[mask], shape)


def check_ell_kernels(km, name, args, k, l1_size, worst, want_sizes=None,
                      k3_only=False) -> None:
    """K5, K4 (with and without b_nnz) and K3 (or K3 alone) against their
    plain versions on one set of ELL inputs, in every dtype pair."""
    a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx, c_nnz, bm = args
    if not k3_only:
        got = km.sym.spgemm_symbolic(a_idx, a_nnz, bm)
        want = km.sym.spgemm_symbolic_plain(a_idx, a_nnz, bm)
        require(torch.equal(got, want), f"{name}: spgemm_symbolic differs from its plain version")
        if want_sizes is not None:
            require(torch.equal(got, want_sizes),
                    f"{name}: K5 row sizes differ from C's structure")
    g = torch.Generator(device=a_idx.device).manual_seed(int(k))
    for adt, bdt in ELL_DTYPES:
        a_val = torch.randn(a_idx.shape, generator=g, device=a_idx.device).to(adt)
        b_val = torch.randn(b_idx.shape, generator=g, device=a_idx.device).to(bdt)
        b_val0 = torch.where(b_live, b_val, torch.zeros((), dtype=bdt, device=b_val.device))
        tag = f"{str(adt)[6:]}x{str(bdt)[6:]}"
        if not k3_only:
            check_k4(km, name, tag, (a_idx, a_val, a_nnz, b_idx, b_val0, b_nnz, c_idx, c_nnz),
                     k, adt, worst)
        # K3: out in promote_types(a, b); B's padded slots masked by b_nnz
        out_dt = torch.promote_types(adt, bdt)
        scale = km.lp.spgemm_lp_plain(a_idx, a_val.float().abs(), a_nnz, b_idx,
                                      b_val.float().abs(), b_nnz, c_idx, c_nnz, k=k)
        want = km.lp.spgemm_lp_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx,
                                     c_nnz, l1_size=l1_size, k=k)
        got = km.lp.spgemm_lp(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                              l1_size=l1_size, k=k)
        require(got.dtype == want.dtype == out_dt, f"K3 output dtype {got.dtype}")
        err = tolerance_check(f"{name} spgemm_lp {tag}", got, want, scale, ell_tol(out_dt))
        worst["spgemm_lp"] = max(worst["spgemm_lp"], err)
        log(f"   {name} {tag}: {'K3 == plain' if k3_only else 'K4 and K3 == plain'} "
            f"within tolerance")


def check_k4(km, name, tag, args, k, adt, worst) -> None:
    """K4, with and without b_nnz, against its plain version."""
    a_idx, a_val, a_nnz, b_idx, b_val0, b_nnz, c_idx, c_nnz = args
    # K4: out in A's dtype; B's padded slots carry 0
    scale = km.num.spgemm_numeric_plain(a_idx, a_val.float().abs(), a_nnz, b_idx,
                                        b_val0.float().abs(), c_idx, c_nnz, k=k)
    want = km.num.spgemm_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val0, c_idx,
                                       c_nnz, k=k)
    for bn in ((None, b_nnz) if a_val.dtype == b_val0.dtype == torch.float32
               else (b_nnz,)):
        got = km.num.spgemm_numeric(a_idx, a_val, a_nnz, b_idx, b_val0, c_idx, c_nnz,
                                    k=k, b_nnz=bn)
        require(got.dtype == want.dtype == adt, f"K4 output dtype {got.dtype}")
        err = tolerance_check(f"{name} spgemm_numeric {tag}", got, want, scale,
                              ell_tol(adt))
        worst["spgemm_numeric"] = max(worst["spgemm_numeric"], err)


LP_COLLISION_KEYS = (1, 3, 4, 7, 15, 31, 63, 127, 255, 511, 1023, 2047)


def lp_collision_ell(km, k, counts, dev):
    """ELL operands whose row i (one A entry, B row i) has counts[i] keys,
    all on one home slot of the row's per-row table under K3's hash (found by
    brute force over [0, k)), then a row of no product; B's padded slots hold
    column k."""
    r_b = max(counts)
    cand = torch.arange(k, device=dev)
    b_idx = torch.full((len(counts), r_b), k, dtype=torch.int32, device=dev)
    for i, c in enumerate(counts):
        size = 1 << max(2 * c - 1, 7).bit_length()  # next power of two >= max(2c, 8)
        keys = cand[km.lp.lp_home_slot(cand, size) == 0][:c]
        require(keys.shape[0] == c, f"fewer than {c} keys share a home slot below k={k}")
        b_idx[i, :c] = keys.to(torch.int32)
    b_nnz = torch.tensor(counts, dtype=torch.int32, device=dev)
    m = len(counts) + 1
    a_idx = torch.cat([torch.arange(m - 1, device=dev), torch.zeros(1, device=dev,
                                                                   dtype=torch.long)])
    a_nnz = torch.ones(m, dtype=torch.int32, device=dev)
    a_nnz[-1] = 0
    b_live = torch.arange(r_b, device=dev)[None, :] < b_nnz[:, None]
    return a_idx[:, None].to(torch.int32), a_nnz, b_idx, b_nnz, b_live


def lp_lost_product_ell(dev):
    """ELL operands (index arrays, values, widths) whose C structure lists
    fewer columns than some rows' products reach, so K3's tables, sized from
    c_nnz, fill: row 0 one A entry over B columns 0-8 (values 1-9), c_nnz 1,
    column 8 listed (the sum is 9); row 1 3 of 40 columns listed, the last
    three, which arrive after a 16-slot table (L1 4 + L2 8 at l1_size 4) is
    full; row 2 its full structure; row 3 no product; row 4 every 30th of
    3,000 columns listed (a 256-slot table); row 5 three A entries over 120
    columns, 5 listed. B's padded slots hold column 5,000 and value 1e6."""
    b_rows = [torch.arange(9), torch.arange(40), torch.tensor([3, 5, 7]), torch.arange(3000),
              torch.arange(0, 120, 3), torch.arange(1, 120, 3), torch.arange(2, 120, 3)]
    r_b = max(r.shape[0] for r in b_rows)
    b_idx = torch.full((len(b_rows), r_b), 5000, dtype=torch.int32)
    b_val = torch.full((len(b_rows), r_b), 1e6)
    for j, cols in enumerate(b_rows):
        b_idx[j, :cols.shape[0]] = cols
        b_val[j, :cols.shape[0]] = (torch.arange(cols.shape[0]) % 17 + 1).float()  # row 0: 1-9
    b_nnz = torch.tensor([r.shape[0] for r in b_rows], dtype=torch.int32)
    a_idx = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 0, 0], [3, 0, 0], [4, 5, 6]],
                         dtype=torch.int32)
    a_nnz = torch.tensor([1, 1, 1, 0, 1, 3], dtype=torch.int32)
    a_val = torch.ones(a_idx.shape)
    a_val[5] = torch.tensor([0.5, -2.0, 3.0])
    c_lists = [[8], [37, 38, 39], [3, 5, 7], [], list(range(0, 3000, 30)), [0, 1, 2, 60, 119]]
    c_idx = torch.zeros(len(c_lists), 100, dtype=torch.int32)
    for i, cols in enumerate(c_lists):
        c_idx[i, :len(cols)] = torch.tensor(cols, dtype=torch.int32)
    c_nnz = torch.tensor([len(c) for c in c_lists], dtype=torch.int32)
    return tuple(t.to(dev) for t in (a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz))


def check_lost_products(km, worst, dev="cuda") -> None:
    """K3 on rows whose structure lists fewer columns than their products
    reach (lp_lost_product_ell), at l1_size None and 4, in every dtype pair:
    the kernel lists the rows whose tables filled and the wrapper runs them
    again (two launches); every value against the plain version, row 0's
    exactly 9."""
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = lp_lost_product_ell(dev)
    b_live = torch.arange(b_idx.shape[1], device=dev)[None, :] < b_nnz[:, None]
    for l1_size in (None, 4):
        before = km.lp.NUMERIC_LAUNCHES
        got = km.lp.spgemm_lp(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                              l1_size=l1_size, k=5000)
        torch.cuda.synchronize()
        require(km.lp.NUMERIC_LAUNCHES == before + 2,
                f"K3 lost products l1={l1_size}: {km.lp.NUMERIC_LAUNCHES - before} launches, "
                "not 2 (the rows that lost a product, again)")
        require(float(got[0, 0]) == 9.0, f"K3 lost products l1={l1_size}: row 0 gives "
                                         f"{float(got[0, 0])}, not 9")
        check_ell_kernels(km, f"K3 lost products l1={l1_size}",
                          (a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx, c_nnz, None), 5000,
                          l1_size, worst, k3_only=True)


def check_large_l1(rt, km, worst) -> None:
    """K3 with l1_size=65,536 on multigrid 512^2 A*P (rows of at most 4
    columns): every row takes the tables of l1_size=None, none in device
    memory, and the values match the plain version."""
    _, a, p = rt.galerkin_triple(512, 512, agg_size=4, device="cuda")
    c_nnz, c_idx, _ = km.ops.pallas_spgemm(a, p, kernel="dense_acc")
    ea, ep = rt.csr_to_ell(a), rt.csr_to_ell(p)
    r_c, k = c_idx.shape[1], p.shape[1]
    slots = {l1: int(km.lp.lp_table_slots(c_nnz, r_c, l1).sum()) for l1 in (None, 65536)}
    classes = lp_class_rows(km, c_nnz, 65536)
    log(f"   K3 l1=65536 at multigrid 512^2 A*P: {a.shape[0]} rows, rC {r_c}; table slots "
        f"{slots[65536]} (l1=None: {slots[None]}); rows per class {classes}")
    require(slots[65536] == slots[None] and classes[-1] == 0,
            "K3 l1=65536 at A*P: rows get the forced L1 or device-memory tables")
    args = (ea.indices, ea.values, ea.row_nnz, ep.indices, ep.values, ep.row_nnz, c_idx, c_nnz)
    got = km.lp.spgemm_lp(*args, l1_size=65536, k=k)
    want = km.lp.spgemm_lp_plain(*args, l1_size=65536, k=k)
    scale = km.lp.spgemm_lp_plain(ea.indices, ea.values.abs(), ea.row_nnz, ep.indices,
                                  ep.values.abs(), ep.row_nnz, c_idx, c_nnz, k=k)
    err = tolerance_check("K3 l1=65536 at A*P", got, want, scale, F32_TOL)
    worst["spgemm_lp"] = max(worst["spgemm_lp"], err)
    log(f"   K3 l1=65536 at A*P == plain: max |kernel - plain| {err:.3e}")


def k4_window_ell(km, k, g, dev="cuda"):
    """ELL operands whose C rows span every K4 window class: B row j's live
    columns span exactly spans[j] (each class limit and one past, the wide
    class's shared columns and one past, k, and log-uniform widths), four B
    rows carry one live column outside [0, k) (dropped), garbage past b_nnz
    and a_nnz; A row j < n selects B row j alone, then rows of 2-6 random
    entries, ten empty rows and a full one. C's structure from the live
    products, each row's columns shuffled, columns 0 and k - 1 of every 7th
    row and of the row of span k written outside [0, k) (they clamp to
    listed ones), a listed column no product reaches in every 11th random
    row, one c_nnz past rC and one negative."""
    limits = [w for cap in (*km.num.CLASS_COLS, km.num.WIDE_SHARED_COLS, 53_248)
              for w in (cap, cap + 1)] + [k]
    u = torch.rand(40, generator=g, device=dev).cpu()
    full = len([w for w in limits if w <= k]) - 1  # B row j = full spans all of [0, k)
    spans = [w for w in limits if w <= k] + [int(x) for x in
                                             (torch.exp(u * math.log(k)).floor().clamp(1, k))]
    n, r_b = len(spans), 24
    b_idx = torch.randint(-k, 2 * k, (n, r_b), generator=g, device=dev, dtype=torch.int32)
    b_nnz = torch.zeros(n, dtype=torch.int32, device=dev)
    for j, w in enumerate(spans):
        base = int(torch.randint(0, k - w + 1, (1,), generator=g, device=dev))
        live = min(r_b, w, int(torch.randint(2, r_b + 1, (1,), generator=g, device=dev)))
        inner = torch.randperm(max(w - 2, 1), generator=g, device=dev)[:max(live - 2, 0)] + 1
        cols = torch.unique(torch.cat([torch.tensor([0, w - 1], device=dev), inner]))[:live]
        cols = (cols + base)[torch.randperm(cols.shape[0], generator=g, device=dev)]
        b_idx[j, :cols.shape[0]] = cols.to(torch.int32)
        b_nnz[j] = cols.shape[0]
    for j in (1, 7, 11, 13):  # a live column outside [0, k): its products drop
        if j < n and int(b_nnz[j]) < r_b:
            b_idx[j, int(b_nnz[j])] = k + 7 if j % 2 else -4
            b_nnz[j] += 1
    r_a, m = 6, n + 120
    a_idx = torch.randint(-3, n + 3, (m, r_a), generator=g, device=dev, dtype=torch.int32)
    a_nnz = torch.randint(2, r_a + 1, (m,), generator=g, device=dev, dtype=torch.int32)
    a_idx[:n, 0] = torch.arange(n, device=dev, dtype=torch.int32)
    a_nnz[:n] = 1
    a_nnz[n:n + 10] = 0
    a_nnz[n + 10] = r_a
    live = torch.arange(r_a, device=dev)[None, :] < a_nnz[:, None]
    a_idx = torch.where(live, a_idx % n, a_idx)
    b_live = torch.arange(r_b, device=dev)[None, :] < b_nnz[:, None]
    in_k = (b_idx >= 0) & (b_idx < k)
    c_idx, c_nnz = ell_structure(a_idx, a_nnz, b_idx, b_nnz, k, drop=~in_k)
    # a listed column no product reaches (its value is 0), one slot past the
    # row's columns: every 11th row of the random ones
    r_c = c_idx.shape[1] + 1
    c_idx = torch.nn.functional.pad(c_idx, (0, 1))
    for i in range(n + 5, m, 11):
        cn = int(c_nnz[i])
        free = sorted(set(range(min(k, 64))) - set(c_idx[i, :cn].tolist()))
        if cn and free:
            c_idx[i, cn] = free[0]
            c_nnz[i] += 1
    # unsorted rows; columns 0 and k - 1 of every 7th row and of row `full`
    # written outside [0, k)
    live_c = torch.arange(r_c, device=dev)[None, :] < c_nnz[:, None]
    keys = torch.where(live_c, torch.rand(c_idx.shape, generator=g, device=dev), 2.0)
    c_idx = torch.gather(c_idx, 1, torch.argsort(keys, dim=1))
    rows = torch.arange(m, device=dev)
    sev = ((rows % 7 == 3) | (rows == full))[:, None] & live_c
    c_idx = torch.where(sev & (c_idx == 0), -9, c_idx)
    c_idx = torch.where(sev & (c_idx == k - 1), k + 2, c_idx).to(torch.int32)
    c_nnz[n + 20] = r_c + 5
    c_nnz[n + 21] = -2
    return a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx.contiguous(), c_nnz


def check_k4_windows(km, worst, g) -> None:
    """K4 against its plain version on rows of every window class
    (k4_window_ell), with and without b_nnz, in every dtype pair."""
    for k in (70_001, 65_536, 5_000):
        a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx, c_nnz = k4_window_ell(km, k, g)
        cls = km.num.window_class(c_idx, c_nnz, k)
        counts = torch.bincount(cls + 1, minlength=len(km.num.CLASS_COLS) + 2).tolist()
        log(f"   K4 windows k={k}: rows per class (empty, <= {km.num.CLASS_COLS} columns, "
            f"wide): {counts}")
        need = [c for c in range(len(km.num.CLASS_COLS) + 1)
                if c == 0 or km.num.CLASS_COLS[c - 1] < k]
        require(counts[0] > 0 and all(counts[c + 1] > 0 for c in need),
                f"K4 windows k={k}: a window class has no row")
        gv = torch.Generator(device="cuda").manual_seed(k)
        for adt, bdt in ELL_DTYPES:
            a_val = torch.randn(a_idx.shape, generator=gv, device="cuda").to(adt)
            b_val = torch.randn(b_idx.shape, generator=gv, device="cuda").to(bdt)
            b_val0 = torch.where(b_live, b_val, torch.zeros((), dtype=bdt, device="cuda"))
            check_k4(km, f"K4 windows k={k}", f"{str(adt)[6:]}x{str(bdt)[6:]}",
                     (a_idx, a_val, a_nnz, b_idx, b_val0, b_nnz, c_idx, c_nnz), k, adt, worst)
        log(f"   K4 windows k={k}: == plain in every dtype pair, with and without b_nnz")


# (k32, rA) of K5's index checks: k32 of 1, 37 (not a multiple of 128),
# 2,048, past the warps' accumulators (hub blocks only) and past shared
# memory (device slices)
K5_INDEX_CASES = ((1, 4), (37, 40), (2048, 40), (9375, 40), (56_250, 6))


def k5_operands(m, n, k32, r_a, g, dev="cuda"):
    """A's ELL column ids and widths and B's (n, k32) int32 bitmask words:
    up to 12 random words of a B row set, rows 0 and 5 all zero, row 3 dense;
    A's ids span [-4, n + 4) (they clamp), widths in [0, rA] with garbage
    past them, row m // 2 full, row 1 selects only the zero B rows."""
    words = torch.zeros(n, k32, dtype=torch.int32, device=dev)
    pos = torch.randint(0, k32, (n, 12), generator=g, device=dev)
    vals = torch.randint(-2**31, 2**31 - 1, (n, 12), generator=g, device=dev,
                         dtype=torch.int32)
    words.scatter_(1, pos, vals)
    words[[0, 5]] = 0
    words[3] = -1
    a_idx = torch.randint(-4, n + 4, (m, r_a), generator=g, device=dev, dtype=torch.int32)
    a_nnz = torch.randint(0, r_a + 1, (m,), generator=g, device=dev, dtype=torch.int32)
    a_nnz[m // 2] = r_a
    a_idx[1, :2] = torch.tensor([0, 5], device=dev, dtype=torch.int32)
    a_nnz[1] = 2
    return a_idx, a_nnz, words


def check_k5_index(km, g) -> None:
    """K5 bitwise against its plain version, and its nonzero-word index
    against symbolic_index, on k5_operands at each of K5_INDEX_CASES."""
    m, n = 300, 64
    for k32, r_a in K5_INDEX_CASES:
        a_idx, a_nnz, words = k5_operands(m, n, k32, r_a, g)
        got = km.sym.spgemm_symbolic(a_idx, a_nnz, words)
        want = km.sym.spgemm_symbolic_plain(a_idx, a_nnz, words)
        require(torch.equal(got, want), f"K5 k32={k32}: differs from its plain version")
        out = torch.empty(m, dtype=torch.int32, device="cuda")
        summary, meta = km.sym.index_views(km.sym._launch(a_idx, a_nnz, words, out), n, k32, m)
        want_s, want_m = km.sym.symbolic_index(words)
        require(torch.equal(summary, want_s) and torch.equal(meta, want_m),
                f"K5 k32={k32}: its nonzero-word index differs from symbolic_index")
        require(torch.equal(out, want), f"K5 k32={k32}: a second launch differs")
        path = ("device slices" if k32 > km.sym.SHARED_WORDS else "hub blocks only"
                if k32 > 8192 else "warps and hub blocks")
        log(f"   K5 k32={k32} ({path}): == plain bitwise, index == symbolic_index")


def lp_class_rows(km, c_nnz, l1_size) -> list:
    """Rows per K3 size class: [empty, each of CLASS_SLOTS, device memory]."""
    cls = km.lp.lp_row_class(c_nnz, l1_size)
    return torch.bincount(cls + 1, minlength=len(km.lp.CLASS_SLOTS) + 2).tolist()


def phase_ell_kernels_vs_plain(rt, km, seed: int) -> dict:
    worst = {name: 0.0 for name in OPS_KERNELS}
    g = torch.Generator(device="cuda").manual_seed(seed + 10)
    cases = [  # (m, n, k, r_a, r_b, l1_size)
        (300, 400, 70_001, 131, 201, None),  # K4: wide windows; K3: rows in device memory
        (300, 400, 70_001, 131, 201, 16),  # K3 with a forced 16-slot L1: rows spill
        (9, 5, 13, 3, 5, None),  # k < 32
    ]
    n_cls = len(km.lp.CLASS_SLOTS) + 1
    for m, n, k, r_a, r_b, l1_size in cases:
        a_idx, a_nnz, b_idx, b_nnz, b_live = synthetic_ell(m, n, k, r_a, r_b, g, "cuda")
        c_idx, c_nnz = ell_structure(a_idx, a_nnz, b_idx, b_nnz, k)
        b_csr = ell_csr(rt, b_nnz, b_idx, torch.ones(b_idx.shape, device="cuda"), (n, k))
        bm = rt.bitmask_rows(b_csr)
        classes = lp_class_rows(km, c_nnz, l1_size)
        name = f"ell m={m} k={k} l1={l1_size}"
        log(f"   {name}: rA {r_a}, rB {r_b}, widest C row {int(c_nnz.max())}; K3 rows per "
            f"class (empty, <= {km.lp.CLASS_SLOTS} slots, device memory): {classes}")
        if k > 16384:
            require(classes[-1] > 0, f"{name}: no row needs a device-memory table")
        check_ell_kernels(km, name, (a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx, c_nnz, bm),
                          k, l1_size, worst, want_sizes=c_nnz)
    # K3 alone: every size class, with and without a forced 4-slot L1 (then
    # rows spill in every class); keys on one home slot; keys that are
    # multiples of 2^16, which the masked identity hash piled onto slot 0
    mult = synthetic_ell(1000, 1000, 1 << 12, 24, 48, g, "cuda", log_widths=True)
    mult = (*mult[:2], mult[2] * (1 << 16), *mult[3:])
    k3_cases = [
        ("every class", synthetic_ell(1000, 600, 70_001, 160, 400, g, "cuda",
                                      log_widths=True), 70_001),
        ("one home slot", lp_collision_ell(km, 1 << 24, LP_COLLISION_KEYS, "cuda"), 1 << 24),
        ("multiples of 2^16", mult, 1 << 28),
    ]
    for label, (a_idx, a_nnz, b_idx, b_nnz, b_live), k in k3_cases:
        c_idx, c_nnz = ell_structure(a_idx, a_nnz, b_idx, b_nnz, k)
        for l1_size in (None, 4):
            classes = lp_class_rows(km, c_nnz, l1_size)
            cls = km.lp.lp_row_class(c_nnz, l1_size)
            # a row spills where its L1's cutoff, min(s1 / 2, s1 - 1), is below c_nnz
            spill = (c_nnz > min(l1_size // 2, l1_size - 1) if l1_size
                     else torch.zeros_like(c_nnz, dtype=torch.bool))
            spilling = torch.bincount(cls[spill] + 1, minlength=n_cls + 1).tolist()
            name = f"K3 {label} l1={l1_size}"
            log(f"   {name}: k {k}, widest C row {int(c_nnz.max())}; rows per class (empty, "
                f"<= {km.lp.CLASS_SLOTS} slots, device memory): {classes}; rows that "
                f"spill: {spilling}")
            require(classes[0] > 0, f"{name}: no row of 0 products")
            if label == "every class":
                require(min(classes) > 0, f"{name}: a size class has no row")
                if l1_size is not None:
                    require(min(spilling[1:]) > 0, f"{name}: a size class has no spilling row")
            check_ell_kernels(km, name, (a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx, c_nnz,
                                         None), k, l1_size, worst, k3_only=True)
    check_lost_products(km, worst)
    check_large_l1(rt, km, worst)
    check_k4_windows(km, worst, g)
    check_k5_index(km, g)
    torch.cuda.synchronize()
    return worst


def sample_rows(c_nnz, count: int, g) -> torch.Tensor:
    """The ``count // 8`` widest rows and random others, sorted."""
    top = torch.topk(c_nnz, count // 8).indices
    rest = torch.randint(0, c_nnz.shape[0], (count - top.shape[0],), generator=g,
                         device=c_nnz.device)
    return torch.unique(torch.cat([top, rest]))


def check_ops_result(rt, km, name, a, b, sizes, c_nnz, c_idx, values, ref, scale,
                     g, sample: int | None) -> dict:
    """Hold one run of kernels/ops against scipy (K5's sizes exactly, C's
    structure exactly, values within 1e-4 * S + 1e-6) and each kernel against
    its plain version on all rows (``sample`` None) or on a row sample that
    includes the widest rows."""
    require(torch.equal(sizes, c_nnz), f"{name}: K5's row sizes differ from the sort path's")
    scipy_sizes = np.diff(scale.indptr)
    require(np.array_equal(sizes.cpu().numpy(), scipy_sizes),
            f"{name}: K5's row sizes differ from scipy's")
    log(f"   {name}: K5 row sizes == sort path == scipy (nnz {int(sizes.sum())}, widest "
        f"row {int(sizes.max())})")
    shape = (a.shape[0], b.shape[1])
    for label, vals in values.items():
        c = ell_csr(rt, c_nnz, c_idx, vals, shape)
        if label == next(iter(values)):
            check_against_scipy(f"{name} structure", rt.CSR(c.indptr, c.indices,
                                                             c.values.abs() + 1, shape), scale)
        check_against_scipy(f"{name} {label}", c, ref, scale)
        del c
    ea, eb = rt.csr_to_ell(a), rt.csr_to_ell(b)
    rows = (torch.arange(a.shape[0], device="cuda") if sample is None
            else sample_rows(c_nnz, sample, g))
    bm = rt.bitmask_rows(b)
    a_idx, a_val, a_nnz = ea.indices[rows], ea.values[rows], ea.row_nnz[rows]
    ci, cn = c_idx[rows].contiguous(), c_nnz[rows]
    worst = {}
    got = km.sym.spgemm_symbolic_plain(a_idx, a_nnz, bm)
    require(torch.equal(got, sizes[rows]), f"{name}: K5 differs from its plain version")

    def plain(kname, av, bv):
        if kname == "spgemm_lp":
            return km.lp.spgemm_lp_plain(a_idx, av, a_nnz, eb.indices, bv, eb.row_nnz, ci,
                                         cn, k=b.shape[1])
        return km.num.spgemm_numeric_plain(a_idx, av, a_nnz, eb.indices, bv, ci, cn,
                                           k=b.shape[1], b_nnz=eb.row_nnz)

    for label, vals in values.items():
        kname = "spgemm_lp" if "K3" in label else "spgemm_numeric"
        worst[kname] = tolerance_check(
            f"{name} {label} vs plain", vals[rows], plain(kname, a_val, eb.values),
            plain(kname, a_val.abs(), eb.values.abs()), F32_TOL)
    log(f"   {name}: K5, K3 and K4 == their plain versions on "
        f"{'all' if sample is None else rows.shape[0]} rows (widest included); "
        f"max |kernel - plain| {worst}")
    return worst


def phase_ops_powerlaw(rt, km, seed: int, pw: dict, out: dict) -> None:
    a = pw["rmat"]
    ref, scale = pw["rmat_scipy"]
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    reset_launches(km)
    t0 = time.perf_counter()
    # the main path: the kernel-backed two-phase product, auto then dense_acc
    sizes = km.ops.symbolic_rowsizes(a, a)
    c_nnz, c_idx, v_auto = km.ops.pallas_spgemm(a, a, kernel="auto")
    v_dense = km.ops.numeric_values(a, a, c_idx, c_nnz, kernel="dense_acc")
    torch.cuda.synchronize()
    launches = read_launches(km)
    picks = dict(km.ops.KERNEL_COUNTS)
    log(f"   main path {time.perf_counter() - t0:.2f} s; launches {launches}; numeric "
        f"kernels {picks}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    require(launches == {"segsum_reuse": 0, "lp_reuse": 0, "spgemm_symbolic": 2,
                         "spgemm_numeric": 1, "spgemm_lp": 1}, f"launches {launches}")
    require(picks == {"flat_lp": 1, "dense_acc": 1}, f"numeric kernels {picks}")
    check_fallbacks(rt, "A*A kernels/ops path")
    worst = check_ops_result(rt, km, "A*A kernels/ops", a, a, sizes, c_nnz, c_idx,
                             {"K3 (auto)": v_auto, "K4 (dense_acc)": v_dense}, ref, scale,
                             g, sample=64)
    out.update(launches=launches, worst=worst, c_idx=c_idx, c_nnz=c_nnz)


def phase_ops_multigrid(rt, km, seed: int, out: dict) -> None:
    t0 = time.perf_counter()
    r, a, p = rt.galerkin_triple(512, 512, agg_size=4, device="cuda")
    del r
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    vals = torch.randn(a.nnz_cap, generator=g, device="cuda")
    a = with_values(a, torch.where(vals == 0, 1.0, vals))  # no exact 0: |A|*|P| keeps C's structure
    log(f"   galerkin_triple(512, 512, 4): A {a.shape} nnz {int(a.indptr[-1])}, P {p.shape}; "
        f"made in {time.perf_counter() - t0:.2f} s")
    reset_launches(km)
    sizes = km.ops.symbolic_rowsizes(a, p)
    c_nnz, c_idx, v_auto = km.ops.pallas_spgemm(a, p, kernel="auto")
    v_lp = km.ops.numeric_values(a, p, c_idx, c_nnz, kernel="flat_lp")
    torch.cuda.synchronize()
    launches = read_launches(km)
    picks = dict(km.ops.KERNEL_COUNTS)
    log(f"   launches {launches}; numeric kernels {picks}")
    require(launches == {"segsum_reuse": 0, "lp_reuse": 0, "spgemm_symbolic": 2,
                         "spgemm_numeric": 1, "spgemm_lp": 1}, f"launches {launches}")
    require(picks == {"dense_acc": 1, "flat_lp": 1}, f"numeric kernels {picks}")
    check_fallbacks(rt, "A*P kernels/ops path")
    a_s, p_s = to_scipy(a), to_scipy(p)
    worst = check_ops_result(rt, km, "A*P kernels/ops", a, p, sizes, c_nnz, c_idx,
                             {"K4 (auto)": v_auto, "K3 (flat_lp)": v_lp}, a_s @ p_s,
                             abs(a_s) @ abs(p_s), g, sample=None)
    out.update(launches=launches, worst=worst, a=a, p=p, c_idx=c_idx, c_nnz=c_nnz)


def phase_dense_method(rt, seed: int) -> dict:
    a = rt.rmat_csr(13, 8, seed=0, device="cuda")
    t0 = time.perf_counter()
    res = rt.spgemm(a, a)
    torch.cuda.synchronize()
    st = res.stats
    log(f"   rmat_csr(13, 8) A*A, method='auto': {time.perf_counter() - t0:.2f} s; method "
        f"{st['method']}, dense_bytes {st['dense_bytes']}, cf {st['cf']:.3f} (compressed "
        f"{st['compressed']}), fm {st['fm']}, nnz {st['nnz_c']}")
    require(st["method"] == "dense" and res.plan is None, f"method {st['method']}")
    a_pos = with_values(a, a.values.abs() + 0.5)
    pos = rt.spgemm(a_pos, a_pos, method="dense")
    a_s, a_p = to_scipy(a), to_scipy(a_pos)
    check_against_scipy("dense A*A (positive)", pos.c, a_p @ a_p)
    check_against_scipy("dense A*A (normal)", res.c, a_s @ a_s, abs(a_s) @ abs(a_s))
    return {"stats": {k: st[k] for k in ("method", "dense_bytes", "cf", "compressed", "fm",
                                         "nnz_c")}}


def ell_bounds(fm, nnz_a, m, nnz_b, n, nnz_c, r_c):
    """(bound ms, what bounds it) of K3/K4: A's and B's live ELL entries
    (index + f32 value), their widths, C's live structure and its widths,
    each read once, and the (m, r_c) f32 output that the contract writes
    whole (zeros past c_nnz included), at 3.35 TB/s; 2 flops per product at
    67 TFLOP/s."""
    t_bytes = (8 * (nnz_a + nnz_b) + 4 * (m + n) + 4 * nnz_c + 4 * m * r_c
               + 4 * m) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fm / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def symbolic_bound(nnz_a, m, n, k32):
    """(bound ms, what bounds it) of K5: A's live column ids and widths, B's
    bitmask and the row sizes once at 3.35 TB/s; one OR per (live A entry,
    word) and one popcount per (row, word) as 32-bit operations at the
    67 T/s of the table's non-tensor f32 rate."""
    t_bytes = (4 * nnz_a + 8 * m + 4 * n * k32) / HBM_BYTES_PER_S * 1e3
    t_ops = (nnz_a + m) * k32 / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_ops_times(rt, km, shapes: dict) -> dict:
    """Each kernel at each shape on the main path's bucketed operands (median
    of 7, CUDA events), its plain version (median of ``plain_reps``), its
    bound, and torch.sparse.mm on the same CSR operands as the yardstick of
    K3 and K4 (the whole product, structure included)."""
    from repro_torch.core.meta import choose_kernel, round_capacity
    from repro_torch.kernels.spgemm_numeric import _pad_width

    times = {}
    for label, (a, b, c_idx, c_nnz, plain_reps) in shapes.items():
        ea, eb = rt.csr_to_ell(a), rt.csr_to_ell(b)
        bm = rt.bitmask_rows(b)
        k = b.shape[1]
        # the operands as numeric_values' bucketed wrappers pad them
        a_idx = _pad_width(ea.indices, round_capacity(ea.r_pad))
        a_val = _pad_width(ea.values, a_idx.shape[1])
        b_idx = _pad_width(eb.indices, round_capacity(eb.r_pad))
        b_val = _pad_width(eb.values, b_idx.shape[1])
        c_idx_p = _pad_width(c_idx, round_capacity(c_idx.shape[1]))
        kern = {
            "spgemm_symbolic": lambda: km.sym.spgemm_symbolic(a_idx, ea.row_nnz, bm),
            "spgemm_lp": lambda: km.lp.spgemm_lp(a_idx, a_val, ea.row_nnz, b_idx, b_val,
                                                 eb.row_nnz, c_idx_p, c_nnz, k=k),
            "spgemm_numeric": lambda: km.num.spgemm_numeric(a_idx, a_val, ea.row_nnz, b_idx,
                                                            b_val, c_idx_p, c_nnz, k=k,
                                                            b_nnz=eb.row_nnz),
        }
        plain = {
            "spgemm_symbolic": lambda: km.sym.spgemm_symbolic_plain(ea.indices, ea.row_nnz, bm),
            "spgemm_lp": lambda: km.lp.spgemm_lp_plain(ea.indices, ea.values, ea.row_nnz,
                                                       eb.indices, eb.values, eb.row_nnz,
                                                       c_idx, c_nnz, k=k),
            "spgemm_numeric": lambda: km.num.spgemm_numeric_plain(
                ea.indices, ea.values, ea.row_nnz, eb.indices, eb.values, c_idx, c_nnz,
                k=k, b_nnz=eb.row_nnz),
        }
        row = {name: {"ms": time_ms(fn)} for name, fn in kern.items()}
        for name, fn in plain.items():
            row[name]["plain_ms"] = time_ms(fn, reps=plain_reps)
        nnz_a, nnz_b = int(a.indptr[-1]), int(b.indptr[-1])
        fm = int(rt.flops_stats(a, b.row_nnz())[0])
        nnz_c = int(c_nnz.sum())
        m, n = a.shape[0], b.shape[0]
        lib = time_ms(sparse_mm(a, b))
        for name in ("spgemm_lp", "spgemm_numeric"):
            row[name]["bound_ms"], row[name]["bound_by"] = ell_bounds(
                fm, nnz_a, m, nnz_b, n, nnz_c, c_idx_p.shape[1])
            row[name]["library_ms"] = lib
        sb = symbolic_bound(nnz_a, m, n, bm.shape[1])
        row["spgemm_symbolic"].update(bound_ms=sb[0], bound_by=sb[1], library_ms=None)
        pick = choose_kernel(a, b, {"fm": fm})
        times[label] = row
        log(f"   {label}: fm {fm}, nnz(C) {nnz_c}, rA {ea.r_pad}, rB {eb.r_pad}, rC "
            f"{c_idx.shape[1]}, k32 {bm.shape[1]}; choose_kernel -> {pick}")
        for name, r in row.items():
            lib_s = ("null: no PyTorch call computes row sizes alone" if r["library_ms"] is None
                     else f"{r['library_ms']:.3f} ms (torch.sparse.mm, the whole product)")
            log(f"      {name}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms (median of "
                f"{plain_reps}), bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']}), library {lib_s}")
        log(f"      K3 / K4 = {row['spgemm_lp']['ms'] / row['spgemm_numeric']['ms']:.2f}, "
            f"K3 / torch.sparse.mm = {row['spgemm_lp']['ms'] / lib:.2f} (choose_kernel picks "
            f"{pick})")
        # where K3's time goes: each size class's rows alone, K4 on the same rows
        fm_row = rt.flops_stats(a, b.row_nnz())[1]
        cls = km.lp.lp_row_class(c_nnz, None)
        for c in range(len(km.lp.CLASS_SLOTS) + 1):
            rows = torch.nonzero(cls == c).flatten()
            if not rows.numel():
                continue
            wa = (a_idx[rows], a_val[rows], ea.row_nnz[rows])
            wc = (c_idx_p[rows], c_nnz[rows])
            k3c = time_ms(lambda: km.lp.spgemm_lp(*wa, b_idx, b_val, eb.row_nnz, *wc, k=k))
            k4c = time_ms(lambda: km.num.spgemm_numeric(*wa, b_idx, b_val, *wc, k=k,
                                                        b_nnz=eb.row_nnz))
            what = ("device memory" if c == len(km.lp.CLASS_SLOTS)
                    else f"<= {km.lp.CLASS_SLOTS[c]} slots")
            log(f"      K3 class {c} ({what}): {rows.numel()} rows, "
                f"{int(fm_row[rows].sum())} of the {fm} products, "
                f"{int(c_nnz[rows].sum())} of the {nnz_c} C entries; alone K3 "
                f"{k3c:.3f} ms, K4 {k4c:.3f} ms")
            del wa, wc
        # where K4's time goes: each of its window classes' rows alone
        wcls = km.num.window_class(c_idx_p, c_nnz, k)
        for c in range(len(km.num.CLASS_COLS) + 1):
            rows = torch.nonzero(wcls == c).flatten()
            if not rows.numel():
                continue
            wa = (a_idx[rows], a_val[rows], ea.row_nnz[rows])
            wc = (c_idx_p[rows], c_nnz[rows])
            k4c = time_ms(lambda: km.num.spgemm_numeric(*wa, b_idx, b_val, *wc, k=k,
                                                        b_nnz=eb.row_nnz))
            what = ("wide" if c == len(km.num.CLASS_COLS)
                    else f"<= {km.num.CLASS_COLS[c]} columns")
            log(f"      K4 window class {c} ({what}): {rows.numel()} rows, "
                f"{int(fm_row[rows].sum())} of the {fm} products, "
                f"{int(c_nnz[rows].sum())} of the {nnz_c} C entries; alone K4 {k4c:.3f} ms "
                f"(torch.sparse.mm, the whole product: {lib:.3f} ms)")
            del wa, wc
        del ea, eb, bm, a_idx, a_val, b_idx, b_val, c_idx_p
        torch.cuda.empty_cache()
    return times


def sparse_mm(x, y):
    """torch.sparse.mm of two port CSRs (a yardstick; the port never calls it)."""
    def csr_t(c):
        nnz = int(c.indptr[-1])
        return torch.sparse_csr_tensor(c.indptr.long(), c.indices[:nnz].long(),
                                       c.values[:nnz], size=c.shape)
    xt, yt = csr_t(x), csr_t(y)
    return lambda: torch.sparse.mm(xt, yt)



# ---------------------------------------------------------------------------
# The last three kernels through their entry points: K6 bsr_spgemm
# (plan_bsr_numeric -> bsr_spgemm_numeric), K7 grouped_matmul
# (ops.expert_matmul), K8 flash_attention (ops.attention)
# ---------------------------------------------------------------------------

NEW_KERNELS = ("bsr_spgemm", "grouped_matmul", "flash_attention")
# the reference's tests (f16 as bf16: its rounding is finer)
K7_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2, torch.float16: 3e-2}
# ||kernel - plain||_F / ||plain||_F of each K7 output, beside K7_TOL, by x's
# dtype: both sum in f32 and round once, so they differ by rounding flips of
# the output; a wrong B descriptor or a lost stage moves every output. Bounds:
# 5-8x the worst measured on an H100 (phases 2 and 11): bf16 1.03e-4, f16
# 4.1e-5, f32 8.5e-7.
K7_FRO = {torch.float32: 5e-6, torch.bfloat16: 6e-4, torch.float16: 3e-4}
K7_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float16, torch.float16), (torch.bfloat16, torch.float32),
            (torch.float16, torch.bfloat16)]
K8_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2, torch.float16: 5e-2}
# ||kernel - plain||_F / ||plain||_F of each K8 output, beside K8_TOL: at T
# 8,192 a typical |out| is below K8_TOL's atol, so that rule alone would pass
# a kernel that drops a key stage. Bounds: 4-10x the worst measured on an
# H100 (phases 2 and 12): bf16 2.3e-3, f16 2.9e-4, f32 1.1e-6.
K8_FRO = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 (and f16) tensor-core peak
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def close_excess(got, want, tol, fro=None) -> tuple:
    """(largest |got - want|, ||got - want||_F / ||want||_F, passes): passes
    when every |got - want| <= tol + tol * |want| (the reference tests' rule)
    and, where ``fro`` is given, the relative Frobenius error is <= fro."""
    diff = got.float() - want.float()
    err = diff.abs()
    excess = float((err - tol * want.float().abs()).max()) if err.numel() else 0.0
    rel = float(diff.norm() / want.float().norm().clamp_min(1e-30)) if err.numel() else 0.0
    return (float(err.max()) if err.numel() else 0.0, rel,
            excess <= tol and (fro is None or rel <= fro))


def close_check(name, got, want, tol, fro=None) -> tuple:
    """Hold ``got`` to ``want`` within rtol = atol = ``tol`` (the reference
    tests' rule) and, where ``fro`` is given, ||got - want||_F / ||want||_F
    <= ``fro``; return (largest |got - want|, relative Frobenius error)."""
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{name}: {got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    err, rel, ok = close_excess(got, want, tol, fro)
    require(ok, f"{name}: |kernel - plain| max {err:.3e} (bound {tol} + {tol} * |plain|), "
                f"relative Frobenius {rel:.3e} (bound {fro})")
    return err, rel


def reset_new_launches(km) -> None:
    km.bsr.LAUNCHES = km.gm.LAUNCHES = km.fa.LAUNCHES = 0
    km.telemetry.FALLBACK_COUNTS.clear()


def read_new_launches(km) -> dict:
    return {"bsr_spgemm": km.bsr.LAUNCHES, "grouped_matmul": km.gm.LAUNCHES,
            "flash_attention": km.fa.LAUNCHES}


def synthetic_bsr_plan(nnzb_a, nnzb_b, nnzb_c, t_max, g, dev):
    """Plan arrays whose live slots never name block 0 and whose padded
    slots all do, as plan_bsr_numeric pads them."""
    n = torch.randint(0, t_max + 1, (nnzb_c,), generator=g, device=dev, dtype=torch.int32)
    live = torch.arange(t_max, device=dev)[None, :] < n[:, None]
    ca = torch.randint(1, nnzb_a, (nnzb_c, t_max), generator=g, device=dev)
    cb = torch.randint(1, nnzb_b, (nnzb_c, t_max), generator=g, device=dev)
    return (torch.where(live, ca, 0).to(torch.int32), torch.where(live, cb, 0).to(torch.int32), n)


def phase_new_kernels_vs_plain(km, seed: int, dev="cuda") -> dict:
    """K6, K7 and K8 against their plain versions on synthetic inputs: K6 with
    NaN in block 0 (only padded slots name it), bs 8 and 16, mixed dtypes; K7
    with unsorted expert ids; K8 in f32, bf16 and f16 with ragged tiles, Tq !=
    Tk, head dims 16-256, softcap, windows that mask whole tiles before a
    row's first live key, rows with no live key, scores of several hundred
    (q and k scaled by 8), and window 0 (every key masked: the mean of V)."""
    worst = {name: 0.0 for name in NEW_KERNELS}
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    for nnzb_a, nnzb_b, nnzb_c, t_max, bs in ((500, 700, 200_003, 9, 8), (300, 200, 50_001, 5, 16),
                                             (3, 2, 1, 1, 8)):
        ca, cb, cn = synthetic_bsr_plan(nnzb_a, nnzb_b, nnzb_c, t_max, g, dev)
        for adt, bdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
            a = torch.randn(nnzb_a, bs, bs, generator=g, device=dev).to(adt)
            b = torch.randn(nnzb_b, bs, bs, generator=g, device=dev).to(bdt)
            a[0] = float("nan")
            b[0] = float("nan")
            got = km.bsr.bsr_spgemm_numeric(a, b, ca, cb, cn)
            want = km.bsr.bsr_spgemm_plain(a, b, ca, cb, cn)
            a[0] = b[0] = 0
            scale = km.bsr.bsr_spgemm_plain(a.float().abs(), b.float().abs(), ca, cb, cn)
            require(got.dtype == want.dtype == adt, f"K6 output dtype {got.dtype}")
            err = tolerance_check(f"bsr_spgemm nnzb_c={nnzb_c} bs={bs} {adt}x{bdt}", got, want,
                                  scale, F32_TOL if adt == torch.float32 else BF16_TOL)
            worst["bsr_spgemm"] = max(worst["bsr_spgemm"], err)
    log(f"   bsr_spgemm == plain (NaN in block 0 not leaked): max |kernel - plain| "
        f"{worst['bsr_spgemm']:.3e}")
    k7_rel = {}
    # unsorted expert ids, some out of [0, E) (they clamp); one token block;
    # the MoE projections' (d, f)
    for e, d, f, blocks in ((8, 512, 384, 13), (3, 128, 128, 1), (4, 768, 2048, 5),
                            (4, 2048, 768, 5)):
        be = torch.randint(-2, e + 2, (blocks,), generator=g, device=dev, dtype=torch.int32)
        for xd, wd in K7_PAIRS:
            x = torch.randn(blocks * 128, d, generator=g, device=dev).to(xd)
            w = (torch.randn(e, d, f, generator=g, device=dev) * 0.05).to(wd)
            err, rel = close_check(f"grouped_matmul {e}x{d}x{f} {DT_NAME[xd]}x{DT_NAME[wd]} "
                                   f"({km.gm.variant(xd, wd)})",
                                   km.gm.grouped_matmul(x, w, be),
                                   km.gm.grouped_matmul_plain(x, w, be), K7_TOL[xd], K7_FRO[xd])
            worst["grouped_matmul"] = max(worst["grouped_matmul"], err)
            key = f"{DT_NAME[xd]}x{DT_NAME[wd]} ({km.gm.variant(xd, wd)})"
            k7_rel[key] = max(k7_rel.get(key, 0.0), rel)
    log(f"   grouped_matmul == plain: max |kernel - plain| {worst['grouped_matmul']:.3e}; "
        "worst relative Frobenius " + ", ".join(f"{k} {r:.3e}" for k, r in k7_rel.items())
        + f" (bounds {', '.join(f'{DT_NAME[dt]} {b}' for dt, b in K7_FRO.items())})")
    cases = [  # (hq, hkv, tq, tk, d, kwargs, scale of q and k)
        (4, 2, 320, 320, 256, dict(causal=True, window=100, softcap=50.0), 1.0),
        (2, 1, 136, 200, 256, dict(causal=True, softcap=50.0), 1.0),  # Tq != Tk, both ragged
        # scores in the hundreds: tanh saturates, so the softcap decides the output
        (2, 1, 136, 200, 256, dict(causal=True, softcap=50.0), 8.0),
        (4, 2, 192, 192, 256, dict(causal=False, softcap=30.0), 8.0),
        (4, 1, 192, 384, 128, dict(causal=True, softcap=30.0), 8.0),
        (2, 1, 256, 256, 32, dict(causal=True, softcap=50.0), 8.0),
        (4, 2, 128, 200, 32, dict(causal=False, softcap=30.0), 8.0),
        (4, 1, 192, 384, 128, dict(causal=True), 1.0),
        (2, 1, 512, 512, 128, dict(causal=True, window=64), 1.0),  # masked tiles, then live
        (2, 2, 96, 96, 64, dict(causal=False, window=3), 1.0),
        (2, 1, 256, 256, 64, dict(causal=True), 8.0),  # scores of several hundred
        (4, 2, 200, 72, 64, dict(causal=False), 1.0),  # Tq > Tk, ragged keys
        (4, 2, 200, 72, 64, dict(causal=True, window=16), 1.0),  # rows past 86: no live key
        (2, 1, 64, 40, 64, dict(causal=False), 1.0),  # Tk shorter than one K/V stage
        (4, 2, 256, 256, 32, dict(causal=True, window=0), 1.0),
        (2, 1, 64, 320, 16, dict(causal=False), 1.0),
    ]
    rel_worst = {}
    for hq, hkv, tq, tk, d, kw, amp in cases:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            q = (torch.randn(hq, tq, d, generator=g, device=dev) * amp).to(dt)
            k = (torch.randn(hkv, tk, d, generator=g, device=dev) * amp).to(dt)
            v = torch.randn(hkv, tk, d, generator=g, device=dev).to(dt)
            got = km.fa.flash_attention(q, k, v, block_q=math.gcd(tq, 128),
                                        block_k=math.gcd(tk, 128), **kw)
            want = km.fa.flash_attention_plain(q, k, v, **kw)
            name = f"flash_attention {hq}x{hkv}x{tq}x{tk}x{d} {kw} x{amp} {dt}"
            err, rel = close_check(name, got, want, K8_TOL[dt], K8_FRO[dt])
            worst["flash_attention"] = max(worst["flash_attention"], err)
            rel_worst[dt] = max(rel_worst.get(dt, 0.0), rel)
            if kw.get("softcap") and amp > 1:  # the check can fail: no softcap is caught
                uncapped = km.fa.flash_attention_plain(
                    q, k, v, **{key: val for key, val in kw.items() if key != "softcap"})
                _, rel_off, ok = close_excess(uncapped, want, K8_TOL[dt], K8_FRO[dt])
                require(not ok, f"{name}: the output without the softcap passes the check")
                log(f"   {name}: relative Frobenius {rel:.3e}; without the softcap {rel_off:.3e}")
            if kw.get("window") == 0:
                mean_v = v.float().mean(1).repeat_interleave(hq // hkv, 0)[:, None, :]
                close_check("window=0 gives the mean of V", got.float(),
                            mean_v.expand(got.shape).contiguous(), K8_TOL[dt], K8_FRO[dt])
    log(f"   flash_attention == plain: max |kernel - plain| {worst['flash_attention']:.3e}; "
        "worst relative Frobenius " + ", ".join(f"{DT_NAME[dt]} {r:.3e} (bound {K8_FRO[dt]})"
                                                for dt, r in rel_worst.items()))
    return worst


def bsr_to_csr(indptr, indices, blocks, n_cols):
    """A BSR operand as a scalar CSR (torch.sparse_csr_tensor) with
    ``n_cols`` columns, for the yardstick torch.sparse.mm; the port never
    calls it."""
    dev = blocks.device
    nnzb, bs, _ = blocks.shape
    mb = indptr.shape[0] - 1
    width = indptr.diff().long()
    rows = torch.repeat_interleave(torch.arange(mb, device=dev), width)
    local = torch.arange(nnzb, device=dev) - indptr[:-1].long()[rows]
    r = torch.arange(bs, device=dev)
    # position of scalar (block e, row r, col c) in the CSR arrays
    pos = (indptr[:-1].long()[rows] * bs * bs)[:, None, None] \
        + (r[None, :, None] * width[rows][:, None, None] * bs) \
        + (local * bs)[:, None, None] + r[None, None, :]
    vals = torch.empty(nnzb * bs * bs, dtype=blocks.dtype, device=dev)
    cols = torch.empty(nnzb * bs * bs, dtype=torch.int64, device=dev)
    vals[pos.flatten()] = blocks.flatten()
    cols[pos.flatten()] = (indices[:nnzb].long()[:, None, None] * bs
                           + r[None, None, :]).expand(nnzb, bs, bs).flatten()
    crow = torch.zeros(mb * bs + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(width.repeat_interleave(bs) * bs, 0)
    return torch.sparse_csr_tensor(crow, cols, vals, size=(mb * bs, n_cols))


def check_bsr_against_scipy(name, a_ip, a_ix, a_bl, c_plan, c_bl, scale) -> None:
    """Hold C = A*A (BSR) to scipy's bsr_matrix product in float64: C's block
    structure exactly, its values within 1e-4 * S + 1e-6 (S the product of
    |A|, from the plain version)."""
    import scipy.sparse as sp

    t0 = time.perf_counter()
    bs = a_bl.shape[1]
    n = (a_ip.shape[0] - 1) * bs
    nnzb = int(a_ip[-1])
    sa = sp.bsr_matrix((a_bl[:nnzb].double().cpu().numpy(), a_ix[:nnzb].cpu().numpy(),
                        a_ip.cpu().numpy()), shape=(n, n))
    sc = sa @ sa
    sc.sort_indices()
    c_ip, c_ix = c_plan[0].cpu().numpy(), c_plan[1].cpu().numpy()
    require(np.array_equal(sc.indptr, c_ip) and np.array_equal(sc.indices, c_ix),
            f"{name}: C's block structure differs from scipy's")
    err = np.abs(c_bl.double().cpu().numpy() - sc.data)
    bound = F32_TOL[0] * scale.double().cpu().numpy() + F32_TOL[1]
    worst = float((err / bound).max()) if err.size else 0.0
    require(worst <= 1.0, f"{name}: values differ from scipy float64 (worst ratio {worst:.3g})")
    log(f"   {name}: {len(c_ix)} C blocks == scipy bsr_matrix structure; max |port - scipy f64| "
        f"{float(err.max()):.3e} (worst ratio to tolerance {worst:.3f}); {time.perf_counter() - t0:.2f} s")


def phase_bsr(rt, km, seed: int, out: dict, grid=512, small_grid=128, dev="cuda") -> None:
    """The block multigrid: the 5-point operator of galerkin_triple(grid,
    grid, 4) as a block structure with 8 x 8 f32 blocks (8 unknowns a node),
    squared at block granularity: the plan once, then two numeric phases with
    new block values (Reuse at block granularity), each against the plain
    version and the second against scipy; then bs = 16 at a smaller grid."""
    _, a, _ = rt.galerkin_triple(grid, grid, agg_size=4, device=dev)
    nnzb = int(a.indptr[-1])
    a_ip, a_ix = a.indptr, a.indices[:nnzb].contiguous()
    g = torch.Generator(device=dev).manual_seed(seed + 30)
    values = [torch.randn(nnzb, 8, 8, generator=g, device=dev) for _ in range(2)]
    reset_new_launches(km)
    t0 = time.perf_counter()
    plan = km.bsr_api.plan_bsr_numeric(a_ip, a_ix, a_ip, a_ix)  # the main path
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    results = [km.bsr_api.bsr_spgemm_numeric(v, v, *plan[2:]) for v in values]
    torch.cuda.synchronize()
    launches = read_new_launches(km)
    c_ip, c_ix, ca, cb, cn = plan
    contribs = int(cn.sum())
    log(f"   block A: {a_ip.shape[0] - 1} block rows, {nnzb} blocks of 8 x 8 f32 "
        f"({nnzb * 256 / 1e6:.1f} MB); C: {c_ix.shape[0]} blocks ({c_ix.shape[0] * 256 / 1e6:.1f} MB), "
        f"T_max {ca.shape[1]}, {contribs} block products; plan {t_plan * 1e3:.1f} ms; launches "
        f"{launches}")
    require(launches == {"bsr_spgemm": 2, "grouped_matmul": 0, "flash_attention": 0},
            f"launches {launches}")
    check_fallbacks(rt, "block multigrid path")
    worst = 0.0
    for step, (v, c) in enumerate(zip(values, results)):
        want = km.bsr.bsr_spgemm_plain(v, v, ca, cb, cn)
        scale = km.bsr.bsr_spgemm_plain(v.abs(), v.abs(), ca, cb, cn)
        worst = max(worst, tolerance_check(f"K6 numeric phase {step}", c, want, scale, F32_TOL))
        del want
    log(f"   K6 vs plain: max |kernel - plain| {worst:.3e}")
    check_bsr_against_scipy("C = A*A (bs 8)", a_ip, a_ix, values[1], plan, results[1], scale)
    del scale, results
    # bs = 16 at a smaller grid
    _, a16, _ = rt.galerkin_triple(small_grid, small_grid, agg_size=4, device=dev)
    n16 = int(a16.indptr[-1])
    ip16, ix16 = a16.indptr, a16.indices[:n16].contiguous()
    v16 = torch.randn(n16, 16, 16, generator=g, device=dev)
    plan16 = km.bsr_api.plan_bsr_numeric(ip16, ix16, ip16, ix16)
    c16 = km.bsr_api.bsr_spgemm_numeric(v16, v16, *plan16[2:])
    want16 = km.bsr.bsr_spgemm_plain(v16, v16, *plan16[2:])
    scale16 = km.bsr.bsr_spgemm_plain(v16.abs(), v16.abs(), *plan16[2:])
    worst = max(worst, tolerance_check("K6 bs=16", c16, want16, scale16, F32_TOL))
    check_bsr_against_scipy(f"C = A*A (bs 16, {small_grid}^2 grid)", ip16, ix16, v16, plan16,
                            c16, scale16)
    out.update(launches=launches, worst=worst, a_ip=a_ip, a_ix=a_ix, blocks=values[0],
               plan=plan, contribs=contribs)


def moe_layout(n_tokens, n_experts, top_k, g, dev):
    """Route ``n_tokens`` top-k by seeded router logits; sort the assignments
    by expert and pad each expert's rows to a multiple of 128. Returns (row of
    each assignment, its token, block_expert, rows in all)."""
    logits = torch.randn(n_tokens, n_experts, generator=g, device=dev)
    experts = torch.topk(logits, top_k, dim=1).indices.flatten()
    tokens = torch.arange(n_tokens, device=dev).repeat_interleave(top_k)
    experts, order = torch.sort(experts, stable=True)
    tokens = tokens[order]
    counts = torch.bincount(experts, minlength=n_experts)
    padded = (counts + 127) // 128 * 128
    start = torch.cumsum(padded, 0) - padded
    first = torch.cumsum(counts, 0) - counts
    rows = start[experts] + torch.arange(experts.shape[0], device=dev) - first[experts]
    block_expert = torch.repeat_interleave(torch.arange(n_experts, device=dev),
                                           padded // 128).to(torch.int32)
    return rows, tokens, block_expert, int(padded.sum())


MOE_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def phase_moe(rt, km, seed: int, out: dict, n_tokens=4096, dev="cuda") -> None:
    """K7 at qwen3-moe-30b-a3b widths through ops.expert_matmul: tokens routed
    top-8 over 128 experts, sorted by expert and padded per expert to 128
    rows; one layer's up projection x @ w1 (d_model -> expert width) and
    down projection (expert width -> d_model, on x @ w1's output), each in
    bf16, f16 and f32."""
    cfg = rt.get_config("qwen3-moe-30b-a3b")
    d, f, n_exp, top_k = cfg.d_model, cfg.moe_d_ff, cfg.num_experts, cfg.experts_per_token
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    rows, tokens, be, n_rows = moe_layout(n_tokens, n_exp, top_k, g, dev)
    x_tok = torch.randn(n_tokens, d, generator=g, device=dev)
    x = torch.zeros(n_rows, d, device=dev)
    x[rows] = x_tok[tokens]
    w1 = torch.randn(n_exp, d, f, generator=g, device=dev) * 0.02
    w2 = torch.randn(n_exp, f, d, generator=g, device=dev) * 0.02
    used = int((torch.bincount(be.long(), minlength=n_exp) > 0).sum())
    log(f"   {cfg.name}: d_model {d}, expert width {f}, {n_exp} experts, top-{top_k}; "
        f"{n_tokens} tokens -> {rows.shape[0]} assignments in {n_rows} rows "
        f"({n_rows // 128} blocks, {used} experts with tokens); each projection "
        f"{2 * n_rows * d * f / 1e12:.3f} TFLOP")
    ins, ys = {}, {}
    reset_new_launches(km)
    for dt in MOE_DTYPES:  # the main path: up, then down on its output
        xd, w1d, w2d = x.to(dt), w1.to(dt), w2.to(dt)
        ys["x@w1", dt] = km.ops.expert_matmul(xd, w1d, be)
        ys["down", dt] = km.ops.expert_matmul(ys["x@w1", dt], w2d, be)
        ins["x@w1", dt], ins["down", dt] = (xd, w1d), (ys["x@w1", dt], w2d)
    torch.cuda.synchronize()
    launches = read_new_launches(km)
    require(launches == {"bsr_spgemm": 0, "grouped_matmul": 2 * len(MOE_DTYPES),
                         "flash_attention": 0}, f"launches {launches}")
    check_fallbacks(rt, "MoE path")
    del x, w1, w2
    pad = torch.ones(n_rows, dtype=torch.bool, device=dev)
    pad[rows] = False
    worst = 0.0
    for (proj, dt), y in ys.items():
        width = f if proj == "x@w1" else d
        require(y.shape == (n_rows, width) and y.dtype == dt,
                f"K7 {proj} output {y.dtype} {tuple(y.shape)}")
        require(bool((y[pad] == 0).all()), f"K7 {proj}: padding rows are not 0")
        err, rel = close_check(f"K7 {proj} {DT_NAME[dt]}", y,
                               km.gm.grouped_matmul_plain(*ins[proj, dt], be), K7_TOL[dt],
                               K7_FRO[dt])
        worst = max(worst, err)
        log(f"   K7 {proj} {DT_NAME[dt]}, variant {km.gm.variant(dt, dt)}: max |kernel - "
            f"plain| {err:.3e}, relative Frobenius {rel:.3e} (bound {K7_FRO[dt]}); padding "
            f"rows 0")
    out.update(launches=launches, worst=worst, ins=ins, be=be, n_rows=n_rows,
               assignments=rows.shape[0], cfg=cfg, used=used)


ATTN_T = 8192


def attention_shapes(rt) -> list:
    """(label, config, Hq, Hkv, D, kwargs, dtype, SDPA applies) of phase 12."""
    gem = rt.get_config("gemma2-9b")
    lla = rt.get_config("llama3.2-1b")
    qwe = rt.get_config("qwen3-moe-30b-a3b")
    shapes = []
    for dt in (torch.bfloat16, torch.float32):
        for layer, window in (("local", gem.window), ("global", None)):
            shapes.append((f"gemma2-9b {layer} {DT_NAME[dt]}", gem, dict(
                causal=True, window=window, softcap=gem.attn_softcap), dt, False))
    shapes.append(("llama3.2-1b bf16", lla, dict(causal=True), torch.bfloat16, True))
    shapes.append(("qwen3-moe-30b-a3b bf16", qwe, dict(causal=True), torch.bfloat16, True))
    return shapes


def live_pairs(t, causal, window) -> int:
    """(query, key) pairs that a causal / windowed mask leaves live, T x T."""
    q = np.arange(t, dtype=np.int64)
    hi = q if causal else np.full(t, t - 1)
    lo = np.zeros(t, np.int64) if window is None else np.maximum(0, q - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def phase_attention(rt, km, seed: int, out: dict, t=ATTN_T, dev="cuda") -> None:
    """K8 through ops.attention at full head widths, T = 8192: gemma2-9b
    (softcap 50; a local layer with its 4,096 window and a global layer; bf16
    and f32), llama3.2-1b and qwen3-moe-30b-a3b (causal, bf16)."""
    g = torch.Generator(device=dev).manual_seed(seed + 50)
    worst = 0.0
    ins = {}
    reset_new_launches(km)
    results = {}
    for label, cfg, kw, dt, _ in attention_shapes(rt):
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        qkv = tuple(torch.randn(h, t, d, generator=g, device=dev).to(dt) for h in (hq, hkv, hkv))
        ins[label] = qkv
        results[label] = km.ops.attention(*qkv, **kw)  # the main path
    torch.cuda.synchronize()
    launches = read_new_launches(km)
    n = len(results)
    require(launches == {"bsr_spgemm": 0, "grouped_matmul": 0, "flash_attention": n},
            f"launches {launches}")
    check_fallbacks(rt, "attention path")
    for label, cfg, kw, dt, _ in attention_shapes(rt):
        got = results.pop(label)
        err, rel = close_check(f"K8 {label}", got,
                               km.fa.flash_attention_plain(*ins[label], **kw), K8_TOL[dt],
                               K8_FRO[dt])
        worst = max(worst, err)
        log(f"   K8 {label}: Hq {cfg.num_heads}, Hkv {cfg.num_kv_heads}, D "
            f"{cfg.resolved_head_dim}, T {t}, {kw}, variant "
            f"{km.fa.variant(dt, cfg.resolved_head_dim)}: max |kernel - plain| {err:.3e}, "
            f"relative Frobenius {rel:.3e} (bound {K8_FRO[dt]})")
        del got
    out.update(launches=launches, worst=worst, ins=ins, t=t)


def sparse_mm_yardstick(a_ip, a_ix, blocks):
    """(ms, text) of torch.sparse.mm squaring the BSR operand as a scalar
    CSR, the whole product; (None, why) where cuSPARSE cannot run it."""
    n = (a_ip.shape[0] - 1) * blocks.shape[1]
    try:
        scalar = bsr_to_csr(a_ip, a_ix, blocks, n)
        ms = time_ms(lambda: torch.sparse.mm(scalar, scalar))
    except (torch.cuda.OutOfMemoryError, RuntimeError) as e:  # cuSPARSE's limits
        torch.cuda.empty_cache()
        return None, f"null: torch.sparse.mm on the scalar CSR fails ({str(e).splitlines()[0][:160]})"
    del scalar
    torch.cuda.empty_cache()
    return ms, f"{ms:.3f} ms (torch.sparse.mm, scalar CSR, the whole product)"


def bsr_bound(a, b, ca, contribs) -> tuple:
    """(ms, "bytes" or "operations") of K6 on these inputs: A's and B's
    blocks once each (once in all where they are one tensor), the plan and C
    once at 3.35 TB/s, against 2 * bs^3 flops a block product at 67
    TFLOP/s."""
    nnzb_c, t_max = ca.shape
    bs = a.shape[1]
    moved = a.numel() * a.element_size() + (0 if b is a else b.numel() * b.element_size()) \
        + (2 * t_max + 1) * nnzb_c * 4 + nnzb_c * bs * bs * a.element_size()
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * bs ** 3 * contribs / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_new_times(rt, km, bsr: dict, moe: dict, attn: dict) -> dict:
    """K6, K7 and K8 at the shapes of phases 10-12 (median of 7, CUDA
    events) beside their plain versions, bounds and one PyTorch call where
    one computes the same function."""
    import torch.nn.functional as F

    times = {}
    # K6
    v, (c_ip, c_ix, ca, cb, cn) = bsr["blocks"], bsr["plan"]
    nnzb_c, t_max = ca.shape
    row = {"ms": time_ms(lambda: km.bsr_api.bsr_spgemm_numeric(v, v, ca, cb, cn)),
           "plain_ms": time_ms(lambda: km.bsr.bsr_spgemm_plain(v, v, ca, cb, cn))}
    row["bound_ms"], row["bound_by"] = bsr_bound(v, v, ca, bsr["contribs"])
    row["library_ms"], lib_s = sparse_mm_yardstick(bsr["a_ip"], bsr["a_ix"], v)
    times["bsr_spgemm"] = {"block multigrid 512^2 bs 8 f32": row}
    log(f"   K6 block multigrid 512^2, bs 8, f32 ({bsr['contribs']} block products, {nnzb_c} C "
        f"blocks): {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
        f"ms ({row['bound_by']}: A's blocks, the plan and C once at 3.35 TB/s), library {lib_s}")
    if row["library_ms"] is None:  # the same comparison where cuSPARSE can run it
        _, a, _ = rt.galerkin_triple(256, 256, agg_size=4, device="cuda")
        nnzb = int(a.indptr[-1])
        ip, ix = a.indptr, a.indices[:nnzb].contiguous()
        v2 = torch.randn(nnzb, 8, 8, device="cuda")
        plan = km.bsr_api.plan_bsr_numeric(ip, ix, ip, ix)
        k_ms = time_ms(lambda: km.bsr_api.bsr_spgemm_numeric(v2, v2, *plan[2:]))
        lib_ms, lib_s = sparse_mm_yardstick(ip, ix, v2)
        log(f"   K6 block multigrid 256^2, bs 8, f32 ({int(plan[4].sum())} block products): "
            f"{k_ms:.3f} ms, library {lib_s}")
        row["at_256"] = {"ms": k_ms, "library_ms": lib_ms}
        del v2, plan
        torch.cuda.empty_cache()
    # bs 16 f32 on the same plan (the structure is the same), against the
    # plain version (scipy checks bs 16 at the small grid in phase 10)
    v16 = torch.randn(v.shape[0], 16, 16, generator=torch.Generator(device="cuda").manual_seed(16),
                      device="cuda")
    got = km.bsr_api.bsr_spgemm_numeric(v16, v16, ca, cb, cn)
    err16 = tolerance_check("K6 bs 16, 512^2", got, km.bsr.bsr_spgemm_plain(v16, v16, ca, cb, cn),
                            km.bsr.bsr_spgemm_plain(v16.abs(), v16.abs(), ca, cb, cn), F32_TOL)
    del got
    row16 = {"ms": time_ms(lambda: km.bsr_api.bsr_spgemm_numeric(v16, v16, ca, cb, cn)),
             "plain_ms": time_ms(lambda: km.bsr.bsr_spgemm_plain(v16, v16, ca, cb, cn)),
             "library_ms": None, "max_abs_err": err16}
    row16["bound_ms"], row16["bound_by"] = bsr_bound(v16, v16, ca, bsr["contribs"])
    times["bsr_spgemm"]["block multigrid 512^2 bs 16 f32"] = row16
    log(f"   K6 block multigrid 512^2, bs 16, f32: {row16['ms']:.3f} ms, plain "
        f"{row16['plain_ms']:.3f} ms, bound {row16['bound_ms']:.3f} ms ({row16['bound_by']}), "
        f"max |kernel - plain| {err16:.3e}")
    del v16
    torch.cuda.empty_cache()
    # K7
    be, n_rows, cfg = moe["be"], moe["n_rows"], moe["cfg"]
    times["grouped_matmul"] = {}
    for (proj, dt), (x, w) in moe["ins"].items():
        label = f"{cfg.name} {n_rows} rows {proj} {DT_NAME[dt]}"
        r = {"ms": time_ms(lambda: km.ops.expert_matmul(x, w, be)),
             "plain_ms": time_ms(lambda: km.gm.grouped_matmul_plain(x, w, be)),
             "variant": km.gm.variant(x.dtype, w.dtype)}
        # x, the weights of the experts that own a block and y, each once
        item = x.element_size()
        t_bytes = ((x.numel() + moe["used"] * w[0].numel() + n_rows * w.shape[2]) * item
                   / HBM_BYTES_PER_S * 1e3)
        flops = 2 * n_rows * x.shape[1] * w.shape[2]
        peak = F32_FLOPS_PER_S if dt == torch.float32 else BF16_FLOPS_PER_S
        t_ops = flops / peak * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        wg = w[be.long()]  # the yardstick's gather, outside the timing
        xb = x.view(-1, 128, x.shape[1])
        r["library_ms"] = time_ms(lambda: torch.bmm(xb, wg))
        del wg
        torch.cuda.empty_cache()
        times["grouped_matmul"][label] = r
        log(f"   K7 {label}: variant {r['variant']}, {r['ms']:.3f} ms ({flops / r['ms'] / 1e9:.1f}"
            f" TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of the bound), plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), torch.bmm over "
            f"w[block_expert] {r['library_ms']:.3f} ms")
    # K8
    times["flash_attention"] = {}
    t = attn["t"]
    for label, cfg, kw, dt, sdpa in attention_shapes(rt):
        q, k, v = attn["ins"][label]
        r = {"ms": time_ms(lambda: km.ops.attention(q, k, v, **kw)),
             "plain_ms": time_ms(lambda: km.fa.flash_attention_plain(q, k, v, **kw))}
        flops = 4 * q.shape[0] * q.shape[2] * live_pairs(t, kw["causal"], kw.get("window"))
        peak = BF16_FLOPS_PER_S if dt == torch.bfloat16 else F32_FLOPS_PER_S
        t_ops = flops / peak * 1e3
        t_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() / HBM_BYTES_PER_S * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        if sdpa:
            r["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, enable_gqa=True))
            lib_s = f"{r['library_ms']:.3f} ms (scaled_dot_product_attention, enable_gqa)"
        else:
            r["library_ms"] = None
            lib_s = "null: scaled_dot_product_attention has no softcap"
        times["flash_attention"][label] = r
        log(f"   K8 {label}: variant {km.fa.variant(dt, q.shape[2])}, {r['ms']:.3f} ms "
            f"({flops / r['ms'] / 1e9:.1f} TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of the bound), "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"library {lib_s}")
    return times


# ---------------------------------------------------------------------------
# Phase 14: the selection and robustness layer on the card (core.autotune,
# runtime/, obs/): measured picks, fitted thresholds, the degradation ladder,
# validation and tracing, through the entry points
# ---------------------------------------------------------------------------

REPLAY_KERNEL = {"pallas": "segsum_reuse", "pallas_lp": "lp_reuse"}


def phase_tune_measure_replay(rt, km, a, p, out: dict) -> None:
    """(a) spgemm(tune="measure") at multigrid A*P: one sweep of the replay
    candidates, the winner dispatched; the same structure again comes from
    the plan-cache entry; an executor in measure mode hits the bucket."""
    tel, tune = rt.telemetry, rt.autotune
    tune.reset_tuner()
    tel.reset_all()
    km.seg.LAUNCHES = km.lp.LAUNCHES = 0
    cache = rt.PlanCache()
    res = rt.spgemm(a, p, method="sparse", tune="measure", plan_cache=cache)
    torch.cuda.synchronize()
    winner = res.stats["replay_backend"]
    counts = dict(tel.TUNE_COUNTS)
    launches = {"segsum_reuse": km.seg.LAUNCHES, "lp_reuse": km.lp.LAUNCHES}
    log(f"   spgemm(tune='measure') A*P: winner {winner}, TUNE_COUNTS {counts}, launches "
        f"{launches} (the sweep: one warm-up and 3 timed runs a candidate, then the winner)")
    require(counts == {"micro_bench": 1}, f"TUNE_COUNTS {counts}")
    require(winner in REPLAY_KERNEL, f"measured replay winner {winner}: not a kernel")
    require(res.stats["kernel_source"] == "measured", f"stats {res.stats['kernel_source']}")
    win_k = REPLAY_KERNEL.get(winner, winner)
    require(all(n == (5 if k == win_k else 4) for k, n in launches.items()),
            f"launches {launches}: each kernel's sweep runs 4, the winner's dispatch 1 more")
    check_fallbacks(rt, "measured spgemm")
    again = rt.spgemm(a, p, method="sparse", tune="measure", plan_cache=cache)
    torch.cuda.synchronize()
    counts = dict(tel.TUNE_COUNTS)
    require(counts == {"micro_bench": 1, "plan_meta_hit": 1}, f"TUNE_COUNTS {counts}")
    now = {"segsum_reuse": km.seg.LAUNCHES, "lp_reuse": km.lp.LAUNCHES}
    require(again.stats["replay_backend"] == winner
            and all(now[k] == n + (k == win_k) for k, n in launches.items()),
            f"launches {now}: the plan-cache winner must launch its kernel once")
    ex = rt.ReuseExecutor.from_matrices(a, p, plan_cache=cache, tune="measure")
    got = ex.apply(a.values, p.values)
    torch.cuda.synchronize()
    counts = dict(tel.TUNE_COUNTS)
    require(counts == {"micro_bench": 1, "plan_meta_hit": 1, "bucket_hit": 1},
            f"TUNE_COUNTS {counts}")
    require(ex.backend == winner and ex.kernel_source == "measured",
            f"executor {ex.backend} ({ex.kernel_source})")
    pl = ex.plan
    want = km.seg.segsum_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids, a.values,
                                     p.values, ex.nnz_cap)
    scale = km.seg.segsum_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids, a.values.abs(),
                                      p.values.abs(), ex.nnz_cap)
    err = tolerance_check("measured executor replay", got, want, scale, F32_TOL)
    err = max(err, tolerance_check("measured spgemm", res.c.values, want, scale, F32_TOL))
    # each candidate's time (µs; the pick's protocol, run again for the log),
    # beside the plain replay's, which is no candidate on the card
    tel.FALLBACK_COUNTS.clear()
    cands = rt.replay_candidates(pl, a.values, p.values)
    require(sorted(cands) == sorted(REPLAY_KERNEL), f"replay candidates {sorted(cands)}")
    cands["plain (yardstick)"] = lambda: rt.numeric_reuse(pl, a.values, p.values)
    _, times = tune.measure_candidates(cands)
    check_fallbacks(rt, "replay candidates' times")
    log(f"   executor(tune='measure'): bucket_hit, {winner}; |replay - plain| {err:.3e}; "
        f"candidates (µs, a second sweep for the log): "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    out.update(replay_winner=winner, replay_times_us=times, executor=ex)


def phase_tune_measure_numeric(rt, km, shapes: dict, out: dict) -> None:
    """(b) numeric_values(tune="measure") at each shape: the candidates
    "dense_acc" and "flat_lp" timed on the real operands, one output alive
    at a time ("xla", the plain version, is a candidate on the CPU only,
    and is timed here beside them for the log); the winner is a kernel; C
    against scipy."""
    tel, tune = rt.telemetry, rt.autotune
    out["numeric"] = {}
    for label, (a, b, c_idx, c_nnz, ref, scale) in shapes.items():
        tune.reset_tuner()
        tel.reset_all()
        reset_launches(km)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        vals = km.ops.numeric_values(a, b, c_idx, c_nnz, tune="measure")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        picks, counts = dict(km.ops.KERNEL_COUNTS), dict(tel.TUNE_COUNTS)
        out_gib = vals.numel() * vals.element_size() / 2**30
        log(f"   {label}: numeric_values(tune='measure') -> {picks}, TUNE_COUNTS {counts}; "
            f"peak above the operands {peak / 2**30:.3f} GiB (one output "
            f"{out_gib:.3f} GiB)")
        require(counts == {"micro_bench": 1}, f"TUNE_COUNTS {counts}")
        winner = next(iter(picks))
        require(len(picks) == 1 and winner in ("dense_acc", "flat_lp"), f"picks {picks}")
        check_fallbacks(rt, f"{label} measured numeric phase")
        check_against_scipy(f"{label} measured ({winner})",
                            ell_csr(rt, c_nnz, c_idx, vals, (a.shape[0], b.shape[1])),
                            ref, scale)
        del vals
        tel.FALLBACK_COUNTS.clear()
        _, times = tune.measure_candidates({
            name: (lambda n=name: km.ops.numeric_values(a, b, c_idx, c_nnz, kernel=n,
                                                        on_kernel_failure="raise"))
            for name in ("xla", "dense_acc", "flat_lp")})
        check_fallbacks(rt, f"{label} numeric candidates' times")
        log(f"   {label}: candidates and the plain version 'xla' (µs, a second sweep for the log): "
            + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
        out["numeric"][label] = {"winner": winner, "times_us": times,
                                 "peak_gib": peak / 2**30}
        torch.cuda.empty_cache()


def phase_tune_fit(rt, ops_times: dict, arf: dict, out: dict) -> None:
    """(c) fit_thresholds on phase 9's K4 (dense_acc) and K3 (lp_hash) times
    at both shapes, stamped with this card; the fitted picks' total is no
    more than the static rule's on those points."""
    tune = rt.autotune
    tune.reset_tuner()
    dev_name = torch.cuda.get_device_name(0)
    rows, points = [], []
    for label, times in ops_times.items():
        regime = re.sub(r"[^a-z0-9]+", "_", label.lower()).strip("_")
        t_dense, t_lp = times["spgemm_numeric"]["ms"] * 1e3, times["spgemm_lp"]["ms"] * 1e3
        points.append((arf[label], t_dense, t_lp))
        for arm, us in (("dense_acc", t_dense), ("lp_hash", t_lp)):
            rows.append({"name": f"accumulators/{regime}/{arm}", "us_per_call": us,
                         "backend": "cuda", "platform": dev_name,
                         "derived": {"avg_row_flops": arf[label]}})
    table = tune.fit_thresholds(rows, source="chip_smoke.py phase 9")
    tune.set_tuned_thresholds(table)
    cutoff, source = tune.avg_row_flops_cutoff(torch.device("cuda"))
    require(source == "fitted", f"the fitted table does not cover {tune.backend_key('cuda')}")
    fitted = sum(td if x < cutoff else tl for x, td, tl in points)
    static = sum(td if x < 256 else tl for x, td, tl in points)
    log(f"   fitted table (JSON): {json.dumps(table.to_json())}")
    log(f"   fitted avg-row-flops cutoff {cutoff} for {tune.backend_key('cuda')} from "
        f"{len(points)} points (avg row flops, K4 µs, K3 µs): {points}; fitted picks "
        f"{fitted:.1f} µs against the static rule's {static:.1f} µs")
    require(fitted <= static + 1e-9, "the fitted picks are slower than the static rule's")
    tune.set_tuned_thresholds(None)
    require(tune.avg_row_flops_cutoff(torch.device("cuda")) == (256.0, "static"),
            "the table did not deactivate")
    out.update(fit=table.to_json(), cutoff=cutoff, fitted_us=fitted, static_us=static)


LADDER_RUNGS = {"pallas": "segsum_reuse", "pallas_lp": "lp_reuse",
                "flat_lp": "spgemm_lp", "dense_acc": "spgemm_numeric"}


def phase_ladder(rt, km, a, p, c_idx, c_nnz) -> None:
    """(d) each kernel failpoint armed in turn: on the card the next rung
    is the other kernel (K1 and K2, K3 and K4), never the plain version;
    values within F32_TOL of that kernel run directly, exactly one
    ``fault:<k>-><other>``, one recorder "fallback" event, and the failed
    kernel never launched; "raise" gives KernelFallbackError; a NaN in B
    under nan_guard is rerun through the other kernel and flagged as
    data."""
    tel, faults, tune = rt.telemetry, rt.faults, rt.autotune
    tune.reset_tuner()
    plan_ex = {b: rt.ReuseExecutor.from_matrices(a, p, backend=b) for b in ("pallas", "pallas_lp")}
    pl = plan_ex["pallas"].plan
    replay_scale = km.seg.segsum_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids,
                                             a.values.abs(), p.values.abs(), pl.indices.shape[0])
    numeric_scale = km.ops.numeric_values(with_values(a, a.values.abs()),
                                          with_values(p, p.values.abs()), c_idx, c_nnz,
                                          kernel="xla")
    cases = [  # (site, next rung, call, the next rung run directly, scale)
        ("pallas", "pallas_lp", lambda: plan_ex["pallas"].apply(a.values, p.values),
         lambda: plan_ex["pallas_lp"].apply(a.values, p.values), replay_scale),
        ("pallas_lp", "pallas", lambda: plan_ex["pallas_lp"].apply(a.values, p.values),
         lambda: plan_ex["pallas"].apply(a.values, p.values), replay_scale),
        ("flat_lp", "dense_acc", lambda: km.ops.numeric_values(a, p, c_idx, c_nnz, kernel="flat_lp"),
         lambda: km.ops.numeric_values(a, p, c_idx, c_nnz, kernel="dense_acc"), numeric_scale),
        ("dense_acc", "flat_lp", lambda: km.ops.numeric_values(a, p, c_idx, c_nnz),
         lambda: km.ops.numeric_values(a, p, c_idx, c_nnz, kernel="flat_lp"), numeric_scale),
    ]
    for site, nxt, call, direct, scale in cases:
        want = direct()
        tel.reset_all()
        rt.recorder.reset_recorder()
        reset_launches(km)
        km.seg.LAUNCHES = km.lp.LAUNCHES = 0
        with faults.failpoint(f"kernel:{site}"):
            got = call()
        torch.cuda.synchronize()
        fb, launches = dict(tel.FALLBACK_COUNTS), read_launches(km)
        require(fb == {f"fault:{site}->{nxt}": 1}, f"kernel:{site}: FALLBACK_COUNTS {fb}")
        events = rt.recorder.default_recorder().events()
        require(sum(e["event"] == "fallback" for e in events) == 1,
                f"kernel:{site}: recorder events {events}")
        require(launches[LADDER_RUNGS[site]] == 0,
                f"kernel:{site}: the failed kernel launched {launches}")
        require(launches[LADDER_RUNGS[nxt]] > 0, f"kernel:{site}: {nxt} never launched")
        err = tolerance_check(f"kernel:{site} -> {nxt}", got, want, scale, F32_TOL)
        log(f"   kernel:{site} armed: {fb}, one recorder fallback event, 0 launches of "
            f"{LADDER_RUNGS[site]}; against {nxt} run directly: max |diff| {err:.3e}")
        del got, want
    strict = rt.ReuseExecutor(pl, backend="pallas", on_kernel_failure="raise")
    for sites, policy, call in (
            (("dense_acc",), "raise",
             lambda: km.ops.numeric_values(a, p, c_idx, c_nnz, on_kernel_failure="raise")),
            (("pallas",), "raise", lambda: strict.apply(a.values, p.values)),
            # both numeric kernels failing exhausts the card's ladder
            (("dense_acc", "flat_lp"), "fallback",
             lambda: km.ops.numeric_values(a, p, c_idx, c_nnz))):
        tel.reset_all()
        try:
            with contextlib.ExitStack() as armed:
                for site in sites:
                    armed.enter_context(faults.failpoint(f"kernel:{site}"))
                call()
        except rt.KernelFallbackError as e:
            log(f"   {', '.join(sites)} armed, on_kernel_failure={policy!r}: "
                f"KernelFallbackError ({e}); FALLBACK_COUNTS {dict(tel.FALLBACK_COUNTS)}")
        else:
            require(False, f"{sites} armed, on_kernel_failure={policy!r}: no KernelFallbackError")
    tel.reset_all()
    reset_launches(km)
    km.seg.LAUNCHES = km.lp.LAUNCHES = 0
    bad_p = p.values.clone()
    bad_p[0] = float("nan")
    guard = rt.ReuseExecutor(pl, backend="pallas", nan_guard=True)
    guard.apply(a.values, bad_p)
    fb, launches = dict(tel.FALLBACK_COUNTS), read_launches(km)
    require(fb == {"nan_guard:rerun": 1, "nan_guard:data": 1}, f"nan_guard: {fb}")
    require(launches["segsum_reuse"] == 1 and launches["lp_reuse"] == 1,
            f"nan_guard: the rerun is not the other kernel: {launches}")
    log(f"   NaN in P's values under nan_guard: {fb}, rerun through lp_reuse, events "
        f"{guard.nan_events}")


def phase_validation(rt, km, a, p) -> None:
    """(e) every data fault raises its FaultSpec's typed error under
    validate="device" and "host"; validate="off" leaves the counters and
    launches where a plain call leaves them."""
    faults = rt.faults
    for spec in faults.data_faults():
        for seed in (0, 1):
            bad = faults.inject_csr(spec.name, a, seed=seed)
            for mode in ("device", "host"):
                try:
                    rt.spgemm(bad, p, method="sparse", plan_cache=False, validate=mode)
                    require(False, f"{spec.name} ({mode}): no error")
                except spec.expects:
                    pass
        log(f"   {spec.name}: {spec.expects.__name__} in 'device' and 'host' (seeds 0, 1)")
    # a spy on check_csr (spgemm reads it from its module at each call): "off"
    # must never call it, where "device" and "host" check both operands
    vmod = importlib.import_module("repro_torch.runtime.validate")
    real, calls = vmod.check_csr, []
    vmod.check_csr = lambda *args, **kw: (calls.append(args[1]), real(*args, **kw))[1]
    counts = {}
    try:
        for validate in (None, "off", "device", "host"):
            rt.telemetry.reset_all()
            reset_launches(km)
            calls.clear()
            rt.spgemm(a, p, method="lp", plan_cache=False, validate=validate)
            torch.cuda.synchronize()
            counts[validate] = (rt.telemetry.snapshot(), read_launches(km), list(calls))
    finally:
        vmod.check_csr = real
    require(counts["off"][2] == [], f"validate='off' called check_csr: {counts['off'][2]}")
    require(counts["device"][2] == ["device"] * 2 and counts["host"][2] == ["host"] * 2,
            f"check_csr calls: device {counts['device'][2]}, host {counts['host'][2]}")
    require(counts[None][:2] == counts["off"][:2],
            f"validate='off' changed the counters: {counts[None][:2]} / {counts['off'][:2]}")
    log(f"   validate='off': check_csr called 0 times ('device' and 'host': twice); == a "
        f"plain call: launches {counts['off'][1]}, STAGE_COUNTS {counts['off'][0]['trace']}")


def phase_tracing(rt, km, a, p, ex, root: Path) -> dict:
    """(f) spgemm(trace="on") and a replay in trace_scope("on"): every span
    named in SPAN_NAMES, the Chrome export parses; a replay under "xprof"
    inside torch.profiler shows the spans among its annotations; the host
    time of a traced replay against an untraced one."""
    from torch.profiler import ProfilerActivity, profile

    tr = rt.trace
    tr.reset_tracing()
    rt.spgemm(a, p, method="sparse", trace="on")
    with tr.trace_scope("on"):
        ex.apply(a.values, p.values)
    torch.cuda.synchronize()
    names = [e["name"] for e in tr.events()]
    require(names and set(names) <= tr.SPAN_NAMES, f"spans {names}")
    path = root / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tr.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    require(len(events) == len(names), "the Chrome export lost events")
    log(f"   spans {names}; Chrome export {path.relative_to(root)} ({len(events)} events)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tr.trace_scope("xprof"):
            ex.apply(a.values, p.values)
        torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()}
    require("numeric.dispatch" in keys, "the xprof span is not among the profiler's events")
    log("   trace_scope('xprof'): 'numeric.dispatch' among torch.profiler's user annotations")
    tr.reset_tracing()
    tr.set_tracing("off")
    untraced = wall_ms(lambda: ex.apply(a.values, p.values), reps=7)
    with tr.trace_scope("on"):
        traced = wall_ms(lambda: ex.apply(a.values, p.values), reps=7)
    tr.reset_tracing()
    log(f"   replay ({ex.backend}) host time, median of 7: untraced {untraced:.4f} ms, traced "
        f"{traced:.4f} ms ({(traced / untraced - 1) * 100:+.1f}%)")
    return {"untraced_ms": untraced, "traced_ms": traced}


def phase_tune_ladder(rt, km, seed: int, ops_times: dict, root: Path, grid=2048,
                      small_grid=512, rmat_scale=16, dev="cuda") -> dict:
    """Phase 14 (a)-(f) at full data size: phase 3's galerkin_triple(2048,
    2048, 4) A*P, phase 4's rmat_csr(16, 8) A*A and phase 7's 512^2 A*P."""
    out: dict = {}
    g = torch.Generator(device=dev).manual_seed(seed + 60)
    _, a, p = rt.galerkin_triple(grid, grid, agg_size=4, device=dev)
    a = with_values(a, torch.randn(a.nnz_cap, generator=g, device=dev))
    phase_tune_measure_replay(rt, km, a, p, out)
    ex = out.pop("executor")
    # the numeric shapes: RMAT A*A and the small multigrid A*P, with C's
    # structure from the sort path (ELL) and scipy's float64 product
    rm = rt.rmat_csr(rmat_scale, 8, seed=0, device=dev)
    _, sa, sp_ = rt.galerkin_triple(small_grid, small_grid, agg_size=4, device=dev)
    vals = torch.randn(sa.nnz_cap, generator=g, device=dev)
    sa = with_values(sa, torch.where(vals == 0, 1.0, vals))
    shapes, arf = {}, {}
    for label, (x, y) in (("power-law A*A", (rm, rm)),
                          (f"multigrid {small_grid}^2 A*P", (sa, sp_))):
        c = rt.spgemm(x, y, method="sparse", plan_cache=False).c
        ell = rt.csr_to_ell(c)
        del c
        xs, ys = to_scipy(x), to_scipy(y)
        shapes[label] = (x, y, ell.indices, ell.row_nnz, xs @ ys, abs(xs) @ abs(ys))
        arf[label] = int(rt.flops_stats(x, y.row_nnz())[0]) / x.shape[0]
    phase_tune_measure_numeric(rt, km, shapes, out)
    phase_tune_fit(rt, ops_times, {"power-law A*A": arf["power-law A*A"],
                                   "multigrid 512^2 A*P": arf[f"multigrid {small_grid}^2 A*P"]},
                   out)
    label = f"multigrid {small_grid}^2 A*P"
    _, _, c_idx, c_nnz, _, _ = shapes.pop(label)
    shapes.clear()
    torch.cuda.empty_cache()
    phase_ladder(rt, km, sa, sp_, c_idx, c_nnz)
    phase_validation(rt, km, sa, sp_)
    out["trace"] = phase_tracing(rt, km, a, p, ex, root)
    rt.autotune.reset_tuner()
    rt.telemetry.reset_all()
    rt.faults.reset_failpoints()
    return out


# ---------------------------------------------------------------------------
# Phase 15: the serving tier (serve/) at full data size: SparseService over
# pinned plans, every request served by a replay kernel (K1/K2, single and
# batched), the breaker routing K1 <-> K2, warming and overload
# ---------------------------------------------------------------------------

SERVE_LABELS = ("multigrid A*P", "power-law A*A")


def serve_launches(km) -> dict:
    return {"segsum_reuse": km.seg.LAUNCHES, "lp_reuse": km.lp.LAUNCHES,
            "segsum_reuse_batched": km.seg.BATCHED_LAUNCHES,
            "lp_reuse_batched": km.lp.BATCHED_LAUNCHES}


def reset_serve_counts(rt, km) -> None:
    """Launch counts and every telemetry counter to 0."""
    km.seg.LAUNCHES = km.lp.LAUNCHES = km.seg.BATCHED_LAUNCHES = km.lp.BATCHED_LAUNCHES = 0
    rt.telemetry.reset_all()


def serve_request(structs, label, g):
    """(label, A, B, A's values, B's values): fresh seeded values of A on the
    structure (RMAT A*A squares the one matrix)."""
    a, b = structs[label]
    x = torch.randn(a.nnz_cap, generator=g, device=a.values.device)
    av = with_values(a, x)
    if b is None:
        return label, av, av, x, x
    return label, av, b, x, b.values


def serve_plan(svc, resp):
    """The pinned plan whose structure the response carries."""
    for ex in svc._executors.values():
        if ex.plan.indptr is resp.value.indptr:
            return ex.plan
    require(False, f"request {resp.request_id}: its structure is no pinned plan's")


def check_responses(km, name, svc, sent, resps, backend, group_size) -> float:
    """Every response ok, served by ``backend`` in groups of ``group_size``,
    not degraded, and within F32_TOL of the plain replay of its own values."""
    err = 0.0
    for (label, _, _, x, y), r in zip(sent, resps):
        require(r.ok, f"{name}: request {r.request_id} ({label}): {r.error!r}")
        require((r.backend, r.group_size, r.degraded) == (backend, group_size, False),
                f"{name}: request {r.request_id} served as {r.backend}, group "
                f"{r.group_size}, degraded {r.degraded}")
        pl = serve_plan(svc, r)
        args = (pl.a_slot_s, pl.b_slot_s, pl.seg_ids)
        cap = pl.indices.shape[0]
        want = km.seg.segsum_reuse_plain(*args, x, y, cap)
        scale = km.seg.segsum_reuse_plain(*args, x.abs(), y.abs(), cap)
        err = max(err, tolerance_check(f"{name} request {r.request_id}", r.value.values,
                                       want, scale, F32_TOL))
    return err


def serve_traffic(rt, km, structs, g, name, count, **svc_kw):
    """``count`` requests alternating the structures, then drain(): the
    service, the requests, the responses, the launches and stage-count
    deltas of the run, the host seconds of admission and of the drain, and
    the device memory the queue held."""
    svc = rt.SparseService(**svc_kw)
    sent = [serve_request(structs, SERVE_LABELS[i % 2], g) for i in range(count)]
    torch.cuda.synchronize()
    reset_serve_counts(rt, km)
    stages0 = dict(rt.stage_counts)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    resps = [svc.submit(a, b) for _, a, b, _, _ in sent]
    t1 = time.perf_counter()
    held = torch.cuda.memory_allocated() - mem0
    svc.drain()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = serve_launches(km)
    stages = {k: v - stages0.get(k, 0) for k, v in rt.stage_counts.items()
              if v != stages0.get(k, 0)}
    log(f"   {name}: {count} requests, {svc.counters['group_dispatches']} group dispatches "
        f"in {svc.counters['steps']} steps; launches {launches}; stages {stages}; admission "
        f"{t1 - t0:.3f} s, drain {t2 - t1:.3f} s; the queue held {held / 2**30:.3f} GiB "
        f"({held / count / 2**20:.1f} MiB a request)")
    return svc, sent, resps, launches, stages, (t1 - t0, t2 - t1)


def serve_steady(rt, km, structs, g, backend, cache, out) -> None:
    """(a)/(b) 16 requests alternating the two structures at max_batch 8,
    validate="host": every group batched, one batched launch of the
    backend's kernel a group (none of any other), no plain stage, no
    fault/dtype/nan_guard key; values against the plain replay, one
    response per structure against scipy in float64."""
    kernel = REPLAY_KERNEL[backend]
    name = f"steady load, backend {backend!r}"
    svc, sent, resps, launches, stages, (t_admit, t_drain) = serve_traffic(
        rt, km, structs, g, name, 16, backend=backend, max_batch=8, plan_cache=cache)
    groups = svc.counters["group_dispatches"]
    require(groups == 4, f"{name}: {groups} group dispatches, not 4")
    want = {k: (groups if k == f"{kernel}_batched" else 0) for k in launches}
    require(launches == want, f"{name}: launches {launches}, not {want}")
    for key in ("executor_apply_batched", "numeric_reuse", "executor_apply"):
        require(key not in stages, f"{name}: stage {key} ran {stages.get(key)} times")
    check_fallbacks(rt, name)
    err = check_responses(km, name, svc, sent, resps, backend, 4)
    if backend == "pallas":
        for label in SERVE_LABELS:
            i = SERVE_LABELS.index(label)
            _, a, b, _, _ = sent[i]
            xs, ys = to_scipy(a), to_scipy(b)
            check_against_scipy(f"{name}, request {i} ({label})", resps[i].value, xs @ ys,
                                abs(xs) @ abs(ys))
    lat = svc.latency_percentiles()
    st = svc.stats()
    log(f"   {name}: max |response - plain| {err:.3e}; request latency p50 {lat['p50']:.4f} s, "
        f"p99 {lat['p99']:.4f} s (host clock, admission to completion); step p50 "
        f"{st['step_latency']['p50']:.4f} s; {16 / (t_admit + t_drain):.2f} requests/s "
        f"(admission + drain); plan cache {st['plan_cache']}")
    out[backend] = {"launches": launches[f"{kernel}_batched"], "worst": err,
                    "p50_s": lat["p50"], "p99_s": lat["p99"],
                    "step_p50_s": st["step_latency"]["p50"], "admit_s": t_admit,
                    "drain_s": t_drain, "rps": 16 / (t_admit + t_drain)}
    if backend == "pallas":
        out["log"] = svc.traffic_log


def serve_singletons(rt, km, structs, g, cache, out) -> None:
    """(c) max_batch 1, four requests a structure: each a group of one,
    one single K1 launch each."""
    name = "singleton traffic, backend 'pallas'"
    svc, sent, resps, launches, stages, _ = serve_traffic(
        rt, km, structs, g, name, 8, backend="pallas", max_batch=1, plan_cache=cache)
    want = {k: (8 if k == "segsum_reuse" else 0) for k in launches}
    require(launches == want, f"{name}: launches {launches}, not {want}")
    require("numeric_reuse" not in stages, f"{name}: the plain replay ran")
    check_fallbacks(rt, name)
    err = check_responses(km, name, svc, sent, resps, "pallas", 1)
    log(f"   {name}: max |response - plain| {err:.3e}")
    out["singletons"] = {"launches": launches["segsum_reuse"], "worst": err}


def serve_chaos(rt, km, structs, g, cache, root: Path, out) -> None:
    """(d) multigrid A*P under an armed kernel:pallas, a fake clock and
    breaker_threshold 2, traced: two degraded singletons (fault:pallas->
    pallas_lp each, K1 never launched), the open breaker short-circuits a
    singleton and a batched group to K2, the probe under the failure
    reopens it, the probe after disarming runs K1 and closes it; values
    within F32_TOL of K2 (or K1) run directly; spans say
    fallback="pallas->pallas_lp" and nothing says xla."""
    tel, faults, tr = rt.telemetry, rt.faults, rt.trace
    label = SERVE_LABELS[0]
    clock = FakeClock()
    tr.reset_tracing()
    tr.set_tracing("on")
    svc = rt.SparseService(backend="pallas", max_batch=4, plan_cache=cache, clock=clock,
                           breaker_threshold=2, breaker_cooldown_s=5.0,
                           sleep=lambda _: None)
    reset_serve_counts(rt, km)
    runs = []  # (what, requests, responses, launches after, expected backend)

    def serve(n, what, backend, degraded):
        sent = [serve_request(structs, label, g) for _ in range(n)]
        before = serve_launches(km)
        resps = [svc.submit(a, b) for _, a, b, _, _ in sent]
        svc.step()
        torch.cuda.synchronize()
        after = serve_launches(km)
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for r in resps:
            require(r.ok, f"chaos {what}: {r.error!r}")
            require((r.backend, r.group_size, r.degraded) == (backend, n, degraded),
                    f"chaos {what}: served by {r.backend}, group {r.group_size}, degraded "
                    f"{r.degraded}")
        fb = dict(tel.FALLBACK_COUNTS)
        log(f"   chaos {what}: backend {resps[0].backend}, degraded {degraded}, launches "
            f"{moved}, breaker {svc._breakers['pallas'].state}, FALLBACK_COUNTS {fb}")
        runs.append((what, sent, resps))
        return moved

    with faults.failpoint("kernel:pallas"):
        for i in range(2):
            moved = serve(1, f"singleton {i} (kernel:pallas armed)", "pallas", True)
            require(moved == {"lp_reuse": 1}, f"chaos singleton {i}: launches {moved}")
            require(dict(tel.FALLBACK_COUNTS) == {"fault:pallas->pallas_lp": i + 1},
                    f"chaos: FALLBACK_COUNTS {dict(tel.FALLBACK_COUNTS)}")
        require(svc._breakers["pallas"].state == "open", "the breaker did not open")
        moved = serve(1, "singleton under the open breaker", "pallas_lp", False)
        require(moved == {"lp_reuse": 1}, f"chaos short circuit: launches {moved}")
        moved = serve(3, "batched group under the open breaker", "pallas_lp", False)
        require(moved == {"lp_reuse_batched": 1}, f"chaos batched short circuit: {moved}")
        require(dict(tel.FALLBACK_COUNTS) == {"fault:pallas->pallas_lp": 2},
                "an open breaker added a fault key")
        clock.advance(5.0)
        moved = serve(1, "probe under the failure", "pallas", True)
        require(moved == {"lp_reuse": 1}, f"chaos failed probe: launches {moved}")
        require(svc._breakers["pallas"].state == "open", "the failed probe did not reopen")
    clock.advance(5.0)
    moved = serve(1, "probe after disarming", "pallas", False)
    require(moved == {"segsum_reuse": 1}, f"chaos closing probe: launches {moved}")
    require(svc._breakers["pallas"].state == "closed", "the probe did not close the breaker")
    bc = dict(tel.BREAKER_COUNTS)
    require(bc.get("pallas:open") == 1 and bc.get("pallas:reopen") == 1
            and bc.get("pallas:close") == 1 and bc.get("pallas:half_open") == 2
            and bc.get("pallas:short_circuit", 0) >= 1, f"BREAKER_COUNTS {bc}")
    require(dict(tel.FALLBACK_COUNTS) == {"fault:pallas->pallas_lp": 3},
            f"FALLBACK_COUNTS {dict(tel.FALLBACK_COUNTS)}")
    # values: each response against the kernel that served it, run directly
    err = 0.0
    direct = {}
    for what, sent, resps in runs:
        for (_, a, b, _, _), r in zip(sent, resps):
            kernel = "pallas" if r.backend == "pallas" and not r.degraded else "pallas_lp"
            pl = serve_plan(svc, r)
            ex = direct.setdefault(kernel, rt.ReuseExecutor(pl, backend=kernel))
            want = ex.apply(a.values, b.values)
            scale = km.seg.segsum_reuse_plain(pl.a_slot_s, pl.b_slot_s, pl.seg_ids,
                                              a.values.abs(), b.values.abs(),
                                              pl.indices.shape[0])
            err = max(err, tolerance_check(f"chaos {what}", r.value.values, want, scale,
                                           F32_TOL))
    events = tr.events()
    path = root / "build" / "chip_smoke_serve_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tr.export_chrome_trace(str(path))
    dispatch = [(e["args"].get("group"), e["args"].get("kernel"), e["args"].get("fallback"))
                for e in events if e["name"] == "serve.dispatch"]
    require([d[2] for d in dispatch] == ["pallas->pallas_lp", "pallas->pallas_lp", None,
                                         None, "pallas->pallas_lp", None],
            f"serve.dispatch spans {dispatch}")
    require("xla" not in json.dumps(events), "a span or attribute says xla")
    tr.reset_tracing()
    log(f"   chaos: BREAKER_COUNTS {bc}; serve.dispatch spans (group, kernel, fallback) "
        f"{dispatch}; no span or attribute says xla; Chrome export "
        f"{path.relative_to(root)} ({len(events)} events); max |response - kernel run "
        f"directly| {err:.3e}")
    out["chaos"] = {"worst": err, "breaker": bc}


class FakeClock:
    """A clock the caller moves (breaker cooldowns, deadlines)."""

    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def serve_warming(rt, km, structs, g, out) -> None:
    """(e) a fresh service and plan cache warmed from (a)'s traffic log:
    built 2; the first request of each structure hits the cache and builds
    no plan; a second warm() reports hits 2."""
    cache = rt.PlanCache(capacity=8, name="serve_warm")
    svc = rt.SparseService(backend="pallas", max_batch=1, plan_cache=cache)
    reset_serve_counts(rt, km)
    stats = svc.warm(out["log"])
    require(stats == {"built": 2, "hits": 0, "failed": 0, "evictions": 0}, f"warm: {stats}")
    misses, built0 = cache.stats()["misses"], rt.stage_counts.get("plan_from_sorted", 0)
    sent = [serve_request(structs, label, g) for label in SERVE_LABELS]
    resps = [svc.submit(a, b) for _, a, b, _, _ in sent]
    svc.drain()
    torch.cuda.synchronize()
    require(all(r.ok for r in resps), "warmed requests failed")
    require(cache.stats()["misses"] == misses, f"warmed requests missed: {cache.stats()}")
    require(rt.stage_counts.get("plan_from_sorted", 0) == built0,
            "a warmed request built a plan")
    again = svc.warm(out["log"])
    require(again["hits"] == 2 and again["built"] == 0, f"second warm: {again}")
    log(f"   warming from (a)'s log: {stats}; the first requests hit (misses stay "
        f"{misses}, no plan_from_sorted); second warm {again}; EVICT_COUNTS "
        f"{dict(rt.telemetry.EVICT_COUNTS)}")
    out["warm"] = (stats, again)


def accounted(name, svc) -> dict:
    """submitted == completed + failed + shed: no request dropped silently."""
    c = svc.counters
    shed = c["shed_queue_full"] + c["shed_deadline_infeasible"] + c["shed_deadline_expired"]
    require(c["submitted"] == c["completed"] + c["failed"] + shed,
            f"{name}: counters {c}: a request went unaccounted")
    return c


def serve_overload(rt, km, structs, g) -> None:
    """(f) max_queue 4 and 6 submits: 2 AdmissionRejected; then, on a second
    service, a deadline the set step_hint_s makes infeasible, rejected at
    admission, and a deadline that expires in the queue, DeadlineExceeded;
    submitted == completed + failed + shed on both. On RMAT-16 A*A, whose
    admission is cheap."""
    label = SERVE_LABELS[1]
    svc = rt.SparseService(backend="pallas", max_queue=4, max_batch=8)
    reset_serve_counts(rt, km)
    reqs = [serve_request(structs, label, g) for _ in range(6)]
    first = [svc.submit(a, b) for _, a, b, _, _ in reqs]
    kinds = [type(r.error).__name__ if r.done else "queued" for r in first]
    require(kinds == ["queued"] * 4 + ["AdmissionRejected"] * 2, f"queue full: {kinds}")
    svc.drain()
    torch.cuda.synchronize()
    require(all(r.ok and r.group_size == 4 for r in first[:4]), "admitted requests failed")
    moved = {k: v for k, v in serve_launches(km).items() if v}
    require(moved == {"segsum_reuse_batched": 1}, f"queue full: launches {moved}")
    full = accounted("queue full", svc)
    clock = FakeClock()
    svc = rt.SparseService(backend="pallas", max_batch=8, clock=clock)
    svc.step_hint_s = 1.0  # one tick estimated at 1 s
    _, a, b, _, _ = reqs[0]
    infeasible = svc.submit(a, b, deadline_s=0.5)
    require(isinstance(infeasible.error, rt.AdmissionRejected)
            and "infeasible" in str(infeasible.error), f"infeasible: {infeasible.error!r}")
    expiring = svc.submit(a, b, deadline_s=5.0)
    require(not expiring.done, f"the expiring request was not admitted: {expiring.error!r}")
    clock.advance(6.0)
    svc.step()
    require(isinstance(expiring.error, rt.DeadlineExceeded), f"expired: {expiring.error!r}")
    late = accounted("deadlines", svc)
    log(f"   overload: max_queue 4, 6 submits: {kinds}, counters {full}; infeasible "
        f"deadline -> {type(infeasible.error).__name__}; expired in the queue -> "
        f"{type(expiring.error).__name__}; counters {late}")


def serve_times(rt, km, structs, g, cache, out, smi) -> None:
    """(g) the admission split on one request a structure (check_csr host,
    prepare_sparse_inputs, structure_key; host clock, median of 3) and the
    batched launches' device times at batch 4 and 8 (CUDA events, median of
    7) beside batch x the single launch and the plain _replay_batched at
    batch 4, per structure and kernel."""
    from repro_torch.core.plan_cache import structure_key
    from repro_torch.core.spgemm import prepare_sparse_inputs

    times = {}
    for label in SERVE_LABELS:
        _, a, b, x, y = serve_request(structs, label, g)
        split = {
            "check_csr host (A, B)": wall_ms(lambda: (rt.check_csr(a, "host", name="A"),
                                                      rt.check_csr(b, "host", name="B")),
                                             reps=3),
            "prepare_sparse_inputs": wall_ms(lambda: prepare_sparse_inputs(a, b, "pow2"),
                                             reps=3),
        }
        pa, pb, _, _, fm_cap = prepare_sparse_inputs(a, b, "pow2")
        split["structure_key"] = wall_ms(lambda: structure_key(pa, pb, fm_cap, "pow2"), reps=3)
        log(f"   {label}: admission split (ms, host clock, median of 3; {smi}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        plan = rt.spgemm(a, b, method="sparse", plan_cache=cache).plan
        args = (plan.a_slot_s, plan.b_slot_s, plan.seg_ids)
        cap = plan.indices.shape[0]
        fm_live = int((plan.seg_ids < cap).sum())
        row = {"admission_ms": split}
        for kernel, mod in (("segsum_reuse", km.seg), ("lp_reuse", km.lp)):
            single = getattr(mod, f"{kernel}_arrays")
            batched = getattr(mod, f"{kernel}_batched_arrays")
            t_single = time_ms(lambda: single(*args, x, y, nnz_cap=cap))
            k_row = {"single_ms": t_single}
            for batch in (4, 8):
                xs = torch.randn(batch, x.shape[0], generator=g, device=x.device)
                ys = xs if y is x else y
                k_row[f"batch{batch}_ms"] = time_ms(lambda: batched(*args, xs, ys, nnz_cap=cap))
                nb = 0 if y is x else y.shape[0]
                k_row[f"batch{batch}_bound_ms"] = (
                    12 * fm_live + batch * 4 * (x.shape[0] + nb + cap)) / HBM_BYTES_PER_S * 1e3
                if batch == 4:
                    k_row["plain_batch4_ms"] = time_ms(
                        lambda: rt.replay_batched(plan, xs, ys), reps=3)
                del xs, ys
                torch.cuda.empty_cache()
            row[kernel] = k_row
            log(f"   {label} {kernel}: batched launch batch 4 {k_row['batch4_ms']:.3f} ms, "
                f"batch 8 {k_row['batch8_ms']:.3f} ms (bound, plan read once: "
                f"{k_row['batch4_bound_ms']:.3f} / {k_row['batch8_bound_ms']:.3f} ms); "
                f"4 x single {4 * t_single:.3f} ms, 8 x single {8 * t_single:.3f} ms; plain "
                f"_replay_batched batch 4 {k_row['plain_batch4_ms']:.3f} ms (CUDA events; "
                f"{smi})")
        times[label] = row
        del plan
        torch.cuda.empty_cache()
    out["times"] = times


def phase_serve(rt, km, seed: int, root: Path, smi: str, grid=2048, rmat_scale=16,
                dev="cuda") -> dict:
    """Phase 15 (a)-(g) on phase 3's multigrid A*P and phase 4's RMAT-16 A*A."""
    out: dict = {}
    g = torch.Generator(device=dev).manual_seed(seed + 70)
    _, a, p = rt.galerkin_triple(grid, grid, agg_size=4, device=dev)
    rm = rt.rmat_csr(rmat_scale, 8, seed=0, device=dev)
    structs = {SERVE_LABELS[0]: (a, p), SERVE_LABELS[1]: (rm, None)}
    log(f"   structures: {SERVE_LABELS[0]} A {a.shape} nnz {int(a.indptr[-1])}, P "
        f"{p.shape}; {SERVE_LABELS[1]} {rm.shape} nnz {int(rm.indptr[-1])}")
    cache = rt.PlanCache(capacity=8, name="serve_smoke")
    launches = {k: 0 for k in serve_launches(km)}
    # each run sets the counts to 0 first; its launches are added up after it
    for run in (lambda: serve_steady(rt, km, structs, g, "pallas", cache, out),
                lambda: serve_steady(rt, km, structs, g, "pallas_lp", cache, out),
                lambda: serve_singletons(rt, km, structs, g, cache, out),
                lambda: serve_chaos(rt, km, structs, g, cache, root, out),
                lambda: serve_warming(rt, km, structs, g, out),
                lambda: serve_overload(rt, km, structs, g)):
        run()
        launches = {k: v + serve_launches(km)[k] for k, v in launches.items()}
    log(f"   launches of phase 15's runs (a)-(f): {launches}")
    out["launches"] = launches
    del out["log"]
    torch.cuda.empty_cache()
    serve_times(rt, km, structs, g, cache, out, smi)
    rt.telemetry.reset_all()
    rt.faults.reset_failpoints()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build + kernel vs plain)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of each path after phase 5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as rt_core
    import repro_torch.sparse as rt_sparse
    import repro_torch.configs as rt_configs
    import repro_torch.kernels as kernels_api
    from repro_torch.core import autotune, executor, telemetry
    from repro_torch.core.spgemm import STAGE_COUNTS
    from repro_torch.serve import SparseService
    from repro_torch.kernels import _build, ops, segsum_reuse, spgemm_lp
    from repro_torch.kernels import spgemm_numeric, spgemm_symbolic
    from repro_torch.obs import recorder, trace
    from repro_torch.runtime import faults
    from repro_torch.runtime.validate import (AdmissionRejected, DeadlineExceeded,
                                              KernelFallbackError, check_csr)

    class rt:  # the port's public entry points used below
        spgemm = staticmethod(rt_core.spgemm)
        ReuseExecutor = rt_core.ReuseExecutor
        galerkin_triple = staticmethod(rt_sparse.galerkin_triple)
        rmat_csr = staticmethod(rt_sparse.rmat_csr)
        CSR = rt_sparse.CSR
        csr_to_ell = staticmethod(rt_sparse.csr_to_ell)
        bitmask_rows = staticmethod(rt_core.bitmask_rows)
        flops_stats = staticmethod(rt_core.flops_stats)
        get_config = staticmethod(rt_configs.get_config)
        PlanCache = rt_core.PlanCache
        numeric_reuse = staticmethod(rt_core.numeric_reuse)
        replay_candidates = staticmethod(executor.replay_candidates)

    # the selection and robustness layer: counters, tuner, faults, obs
    rt.telemetry, rt.autotune, rt.faults, rt.recorder, rt.trace = (
        telemetry, autotune, faults, recorder, trace)
    rt.KernelFallbackError = KernelFallbackError
    # the serving tier
    rt.SparseService, rt.stage_counts = SparseService, STAGE_COUNTS
    rt.AdmissionRejected, rt.DeadlineExceeded = AdmissionRejected, DeadlineExceeded
    rt.check_csr, rt.replay_batched = staticmethod(check_csr), staticmethod(executor._replay_batched)

    class km:  # the kernels' modules: wrappers, plain versions, launch counts
        seg, lp, sym, num = segsum_reuse, spgemm_lp, spgemm_symbolic, spgemm_numeric

    km.ops = ops
    km.telemetry = telemetry
    km.bsr_api = kernels_api  # plan_bsr_numeric, bsr_spgemm_numeric
    # the modules (the package exports functions of the same names)
    km.bsr, km.gm, km.fa = (importlib.import_module(f"repro_torch.kernels.{name}")
                            for name in NEW_KERNELS)
    seg_mod, lp_mod = km.seg, km.lp
    # f32 products in full f32: the plain versions' matmuls must not round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("phase 1: device and build"):
        smi = phase_device(_build)
        log(f"   allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
            f"{torch.backends.cudnn.allow_tf32} (f32 products in full f32)")
    with Phase("phase 2: kernels vs plain on synthetic plans and ELL operands"):
        synth_worst = phase_kernels_vs_plain(seg_mod, lp_mod, args.seed)
        synth_worst.update(phase_batched_vs_plain(seg_mod, lp_mod, executor, args.seed))
        synth_worst.update(phase_ell_kernels_vs_plain(rt, km, args.seed))
        synth_worst.update(phase_new_kernels_vs_plain(km, args.seed))
    if args.kernels_only:
        log("kernels-only run: phases 1-2 passed; no result line")
        return 0
    mg, pw = {}, {}
    with Phase("phase 3: multigrid Reuse R*A*P through K1"):
        phase_multigrid(rt, seg_mod, lp_mod, args.seed, mg)
    with Phase("phase 4: power-law A*A through K2"):
        phase_powerlaw(rt, seg_mod, lp_mod, args.seed, pw)
    with Phase("phase 5: times"):
        times = phase_times(rt, seg_mod, lp_mod, args.seed, mg, pw)
    if args.profile:
        with Phase("phase 5b: where the time goes (torch.profiler)"):
            phase_profile(rt, mg, pw)
    mg_launches, mg_worst = mg["multigrid_launches"], mg["multigrid_worst"]
    mg.clear()
    for key in ("rmat_res", "rmat_ex"):
        del pw[key]
    torch.cuda.empty_cache()
    ops_pw, ops_mg = {}, {}
    with Phase("phase 6: power-law A*A through kernels/ops (K5, K3, K4)"):
        phase_ops_powerlaw(rt, km, args.seed, pw, ops_pw)
    with Phase("phase 7: multigrid A*P through kernels/ops (K5, K4, K3)"):
        phase_ops_multigrid(rt, km, args.seed, ops_mg)
    with Phase("phase 8: spgemm(method='auto') picks the dense method"):
        phase_dense_method(rt, args.seed)
    with Phase("phase 9: times of K3, K4 and K5"):
        ops_times = phase_ops_times(rt, km, {
            "power-law A*A": (pw["rmat"], pw["rmat"], ops_pw["c_idx"], ops_pw["c_nnz"], 1),
            "multigrid 512^2 A*P": (ops_mg["a"], ops_mg["p"], ops_mg["c_idx"],
                                    ops_mg["c_nnz"], 7)})
    del pw["rmat"], pw["rmat_scipy"], ops_pw["c_idx"], ops_mg["a"], ops_mg["p"], ops_mg["c_idx"]
    torch.cuda.empty_cache()
    bsr, moe, attn = {}, {}, {}
    with Phase("phase 10: block multigrid A*A through plan_bsr_numeric + K6 bsr_spgemm"):
        phase_bsr(rt, km, args.seed, bsr)
    with Phase("phase 11: qwen3-moe-30b-a3b expert matmul through ops.expert_matmul (K7)"):
        phase_moe(rt, km, args.seed, moe)
    with Phase("phase 12: attention at gemma2-9b, llama3.2-1b and qwen3-moe widths through "
               "ops.attention (K8)"):
        phase_attention(rt, km, args.seed, attn)
    with Phase("phase 13: times of K6, K7 and K8"):
        new_times = phase_new_times(rt, km, bsr, moe, attn)
    del bsr["blocks"], bsr["plan"], moe["ins"], attn["ins"]
    torch.cuda.empty_cache()
    with Phase("phase 14: autotune, validation, the ladder and tracing on the card"):
        phase_tune_ladder(rt, km, args.seed, ops_times, Path(__file__).resolve().parent)
    torch.cuda.empty_cache()
    with Phase("phase 15: the serving tier (SparseService) through K1 and K2"):
        serve = phase_serve(rt, km, args.seed, Path(__file__).resolve().parent, smi)

    k1, k2 = times["multigrid AP"], times["power-law A*A"]
    serve_worst = max(serve[k]["worst"] for k in ("pallas", "pallas_lp", "singletons", "chaos"))
    kernels = [
        {"name": "segsum_reuse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segsum_reuse.cu",
         "replaces": "src/repro/kernels/segsum_reuse.py:107",
         "launches": mg_launches["segsum_reuse"],
         "max_abs_err": max(mg_worst, synth_worst["segsum_reuse"],
                            synth_worst["batched_segsum_reuse"], serve_worst),
         "ms": k1["segsum_reuse"], "plain_ms": k1["plain"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None, "shape": "multigrid AP",
         "batched_ms": serve["times"]["multigrid A*P"]["segsum_reuse"]["batch8_ms"],
         "batched_launches": serve["launches"]["segsum_reuse_batched"],
         "batched_shape": "multigrid A*P, batch 8"},
        {"name": "lp_reuse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lp_reuse.cu",
         "replaces": "src/repro/kernels/spgemm_lp.py:302",
         "launches": pw["powerlaw_launches"]["lp_reuse"],
         "max_abs_err": max(pw["powerlaw_worst"], synth_worst["lp_reuse"],
                            synth_worst["batched_lp_reuse"], serve_worst),
         "ms": k2["lp_reuse"], "plain_ms": k2["plain"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None, "shape": "power-law A*A",
         "batched_ms": serve["times"]["power-law A*A"]["lp_reuse"]["batch8_ms"],
         "batched_launches": serve["launches"]["lp_reuse_batched"],
         "batched_shape": "power-law A*A, batch 8"},
    ]
    replaces = {"spgemm_lp": "src/repro/kernels/spgemm_lp.py:164",
                "spgemm_numeric": "src/repro/kernels/spgemm_numeric.py:82",
                "spgemm_symbolic": "src/repro/kernels/spgemm_symbolic.py:45"}
    line_shape = {"spgemm_lp": "power-law A*A", "spgemm_numeric": "multigrid 512^2 A*P",
                  "spgemm_symbolic": "power-law A*A"}
    for name in ("spgemm_lp", "spgemm_numeric", "spgemm_symbolic"):
        t = ops_times[line_shape[name]][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaces[name],
            "launches": ops_pw["launches"][name] + ops_mg["launches"][name],
            "max_abs_err": max(synth_worst[name], ops_pw["worst"].get(name, 0.0),
                               ops_mg["worst"].get(name, 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": line_shape[name]})
    new_replaces = {"bsr_spgemm": "src/repro/kernels/bsr_spgemm.py:103",
                    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:47",
                    "flash_attention": "src/repro/kernels/flash_attention.py:75"}
    new_shape = {"bsr_spgemm": "block multigrid 512^2 bs 8 f32",
                 "grouped_matmul": f"{moe['cfg'].name} {moe['n_rows']} rows x@w1 bf16",
                 "flash_attention": "llama3.2-1b bf16"}
    path_runs = {"bsr_spgemm": bsr, "grouped_matmul": moe, "flash_attention": attn}
    for name in NEW_KERNELS:
        t = new_times[name][new_shape[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": new_replaces[name],
            "launches": path_runs[name]["launches"][name],
            "max_abs_err": max(synth_worst[name], path_runs[name]["worst"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": new_shape[name]})
    for k in kernels:
        k["max_err"] = k["max_abs_err"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it end to end.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --kernels-only   # phases 1-2b: build + kernels vs plain
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
 2b. plan_columns (C's column indices of a fresh plan) bit for bit against
     its plain version, the scatter-max, on the fresh path's sorted
     expansions of RMAT graph 0's A*A (rmat_csr(15, 16, seed 0)) and the
     multigrid A*P of phase 3, each at nnz_cap = nnz, at the pow2 bucket
     above it (a zero tail) and at nnz // 2 (ids dropped), and as views at
     offsets 1-3 (misaligned: the scalar build); and on A times an all-zero
     B (fm 0); its time at RMAT graph 0 beside the plain version's, a plain
     search-and-gather's (no atomics) and the bound;
  3. multigrid Reuse, the paper's R*A*P: galerkin_triple(2048, 2048, 4).
     Fresh AP = A*P and RAP = R*AP through spgemm(method="sparse"), whose
     numeric phase is kernel K1, held against scipy (structure exactly,
     values in float64), then five time steps replayed through
     ReuseExecutor(backend="pallas") — K1 again — each held against the
     plain version: 16 K1 launches (the four fresh multiplies, the two
     executors' pins, which run spgemm, and the ten replays) and one
     plan_columns launch for each plan built (the plan-cache misses); then two fresh
     A*P multiplies without a plan cache, bitwise equal (K1 adds in a fixed
     order) and within F32_TOL of the plain numeric_reuse; then the default
     backend ("auto"): ReuseExecutor(plan) replays twice through K1,
     bitwise equal, and spgemm_grouped of two multiplies (one batched K1
     launch) and of one (one K1 launch), no plain stage, the default
     replay's time beside the explicit K1 executor's and the plain one's;
  4. power-law A*A: rmat_csr(16, 8). spgemm(method="lp") and three
     ReuseExecutor(backend="pallas_lp") replays — kernel K2 — held against
     the plain version and scipy; the executor's pin is a fresh sparse
     multiply, one K1 launch; then two fresh sparse A*A multiplies, bitwise
     equal, as in phase 3;
  5. times on the card: each kernel and the plain version at the shapes of
     phases 3 and 4 (and the plain numeric_reuse, which a fresh multiply's
     numeric phase was before K1 took it), each kernel's bound at 3.35
     TB/s, a fresh spgemm and a replay end to end, and torch.sparse.mm on
     the same operands as a yardstick for the fresh multiply (the port never
     calls it);
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
     2,048, on x @ w1's output) for each (x, w) pair of MOE_PAIRS (bf16,
     f16 and f32, f32 x bf16, bf16 x f32, bf16 x f16), against the plain
     version, each with its variant and products, padding rows 0;
 12. K8 through ops.attention at T = 8,192: gemma2-9b widths (softcap 50; a
     local layer with its 4,096 window and a global layer; bf16 and f32),
     llama3.2-1b (causal, bf16 and f32) and qwen3-moe-30b-a3b widths
     (causal, bf16), against the plain version;
 13. K6, K7 and K8 timed at those shapes beside their plain versions, bounds
     and one PyTorch call where one computes the same function
     (torch.sparse.mm on the scalar CSR for K6, torch.bmm over w[block_expert]
     for K7 where x and w share a dtype (f32 in full f32), and
     scaled_dot_product_attention for K8 where there is no softcap, f32 at
     llama3.2-1b); K7's bound counts its variant's tensor-core products,
     K8's its variant's (k8_bound: three TF32 products on "tf32");
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
     through K2 ("pallas_lp"); (a') the same with the default backend
     ("auto"): batched K1 only; (c) singletons at max_batch 1, one single K1
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
 16. the sharded SpGEMM (repro_torch.dist) on the single-process mesh, every
     shard on the card: (a) multigrid 2048^2 A*P at S = 8, 3 and 1, both B
     placements: one hash at pin, K1 launched once a live shard per apply
     and no plain stage, C's structure after merge bitwise the single-device
     plan's, values within F32_TOL of the single-device plain and K1
     replays, the replay timed around the whole apply; (b) RMAT-16 A*A at S =
     8 and 1, the same, with each shard's live products and the stacked
     plan's bytes beside the single-device plan's; (c) apply_batched at batch
     4, S = 8: one batched K1 launch a shard, rows within F32_TOL of apply;
     (d) spgemm(mesh=) and distributed_spgemm at 512^2 A*P against the
     single-device spgemm, then a dist-cache hit; (e) the process-group
     backing on NCCL at world size 1 (file:// rendezvous under build/), S = 8
     local shards: (a)'s replay bitwise the single-process one, then
     compressed_psum and an all_gather through NCCL; (f) pipeline_forward at
     4 stages against the serial loop; (g) the pin split, the peak memory of
     each pin and replay, a torch.profiler run of each replicated replay
     (the device's busy time and idle share), K1's launches;
 17. the LM substrate's serving path (repro_torch.models, serve.engine) in
     plain torch, as the reference's models call none of K1-K8 (no kernel
     launches across the phase, checked): (a) llama3.2-1b at its full config
     (16 layers, bf16 params from init_params with its zero leaves drawn
     too): ServeEngine(max_len 1,088).generate of 8 seeded 1,024-token
     prompts, 64 greedy steps; finite logits, each step's argmax the
     engine's token, a second generate the same tokens bit for bit, every
     step's logits against forward over prompt + tokens (max |diff| <=
     0.15, the reference's bound), the prefill handoff against pure decode
     at a 64-token prompt, forward of 1 x 32 on the card against the CPU
     (0.15) and both against the same forward in f32 (the card's relative
     Frobenius error within 1.5x the CPU's); (b) every other architecture at full
     width, depth cut to one pattern repeat plus its tail: decode against
     forward over a prompt plus 8 steps (gemma2-9b 4,160 and
     recurrentgemma-9b 2,112 tokens, past their windows: ring caches; the
     MoE archs at the positions whose forward routing kept every
     assignment, each expert's kept and dropped assignments logged;
     phi-3-vision also forward with its 576 patches), hubert-xlarge forward
     on 1,024 frames; (c) prefill ms and decode ms a step (CUDA events,
     medians), tokens/s, peak memory, each beside its bound, and a
     torch.profiler run of 3 llama decode steps (busy time, idle share, top
     operators);
 18. the LM substrate's training path (repro_torch.train, data, ckpt,
     launch/train.py) in plain torch with autograd (no kernel launches across
     the phase, checked): (a) llama3.2-1b at its full config with f32 params
     (lm_params in f32): 8 steps of make_train_step on SyntheticLMDataset
     (seed 0) batch 0 of 8 x 1,024, repeated, AdamWConfig(lr=1e-3,
     warmup_steps=2): finite losses and grad norms, the last loss below the
     first, opt_state.step 8; num_microbatches=2 against 1 from one fresh
     state (AdamWConfig(): loss rtol 1e-2, first leaf rtol 1e-2 atol 1e-4,
     the reference's bar); one step at 1 x 32 on the card and on the CPU from
     the same params, both against the same step with f32 activations on the
     card (grads and updated params: the card's relative Frobenius distance
     within 1.5x the CPU's); (b) step ms (CUDA events, median of steps 3-8),
     tokens/s, peak memory, the bound (lm_train_bound), the loss and the AdamW
     update timed alone, a torch.profiler run of one step (busy time, idle
     share, top kernels, GEMM ops by input dtype: the bf16 matmuls and the f32
     attention); (c) at llama3.2-1b's width cut to one layer, B = 2, T = 256,
     under deterministic algorithms: 4 steps straight against 2 + save +
     restore into a fresh state + 2, the restored state bitwise what was
     saved, the resumed params and moments bitwise the straight run's, save
     and restore times and bytes (the checkpoint under build/, removed after);
     (d) every other architecture at full width and one pattern repeat plus
     its tail (lm_cut), f32 params: 2
     steps at 2 x 512 (phi-3-vision 1,024 tokens with its 576 patches,
     hubert-xlarge 1,024 frames with make_labels' labels), finite losses and
     grad norms, every leaf moved; (e) python -m repro_torch.launch.train
     --smoke at 8 x 128 in a subprocess to step 20, then to 30: the second run
     resumes from step 20 and ends with "done";
 19. the LM substrate's 2-D data x model mesh (launch/mesh.make_test_mesh,
     DTensor placements from the specs, the MoE's local_map expert path,
     ZeRO-1 moments, the elastic restore) on a (1, 1) mesh over NCCL at world
     size 1 (a file:// rendezvous under build/): the code path at full width,
     no real split (NCCL puts one rank on a card; the 2 x 4 split is held on
     the CPU's gloo ranks); every check against the same call with
     NO_SHARDING from the same params, bitwise or within MESH_RTOL relative
     (which, logged): (a) llama3.2-1b at its full config, f32 params placed by
     param_shardings: forward at 8 x 1,024 (bf16 activations), then 4
     train steps with ZeRO-1 moments (zero1_shardings, placements checked) on
     phase 18's repeated batch against 4 plain steps (losses, grad norms,
     final params); ServeEngine(mesh=) with decode rules, bf16 params: 8 x 64
     prompt tokens, 16 greedy steps, the same tokens as without the mesh;
     (b) qwen3-moe-30b-a3b at full width, one pattern repeat (lm_cut), f32
     params, 2 x 512: forward and one train step through the local_map
     expert path (its calls counted); (c) llama3.2-1b cut to one layer:
     params and ZeRO-1 state after a step, saved from the mesh and restored
     onto NamedShardings of the specs: bitwise, at the asked placements (the
     checkpoint under build/, removed after); (d) the mesh step's ms against
     the plain step's (CUDA events, medians of steps 2-4) and phase 18's, and
     its idle share from one torch.profiler step: DTensor's host cost; (e) no
     kernel launch across the phase (checked);
 20. the dry run (repro_torch.launch: op_cost, roofline, cells, dryrun,
     reanalyze, report), which launches no kernel (checked): (a) op_cost's
     count of phase 18's own program (the llama3.2-1b train step at 8 x
     1,024, f32 params) on meta tensors, no mesh: the bf16 GEMM flops within
     DRYRUN_GEMM_RTOL of lm_train_bound's, the f32 flops at least the
     attention's live pairs', the predicted peak within DRYRUN_PEAK_RTOL of
     phase 18's measured peak, the roofline's time at most phase 18's
     measured step (the ratio logged); (b) python -m
     repro_torch.launch.dryrun in one subprocess a cell of DRYRUN_CELLS,
     side by side, no card visible (a fake group cannot live beside phase
     19's NCCL group), at full width on the 16 x 16 fake mesh: every record
     ok, report.py's roofline table rendering each, each cell's seconds and
     per-rank peak against the card's 80 GiB; (c) reanalyze over (b)'s
     records and op counts: the same roofline columns;
 21. the seven examples (examples/torch_*.py), each main() in-process on
     the card in a fresh directory under build/, removed after: exit 0, the
     reference's lines logged, wall seconds, and the kernels each must
     launch (check_example: quickstart K5 and K4 or K3; accumulator_crossover
     K2 four times and K3 once; multigrid_reuse K1 for its fresh
     multiplies and the default executors' replays, batched K1 for its
     batches; serve_spgemm batched K1, K2 only inside its armed
     kernel:pallas window; dist_multigrid K1 once a live shard a replay;
     serve_lm and train_lm none); train_lm at its defaults (300 steps),
     then to 320, resuming from step 300;
 22. the port's contract linter, ``python -m repro_torch.analysis``, in a
     child process where importing jax or repro raises: no new finding;
     its counts of findings and of inline allows on a line of their own;
 23. one JSON line of the kernels (K1 and K2 with their batched launches'
     times, launches and shape, K1 with its sharded launches); the last
     line is the result.

Phase 2 also holds each batched replay launch (K1, K2) against the
executor's plain _replay_batched at F32_TOL: every edge plan with batch 3,
A shared, B shared, rows as views at offsets 1-3 right after a NaN-filled
tensor of the output's size is freed, and a stack of 1; K1's batched rows
against its single launch bit for bit, and each single launch against a
second one bit for bit, on every plan.
Phase 2 also holds K6, K7 and K8 against their plain versions on synthetic
inputs (K7 in f32, bf16, f16 and six mixed pairs, so both of its variants:
"wgmma" for bf16 x bf16 and f16 x f16, "tf32" at 3, 2 and 1 products for
the others, each named and counted by the library as variant() and
products() say; K8 in f32,
bf16 and f16 at every head dim, so each of its variants: "tf32" for f32 at
D 64-256, "fma" for f32 at D 16 and 32, "mma" for bf16/f16 at D 16 and 32,
"wgmma" at D 64-256). Every K7 output
is held to K7_TOL and to a relative Frobenius bound (K7_FRO), every K8
output to K8_TOL and K8_FRO; where q and k are scaled by 8 under a softcap,
the output without the softcap must fail that check.
Phases 11-13 log the K7 and K8 variant of each shape and, in 13, its share
of the bound. Phase 1 logs ptxas's registers and spills per K7 and K8
instantiation, and fails if K8's "tf32" spills. f32 products on the card
keep allow_tf32 off (checked), so the plain versions' matmuls are full f32.

The launch counters are set to 0 just before phases 3, 4, 6, 7 and 10-12
drive the main path and read just after, and so is FALLBACK_COUNTS: with the
degradation ladder on by default, each of those phases requires that no
fault:* or nan_guard:* key (and no dtype:* key it does not expect) appears;
so does every timed sweep that goes through an entry point (phases 5 and
14), so that no kernel's time is another rung's. Phase 15 sets the counts to
0 before each of its runs (a)-(f) and reads them after; the JSON line's
batched_launches add up its runs. Phase 16 does the same around each counted
replay, timed sweep and fresh multiply; its sharded_launches add them up.
Phase 21 reads every counter before and after each example, sets
FALLBACK_COUNTS to 0 before it, and records the counters as serve_spgemm's
armed window opens and closes.
Any failed check raises, so the script exits
non-zero and prints no result. It needs torch, numpy and scipy; it exits
non-zero when no CUDA card is visible or when the repo's src/ is missing.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib
import importlib.util
import io
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

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the H100's datasheet peaks and the LM paths' bounds: one definition, which
# the dry run's roofline (phase 20) shares
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_FLOPS_PER_S,
    F32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    TF32_FLOPS_PER_S,
    lm_bytes,
    lm_decode_bound,
    lm_prefill_bound,
    lm_train_bound,
    live_pairs,
)

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
                # K8's f32 variant (and its pre-pass) was designed to its
                # register budget: a spill means the budget broke
                require(not fn.startswith(("flash_attention_tf32", "split_kv_tf32"))
                        or "0 bytes spill stores, 0 bytes spill loads" in spills,
                        f"nvcc[{name}]: {fn} spills: {spills}")
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
    if m:  # the name is the shortest suffix <len><name> of the prefix whose length fits
        args = [d or types[t] for d, t in
                re.findall(r"Li(\d+)E|(f|6__half|13__nv_bfloat16)", m.group(2))]
        prefix = m.group(1)
        for i in reversed(range(len(prefix))):
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


def phase_batched_vs_plain(seg_mod, lp_mod, ex_mod, seed: int) -> dict:
    """Each batched launch against the executor's plain ``_replay_batched``
    at F32_TOL: every edge plan of each kernel in each stacking of
    BATCH_STACKS (A shared, B shared, rows as views at offsets 1-3, a stack
    of 1), f32 and bf16 x f32 values, each call right after a NaN-filled
    tensor of the output's size is freed, and phase 2's 1,000,003-product
    plan at batch 3. K1 adds in a fixed order (replay_ends sums a segment's
    carries in tile order), so each of its batched rows must equal its
    single launch on the row's values bit for bit, and the single launch
    must repeat itself bit for bit, on every plan (one segment over many
    tiles included)."""
    kernels = {"segsum_reuse": (seg_mod.segsum_reuse_batched_arrays, seg_mod.segsum_reuse_arrays),
               "lp_reuse": (lp_mod.lp_reuse_batched_arrays, lp_mod.lp_reuse_arrays)}
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    worst = {f"batched_{name}": 0.0 for name in kernels}
    rows_checked = 0
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
                    for i in range(rows):
                        x, y = (a[i] if a.ndim == 2 else a), (b[i] if b.ndim == 2 else b)
                        one = single(a_slot, b_slot, seg, x, y, nnz_cap=cap)
                        again = single(a_slot, b_slot, seg, x, y, nnz_cap=cap)
                        require(torch.equal(one, again), f"segsum_reuse {case} {label} row "
                                                         f"{i}: a launch does not repeat itself")
                        require(torch.equal(got[i], one),
                                f"batched segsum_reuse {case} {label} row {i}: not bitwise "
                                f"the single launch")
                        rows_checked += 1
            worst[f"batched_{name}"] = max(worst[f"batched_{name}"], *errs)
            log(f"   batched {name} {case}: fm {seg.shape[0]}, nnz_cap {cap}, stackings "
                f"{[s[0] for s in stacks]}; max |batched - _replay_batched| over f32, "
                f"bf16 B {max(errs):.3e}")
    log(f"   K1: each of {rows_checked} batched rows bitwise its single launch, and each "
        f"single launch bitwise a second one (every plan, long segments included)")
    torch.cuda.synchronize()
    return worst


def plan_columns_bound(fm_cap: int, nnz: int, nnz_cap: int) -> float:
    """ms the card needs at least for ``plan_columns``: every head flag read
    once, the ids and columns of the nnz heads, each of the nnz_cap slots
    written once, at 3.35 TB/s."""
    return (fm_cap + 8 * nnz + 4 * nnz_cap) / HBM_BYTES_PER_S * 1e3


def columns_by_search(seg_ids, cols_s, nnz: int, nnz_cap: int) -> torch.Tensor:
    """C's columns in plain torch with no atomics, the formulation the
    kernel is timed against: slot s's head is the first product whose
    ``seg_ids`` reaches s (a binary search over the sorted ids), its column
    gathered; the slots past nnz stay 0."""
    out = torch.zeros(nnz_cap, dtype=torch.int32, device=seg_ids.device)
    n = min(nnz, nnz_cap)
    slots = torch.arange(n, dtype=torch.int32, device=seg_ids.device)
    out[:n] = cols_s[torch.searchsorted(seg_ids, slots)].clamp_(min=0)
    return out


def phase_plan_columns(pc, root: Path, dev="cuda") -> dict:
    """Phase 2b: ``plan_columns`` bit for bit against its plain version on
    every case of ``tests/plan_columns_cases``, each launch counted; at RMAT
    graph 0 the wrapper's time (its fill and the launch) beside the plain
    version's, the plain search-and-gather's (``columns_by_search``, also
    held bitwise) and the bound. Returns the times and the largest
    |kernel - plain| over every case."""
    spec = importlib.util.spec_from_file_location(
        "plan_columns_cases", root / "tests" / "plan_columns_cases.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    out, err = {}, 0
    for case, heads, seg_ids, cols_s, nnz_cap, timed in cases.plan_columns_cases(dev, log=log):
        want = pc.plan_columns_plain(heads, seg_ids, cols_s, nnz_cap)
        launches = pc.LAUNCHES
        got = pc.plan_columns(heads, seg_ids, cols_s, nnz_cap)
        torch.cuda.synchronize()
        require(pc.LAUNCHES == launches + (heads.shape[0] > 0 and nnz_cap > 0),
                f"plan_columns {case}: {pc.LAUNCHES - launches} launches")
        require(got.dtype == torch.int32 and tuple(got.shape) == (nnz_cap,),
                f"plan_columns {case}: {got.dtype} {tuple(got.shape)}")
        if nnz_cap:
            err = max(err, int((got.long() - want.long()).abs().max()))
        diff = int((got != want).sum())
        require(diff == 0, f"plan_columns {case}: {diff} slots differ from the plain version")
        log(f"   plan_columns {case}: bitwise the plain version's")
        if timed:
            nnz = int(heads.sum())
            searched = columns_by_search(seg_ids, cols_s, nnz, nnz_cap)
            require(torch.equal(searched, want),
                    f"columns_by_search {case}: differs from the plain version")
            out = {"ms": time_ms(lambda: pc.plan_columns(heads, seg_ids, cols_s, nnz_cap)),
                   "plain_ms": time_ms(lambda: pc.plan_columns_plain(heads, seg_ids, cols_s,
                                                                     nnz_cap), reps=3),
                   "search_ms": time_ms(lambda: columns_by_search(seg_ids, cols_s, nnz,
                                                                  nnz_cap)),
                   "bound_ms": plan_columns_bound(heads.shape[0], nnz, nnz_cap),
                   "bound_by": "bytes", "shape": case}
            log(f"   plan_columns {case}: {out['ms']:.3f} ms (fill and launch), plain "
                f"{out['plain_ms']:.3f} ms, search and gather {out['search_ms']:.3f} ms "
                f"(bitwise the plain version's), bound {out['bound_ms']:.3f} ms (bytes)")
    require(out, "plan_columns: no timed case")
    log(f"   plan_columns: max |kernel - plain| {err} over every case")
    out["max_abs_err"] = float(err)
    return out


def with_values(csr, values):
    from repro_torch.sparse import CSR

    return CSR(csr.indptr, csr.indices, values, csr.shape)


def fresh_repeats(rt, seg_mod, lp_mod, name, a, b) -> float:
    """A fresh multiply's values repeat bit for bit on the card: two
    spgemm(method="sparse") calls without a plan cache, each one K1 launch
    (stats "pallas") and nothing else, their values equal, and within
    F32_TOL of the plain ``numeric_reuse`` on the plan (whose f32
    ``index_add_`` adds in another order each run). Returns the largest
    |K1 - plain|."""
    seg_mod.LAUNCHES = lp_mod.LAUNCHES = 0
    rt.telemetry.FALLBACK_COUNTS.clear()
    runs = [rt.spgemm(a, b, method="sparse", plan_cache=False) for _ in range(2)]
    torch.cuda.synchronize()
    launches = {"segsum_reuse": seg_mod.LAUNCHES, "lp_reuse": lp_mod.LAUNCHES}
    require(launches == {"segsum_reuse": 2, "lp_reuse": 0},
            f"{name}: two fresh multiplies launched {launches}, not K1 twice")
    require([x.stats["replay_backend"] for x in runs] == ["pallas", "pallas"],
            f"{name}: fresh numeric phase {[x.stats['replay_backend'] for x in runs]}")
    check_fallbacks(rt, f"{name} fresh repeat")
    first, second = runs
    require(torch.equal(first.c.values, second.c.values),
            f"{name}: two fresh multiplies differ in their bits")
    pl = first.plan
    want = rt.numeric_reuse(pl, a.values, b.values)
    scale = rt.numeric_reuse(pl, a.values.abs(), b.values.abs())
    err = tolerance_check(f"{name} fresh K1 vs plain", first.c.values, want, scale, F32_TOL)
    plain_again = rt.numeric_reuse(pl, a.values, b.values)
    log(f"   {name}: two fresh multiplies through K1 bitwise equal ({int(pl.indptr[-1])} "
        f"values); max |K1 - plain| {err:.3e}; the plain version twice bitwise equal: "
        f"{torch.equal(want, plain_again)}")
    return err


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

    pc = importlib.import_module("repro_torch.kernels.plan_columns")
    seg_mod.LAUNCHES = 0
    lp_mod.LAUNCHES = 0
    pc.LAUNCHES = 0
    builds0 = rt.stage_counts.get("plan_from_sorted", 0)
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
    # every fresh multiply's numeric phase is K1 too: the four spgemm calls
    # and the two executors' pins (from_matrices runs spgemm)
    fresh = 6
    log(f"   launches on the multigrid path: {launches} for {fresh} fresh multiplies and "
        f"{replays} replays")
    require(launches["segsum_reuse"] == fresh + replays,
            f"segsum_reuse launched {launches['segsum_reuse']} times for {fresh} fresh "
            f"multiplies and {replays} replays")
    require(launches["lp_reuse"] == 0, "lp_reuse launched on the multigrid path")
    # every plan the main path built wrote C's columns through the kernel
    builds = rt.stage_counts.get("plan_from_sorted", 0) - builds0
    require(builds > 0 and pc.LAUNCHES == builds,
            f"plan_columns launched {pc.LAUNCHES} times for {builds} fresh plan builds")
    log(f"   plan_columns: {pc.LAUNCHES} launches for {builds} fresh plan builds")
    launches["plan_columns"] = pc.LAUNCHES
    require(all(x.stats["replay_backend"] == "pallas" for x in (ap_pos, rap_pos, ap, rap)),
            "a fresh multiply's numeric phase was not K1")
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

    worst = max(worst, fresh_repeats(rt, seg_mod, lp_mod, "multigrid A*P", a_nrm, p))
    worst = max(worst, default_replays(rt, seg_mod, lp_mod, ap, ex_ap, a_nrm, p, g, out))
    out.update(multigrid_launches=launches, multigrid_worst=worst,
               r=r, a=a_nrm, p=p, ap=ap, ex_ap=ex_ap, ex_rap=ex_rap, nnz_a=nnz_a)


def default_replays(rt, seg_mod, lp_mod, ap, ex_k1, a, p, g, out: dict) -> float:
    """The default backend ("auto") at multigrid A*P: ReuseExecutor(plan)
    replays twice (two K1 launches, bitwise equal, within F32_TOL of the
    plain version), then spgemm_grouped of two multiplies of the structure
    (one batched K1 launch) and of one (one K1 launch); no plain stage
    (numeric_reuse, the plain batched replay) and no fallback key. Logs the
    default replay's time beside the explicit K1 executor's and the plain
    version's (CUDA events, median of 7). Returns the largest |K1 - plain|."""
    ex = rt.ReuseExecutor(ap.plan)
    pl, cap = ex.plan, ex.nnz_cap
    av = torch.randn(a.nnz_cap, generator=g, device="cuda")
    a2 = with_values(a, torch.randn(a.nnz_cap, generator=g, device="cuda"))
    a3 = with_values(a, torch.randn(a.nnz_cap, generator=g, device="cuda"))
    torch.cuda.synchronize()
    seg_mod.LAUNCHES = lp_mod.LAUNCHES = seg_mod.BATCHED_LAUNCHES = lp_mod.BATCHED_LAUNCHES = 0
    rt.telemetry.FALLBACK_COUNTS.clear()
    stages0 = dict(rt.stage_counts)
    first, second = ex.apply(av, p.values), ex.apply(av, p.values)
    grouped = rt.spgemm_grouped([(a2, p), (a3, p)])
    single = rt.spgemm_grouped([(a2, p)])
    torch.cuda.synchronize()
    launches = {"segsum_reuse": seg_mod.LAUNCHES, "lp_reuse": lp_mod.LAUNCHES,
                "segsum_reuse_batched": seg_mod.BATCHED_LAUNCHES,
                "lp_reuse_batched": lp_mod.BATCHED_LAUNCHES}
    stages = {k: v - stages0.get(k, 0) for k, v in rt.stage_counts.items()
              if v != stages0.get(k, 0)}
    want = {"segsum_reuse": 3, "lp_reuse": 0, "segsum_reuse_batched": 1, "lp_reuse_batched": 0}
    require(launches == want, f"default replays: launches {launches}, not {want}")
    for key in ("numeric_reuse", "executor_apply_batched"):
        require(key not in stages, f"default replays: the plain stage {key} ran "
                                   f"{stages.get(key)} times")
    require(ex.last_backend == "pallas", f"default replay ran {ex.last_backend}")
    check_fallbacks(rt, "default replays")
    require(torch.equal(first, second), "two default replays differ in their bits")
    args = (pl.a_slot_s, pl.b_slot_s, pl.seg_ids)
    err = 0.0
    for name, got, x in (("default replay", first, av), ("grouped, batched 0", grouped[0].values,
                                                        a2.values),
                         ("grouped, batched 1", grouped[1].values, a3.values),
                         ("grouped, single", single[0].values, a2.values)):
        want_v = seg_mod.segsum_reuse_plain(*args, x, p.values, cap)
        scale = seg_mod.segsum_reuse_plain(*args, x.abs(), p.values.abs(), cap)
        err = max(err, tolerance_check(f"multigrid A*P {name}", got, want_v, scale, F32_TOL))
    require(torch.equal(grouped[0].values, single[0].values),
            "a batched K1 row differs from its single launch")
    t_default = time_ms(lambda: ex.apply(av, p.values))
    t_k1 = time_ms(lambda: ex_k1.apply(av, p.values))
    t_plain = time_ms(lambda: rt.numeric_reuse(pl, av, p.values))
    log(f"   default ReuseExecutor(plan) at multigrid A*P: two replays through K1 bitwise "
        f"equal, max |K1 - plain| {err:.3e}; spgemm_grouped: one batched K1 launch for two "
        f"multiplies, one K1 launch for one; launches {launches}, no plain stage; the default "
        f"replay {t_default:.3f} ms, the explicit K1 executor {t_k1:.3f} ms, the plain "
        f"numeric_reuse {t_plain:.3f} ms")
    out["default_replay"] = {"ms": t_default, "k1_executor_ms": t_k1, "plain_ms": t_plain,
                             "launches": launches}
    return err


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
    log(f"   launches on the power-law path: {launches} for 1 lp multiply + 3 replays "
        f"(K2) and the executor's pin (a fresh sparse multiply: K1)")
    require(launches["lp_reuse"] == 4, f"lp_reuse launched {launches['lp_reuse']} times, not 4")
    require(launches["segsum_reuse"] == 1,
            f"segsum_reuse launched {launches['segsum_reuse']} times, not once (the pin)")
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
    del replays, inputs
    torch.cuda.empty_cache()
    out["fresh_worst"] = fresh_repeats(rt, seg_mod, lp_mod, "RMAT-16 A*A", a, a)
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
            "numeric_reuse": time_ms(lambda: rt.numeric_reuse(plan, a_vals, b_vals)),
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
        log(f"   {label}: a fresh multiply's numeric phase is K1 on the card, "
            f"{row['segsum_reuse']:.3f} ms, where the plain numeric_reuse (index_add_) "
            f"takes {row['numeric_reuse']:.3f} ms on the same plan")

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


def profile_run(label: str, fn, steps: int = 3) -> tuple:
    """``fn`` under torch.profiler: a warm-up step that the profiler traces
    and drops (CUPTI loses the first kernels of a window), then ``steps``
    recorded ones. Per step: the synchronised host interval, the device's
    busy time (kernels and copies) and its idle share, logged with the top
    device and host rows (counts per step). Returns (host ms, device busy
    ms, device rows as (ms, count, name)), per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
            torch.cuda.synchronize()
            prof.step()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    # device-side events only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched, and a step's row spans it
    rows = [(e.self_device_time_total / steps / 1e3, e.count / steps, e.key)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    rows.sort(reverse=True)
    dev_us = sum(r[0] for r in rows) * 1e3
    log(f"   {label}: host {wall_us / 1e3:.3f} ms, device busy {dev_us / 1e3:.3f} ms, "
        f"idle share {1 - dev_us / wall_us:.3f} (torch.profiler, mean of {steps} steps)")
    for ms, count, key in rows[:8]:
        log(f"      {ms:9.3f} ms  x{count:<4g} {key[:90]}")
    host = sorted(((e.self_cpu_time_total / steps, e.count / steps, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CPU
                   and not e.key.startswith("ProfilerStep")), reverse=True)
    for us, count, key in host[:4]:
        log(f"      {us / 1e3:9.3f} ms  x{count:<4g} host: {key[:84]}")
    return wall_us / 1e3, dev_us / 1e3, rows


def phase_profile(rt, mg: dict, pw: dict) -> None:
    """Where the time goes: device time by kernel under torch.profiler for a
    fresh multiply and a replay of each path, and the device's idle share
    of the synchronised host interval."""
    a, p, rm = mg["a"], mg["p"], pw["rmat"]
    runs = {
        "fresh AP spgemm(sparse)": lambda: rt.spgemm(a, p, method="sparse", plan_cache=False),
        "replay AP (pallas)": lambda: mg["ex_ap"].apply(a.values, p.values),
        "fresh A*A spgemm(lp)": lambda: rt.spgemm(rm, rm, method="lp", plan_cache=False),
        "replay A*A (pallas_lp)": lambda: pw["rmat_ex"].apply(rm.values, rm.values),
    }
    for label, fn in runs.items():
        profile_run(label, fn)


# ---------------------------------------------------------------------------
# The kernel-backed two-phase path (kernels/ops): K5, K4 and K3
# ---------------------------------------------------------------------------

ELL_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float16, torch.float16), (torch.bfloat16, torch.float32)]
OPS_KERNELS = ("spgemm_symbolic", "spgemm_numeric", "spgemm_lp")


def ell_tol(dtype):
    return F32_TOL if dtype == torch.float32 else BF16_TOL


def reset_launches(km) -> None:
    km.seg.LAUNCHES = km.lp.LAUNCHES = km.lp.NUMERIC_LAUNCHES = km.pc.LAUNCHES = 0
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
# phase 2's K7 pairs: both variants, "tf32" at 3, 2 and 1 products in both orders
K7_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float16, torch.float16), (torch.bfloat16, torch.float32),
            (torch.float16, torch.bfloat16), (torch.float32, torch.bfloat16),
            (torch.float32, torch.float16), (torch.float16, torch.float32),
            (torch.bfloat16, torch.float16)]
K8_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2, torch.float16: 5e-2}
# ||kernel - plain||_F / ||plain||_F of each K8 output, beside K8_TOL: at T
# 8,192 a typical |out| is below K8_TOL's atol, so that rule alone would pass
# a kernel that drops a key stage. Bounds: 4-10x the worst measured on an
# H100 (phases 2 and 12): bf16 2.3e-3, f16 2.9e-4, f32 1.1e-6 on "fma"
# (2.4e-6 on "tf32" since PR 30: three TF32 products a product).
K8_FRO = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
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
    lib = km.gm._build.load("grouped_matmul")
    lib.grouped_matmul_variant.argtypes = lib.grouped_matmul_products.argtypes = [ctypes.c_int] * 2
    lib.grouped_matmul_variant.restype, lib.grouped_matmul_products.restype = (ctypes.c_char_p,
                                                                              ctypes.c_int)
    for xd, wd in K7_PAIRS:  # the library's rule is the one variant() and products() state
        codes = (km.gm.DTYPE_CODES[xd], km.gm.DTYPE_CODES[wd])
        named = (lib.grouped_matmul_variant(*codes).decode(), lib.grouped_matmul_products(*codes))
        require(named == (km.gm.variant(xd, wd), km.gm.products(xd, wd)),
                f"K7 {pair_name(xd, wd)}: the library runs {named}, variant() and products() "
                f"say {(km.gm.variant(xd, wd), km.gm.products(xd, wd))}")
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
            key = f"{DT_NAME[xd]}x{DT_NAME[wd]} ({km.gm.variant(xd, wd)}, " \
                  f"{km.gm.products(xd, wd)} products)"
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


# phase 11's (x, w) dtype pairs: each variant of K7, the f32 and mixed pairs
# on "tf32" with 3, 2 and 1 products
MOE_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
             (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float16))


def pair_name(xd, wd) -> str:
    return DT_NAME[xd] if xd == wd else f"{DT_NAME[xd]}x{DT_NAME[wd]}"


def k7_bound(gm, x, w, n_rows: int, used: int) -> tuple:
    """(ms, "bytes" or "operations") of K7 on these inputs: x, the weights of
    the experts that own a block and y (in x's dtype) once each at 3.35 TB/s,
    against the variant's tensor-core products (``gm.products``: 2 * T * d *
    f flops each) at its peak, 989 TFLOP/s on "wgmma", 495 on "tf32"."""
    t_bytes = ((x.numel() + n_rows * w.shape[2]) * x.element_size()
               + used * w[0].numel() * w.element_size()) / HBM_BYTES_PER_S * 1e3
    flops = gm.products(x.dtype, w.dtype) * 2 * n_rows * x.shape[1] * w.shape[2]
    peak = BF16_FLOPS_PER_S if gm.variant(x.dtype, w.dtype) == "wgmma" else TF32_FLOPS_PER_S
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")




def k8_bound(fa, q, k, v, flops: float) -> tuple:
    """(ms, "bytes" or "operations") of K8 on these inputs: q, k, v and the
    output (in q's dtype) once each at 3.35 TB/s, against ``flops`` (4 * D a
    live (query, key) pair of each head) at the variant's rate: three TF32
    products at 495 TFLOP/s on "tf32", one pass at 67 TFLOP/s of f32 FMAs on
    "fma", 989 TFLOP/s on the bf16/f16 variants."""
    t_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() / HBM_BYTES_PER_S * 1e3
    ran = fa.variant(q.dtype, q.shape[2])
    if ran == "tf32":
        t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3
    elif ran == "fma":
        t_ops = flops / F32_FLOPS_PER_S * 1e3
    else:
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_moe(rt, km, seed: int, out: dict, n_tokens=4096, dev="cuda") -> None:
    """K7 at qwen3-moe-30b-a3b widths through ops.expert_matmul: tokens routed
    top-8 over 128 experts, sorted by expert and padded per expert to 128
    rows; one layer's up projection x @ w1 (d_model -> expert width) and
    down projection (expert width -> d_model, on x @ w1's output), for each
    (x, w) dtype pair of MOE_PAIRS (x and the output in the first, both
    weights in the second)."""
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
    ws = {dt: (w1.to(dt), w2.to(dt)) for dt in dict.fromkeys(wd for _, wd in MOE_PAIRS)}
    reset_new_launches(km)
    for xd, wd in MOE_PAIRS:  # the main path: up, then down on its output
        xi, (w1d, w2d) = x.to(xd), ws[wd]
        ys["x@w1", xd, wd] = km.ops.expert_matmul(xi, w1d, be)
        ys["down", xd, wd] = km.ops.expert_matmul(ys["x@w1", xd, wd], w2d, be)
        ins["x@w1", xd, wd], ins["down", xd, wd] = (xi, w1d), (ys["x@w1", xd, wd], w2d)
    torch.cuda.synchronize()
    launches = read_new_launches(km)
    require(launches == {"bsr_spgemm": 0, "grouped_matmul": 2 * len(MOE_PAIRS),
                         "flash_attention": 0}, f"launches {launches}")
    check_fallbacks(rt, "MoE path")
    del x, w1, w2, ws
    pad = torch.ones(n_rows, dtype=torch.bool, device=dev)
    pad[rows] = False
    worst, rel_worst = 0.0, {}
    for (proj, xd, wd), y in ys.items():
        width = f if proj == "x@w1" else d
        name = pair_name(xd, wd)
        require(y.shape == (n_rows, width) and y.dtype == xd,
                f"K7 {proj} {name} output {y.dtype} {tuple(y.shape)}")
        require(bool((y[pad] == 0).all()), f"K7 {proj} {name}: padding rows are not 0")
        err, rel = close_check(f"K7 {proj} {name}", y,
                               km.gm.grouped_matmul_plain(*ins[proj, xd, wd], be), K7_TOL[xd],
                               K7_FRO[xd])
        worst = max(worst, err)
        rel_worst[name] = max(rel_worst.get(name, 0.0), rel)
        log(f"   K7 {proj} {name}, variant {km.gm.variant(xd, wd)} "
            f"({km.gm.products(xd, wd)} products): max |kernel - plain| {err:.3e}, relative "
            f"Frobenius {rel:.3e} (bound {K7_FRO[xd]}); padding rows 0")
    out.update(launches=launches, worst=worst, ins=ins, be=be, n_rows=n_rows,
               assignments=rows.shape[0], cfg=cfg, used=used, rel_fro=rel_worst)


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
    # f32 ("tf32") beside SDPA in f32: the yardstick of K8's f32 variant
    shapes.append(("llama3.2-1b f32", lla, dict(causal=True), torch.float32, True))
    shapes.append(("qwen3-moe-30b-a3b bf16", qwe, dict(causal=True), torch.bfloat16, True))
    return shapes


def phase_attention(rt, km, seed: int, out: dict, t=ATTN_T, dev="cuda") -> None:
    """K8 through ops.attention at full head widths, T = 8192: gemma2-9b
    (softcap 50; a local layer with its 4,096 window and a global layer; bf16
    and f32), llama3.2-1b (causal, bf16 and f32) and qwen3-moe-30b-a3b
    (causal, bf16)."""
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
    for (proj, xd, wd), (x, w) in moe["ins"].items():
        label = f"{cfg.name} {n_rows} rows {proj} {pair_name(xd, wd)}"
        r = {"ms": time_ms(lambda: km.ops.expert_matmul(x, w, be)),
             "plain_ms": time_ms(lambda: km.gm.grouped_matmul_plain(x, w, be)),
             "variant": km.gm.variant(xd, wd), "products": km.gm.products(xd, wd)}
        r["bound_ms"], r["bound_by"] = k7_bound(km.gm, x, w, n_rows, moe["used"])
        flops = 2 * n_rows * x.shape[1] * w.shape[2]
        if xd == wd:  # one torch.bmm computes the same function (f32 in full f32)
            wg = w[be.long()]  # the yardstick's gather, outside the timing
            xb = x.view(-1, 128, x.shape[1])
            r["library_ms"] = time_ms(lambda: torch.bmm(xb, wg))
            lib_s = f"torch.bmm over w[block_expert] {r['library_ms']:.3f} ms"
            del wg
            torch.cuda.empty_cache()
        else:
            r["library_ms"] = None
            lib_s = "library null: no one PyTorch call multiplies mixed dtypes"
        times["grouped_matmul"][label] = r
        log(f"   K7 {label}: variant {r['variant']} ({r['products']} products), {r['ms']:.3f} ms "
            f"({flops / r['ms'] / 1e9:.1f} TFLOP/s of the contract, {r['bound_ms'] / r['ms']:.3f} "
            f"of the bound), plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), {lib_s}")
    # K8
    times["flash_attention"] = {}
    t = attn["t"]
    for label, cfg, kw, dt, sdpa in attention_shapes(rt):
        q, k, v = attn["ins"][label]
        r = {"ms": time_ms(lambda: km.ops.attention(q, k, v, **kw)),
             "plain_ms": time_ms(lambda: km.fa.flash_attention_plain(q, k, v, **kw))}
        flops = 4 * q.shape[0] * q.shape[2] * live_pairs(t, kw["causal"], kw.get("window"))
        r["bound_ms"], r["bound_by"] = k8_bound(km.fa, q, k, v, flops)
        r["variant"] = km.fa.variant(dt, q.shape[2])
        if sdpa:
            r["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, enable_gqa=True))
            lib_s = f"{r['library_ms']:.3f} ms (scaled_dot_product_attention, enable_gqa)"
        else:
            r["library_ms"] = None
            lib_s = "null: scaled_dot_product_attention has no softcap"
        times["flash_attention"][label] = r
        log(f"   K8 {label}: variant {r['variant']}, {r['ms']:.3f} ms "
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
    """(a)/(b)/(a') 16 requests alternating the two structures at max_batch
    8, validate="host": every group batched, one batched launch of the
    backend's kernel a group (none of any other; K1's for "auto", the
    default), no plain stage, no fault/dtype/nan_guard key; values against
    the plain replay, one response per structure against scipy in float64."""
    served = "pallas" if backend == "auto" else backend  # "auto" replays through K1 here
    kernel = REPLAY_KERNEL[served]
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
    err = check_responses(km, name, svc, sent, resps, served, 4)
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
                lambda: serve_steady(rt, km, structs, g, "auto", cache, out),
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


DIST_SHARDS = 8
DIST_LABELS = ("multigrid A*P", "power-law A*A")


def dist_counts_zero(rt, km) -> None:
    """Set every count the sharded path is judged by to 0."""
    km.seg.LAUNCHES = km.seg.BATCHED_LAUNCHES = km.lp.LAUNCHES = 0
    rt.stage_counts.clear()
    rt.hash_counts.clear()
    km.telemetry.FALLBACK_COUNTS.clear()


def dist_single(rt, km, a, b, av, bv) -> dict:
    """The single-device references of a sharded replay: the plan, its
    plain replay (and the |products| replay that scales the tolerance) and
    its K1 replay, on the live slots."""
    plan = rt.spgemm(a, b, method="sparse", plan_cache=False).plan
    n = int(plan.indptr[-1])
    return {"plan": plan, "n": n,
            "plain": rt.numeric_reuse(plan, av, bv)[:n],
            "scale": rt.numeric_reuse(plan, av.abs(), bv.abs())[:n],
            "k1": km.seg.segsum_reuse(plan, av, bv)[:n]}


def dist_check(rt, km, name, ex, single, av, bv, out) -> torch.Tensor:
    """One counted sharded replay: K1 launched once a live shard and no plain
    stage, no structure hash; C's structure after ``merge`` bitwise the
    single-device plan's, values within F32_TOL of the single-device plain
    and K1 replays. Returns the merged values."""
    live = sum(ex.live_shards)
    dist_counts_zero(rt, km)
    v = ex.apply(av, bv)
    torch.cuda.synchronize()
    launches = km.seg.LAUNCHES
    require(launches == live, f"{name}: K1 launched {launches} times, not once a live "
                              f"shard ({live} of {ex.num_shards})")
    require(rt.stage_counts["numeric_reuse"] == 0, f"{name}: the plain replay ran")
    require(sum(rt.hash_counts.values()) == 0, f"{name}: a replay hashed the structure")
    check_fallbacks(rt, name)
    out["launches"] = out.get("launches", 0) + launches
    c = ex.merge(v)
    p, n = single["plan"], single["n"]
    require(torch.equal(c.indptr, p.indptr) and torch.equal(c.indices[:n], p.indices[:n]),
            f"{name}: merged structure differs from the single-device plan's")
    got = ex.merge_values(v)
    require(torch.equal(got, c.values[:n].to(got.device)), f"{name}: merge_values != merge")
    worst = max(tolerance_check(f"{name} vs single plain", got, single["plain"],
                                single["scale"], F32_TOL),
                tolerance_check(f"{name} vs single K1", got, single["k1"], single["scale"],
                                F32_TOL))
    out["worst"] = max(out.get("worst", 0.0), worst)
    log(f"   {name}: {launches} K1 launches (live shards {live}/{ex.num_shards}), "
        f"structure bitwise the single-device plan's, max |sharded - single| {worst:.3e}")
    return got


def dist_timed(rt, km, name, ex, av, bv, out) -> float:
    """Median of 7 CUDA-event times around the whole ``apply``; the launches
    of the 8 calls must be 8 x the live shards, and no plain stage moves."""
    live = sum(ex.live_shards)
    dist_counts_zero(rt, km)
    t = time_ms(lambda: ex.apply(av, bv))
    torch.cuda.synchronize()
    require(km.seg.LAUNCHES == 8 * live,
            f"{name}: {km.seg.LAUNCHES} K1 launches in 8 timed replays, not {8 * live}")
    require(rt.stage_counts["numeric_reuse"] == 0 and not rt.hash_counts,
            f"{name}: a timed replay ran the plain stage or hashed")
    out["launches"] = out.get("launches", 0) + km.seg.LAUNCHES
    return t


def dist_profiled(rt, km, name, ex, av, bv, out):
    """The device's busy time in a sharded replay (``profile_run``: a
    warm-up, a dropped step, 3 recorded ones), each K1 launch counted.
    None where the trace lost a K1 launch (CUPTI drops events now and then
    in the chip's sandbox): a busy time short of a kernel is not used."""
    live = sum(ex.live_shards)
    dist_counts_zero(rt, km)
    _, busy_ms, rows = profile_run(f"{name} (profiled)", lambda: ex.apply(av, bv))
    require(km.seg.LAUNCHES == 5 * live and rt.stage_counts["numeric_reuse"] == 0,
            f"{name}: {km.seg.LAUNCHES} K1 launches in the profiled replays")
    out["launches"] = out.get("launches", 0) + km.seg.LAUNCHES
    traced = sum(count for _, count, key in rows if "segsum_reuse_kernel" in key)
    if traced != live:
        log(f"   {name}: the trace holds {traced:g} of {live} K1 launches a step; its busy "
            f"time is not used")
        return None
    return busy_ms


def dist_pin(rt, a, b, mesh, placement, name):
    """Pin a sharded executor (fresh plan cache): one hash, and its peak
    device memory above what was allocated before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rt.hash_counts.clear()
    t0 = time.perf_counter()
    ex = rt.ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                               plan_cache=rt.PlanCache(name="dist_smoke"))
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    require(sum(rt.hash_counts.values()) == 1, f"{name}: pin hashed "
                                              f"{dict(rt.hash_counts)}, not once")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return ex, pin_s, peak


def dist_pin_split(rt, a, b, mesh) -> dict:
    """The pin of S = 8, replicated, step by step (host clock, synchronised):
    prepare_sparse_inputs, the structure hash, the host partition (rows,
    value maps, fm_cap), the sharded expand+sort and the per-shard plans."""
    import dataclasses

    from repro_torch.core import distributed as dist_core
    from repro_torch.core.meta import round_capacity
    from repro_torch.core.plan_cache import structure_key
    from repro_torch.core.spgemm import SortedExpansion, plan_from_sorted, prepare_sparse_inputs
    from repro_torch.dist.plan import dist_expand_and_sort

    split = {}

    def step(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        split[key] = (time.perf_counter() - t0) * 1e3
        return res

    pa, pb, _, _, fm_cap = step("prepare_sparse_inputs", lambda: prepare_sparse_inputs(
        a, b, "pow2"))
    step("structure_key", lambda: structure_key(pa, pb, fm_cap, "pow2"))
    num = mesh.shape["data"]

    def partition():
        a_sh = dist_core.partition_rows(pa, num)
        dist_core.partition_value_map(pa, num)
        return a_sh, dist_core.shard_fm_cap(a_sh, pb)

    a_sh, shard_fm = step("host partition", partition)
    sx = step("sharded expand+sort", lambda: dist_expand_and_sort(a_sh, pb, mesh, "data",
                                                                  shard_fm))
    nnz_cap = round_capacity(int(sx.row_sizes.sum(1).max()))
    names = [f.name for f in dataclasses.fields(SortedExpansion)]
    step("plans", lambda: [plan_from_sorted(SortedExpansion(**{k: getattr(sx, k)[i]
                                                              for k in names}),
                                            pb.k, nnz_cap) for i in range(num)])
    return split


def phase_dist_cell(rt, km, label, a, b, av, bv, shard_counts, out, smi, t_single=None):
    """(a)/(b): one cell at each shard count and placement."""
    single = dist_single(rt, km, a, b, av, bv)
    s_plan = single["plan"]
    cell = {"single_plan_bytes": rt.plan_nbytes(s_plan), "runs": {}}
    log(f"   {label}: single-device plan fm_cap {s_plan.seg_ids.shape[0]}, nnz_cap "
        f"{s_plan.indices.shape[0]}, nnz(C) {single['n']}, {cell['single_plan_bytes']} bytes")
    for shards in shard_counts:
        mesh = rt.compat.make_mesh((shards,), ("data",), device=a.device)
        for placement in ("replicated", "allgather"):
            name = f"{label} S={shards} {placement}"
            ex, pin_s, pin_peak = dist_pin(rt, a, b, mesh, placement, name)
            live_products = (ex.plan.seg_ids < ex.nnz_cap).sum(1).tolist()
            run = {"pin_s": pin_s, "pin_peak_gib": pin_peak,
                   "plan_bytes": rt.plan_nbytes(ex.plan), "live_products": live_products,
                   "fm_cap": ex.plan.fm_cap, "nnz_cap": ex.nnz_cap}
            log(f"   {name}: pin {pin_s:.3f} s (peak {pin_peak:.3f} GiB above the operands); "
                f"stacked plan fm_cap {ex.plan.fm_cap} x {shards}, nnz_cap {ex.nnz_cap}, "
                f"{run['plan_bytes']} bytes ({run['plan_bytes'] / cell['single_plan_bytes']:.2f}"
                f"x the single-device plan); live products per shard {live_products}")
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            dist_check(rt, km, name, ex, single, av, bv, out)
            run["apply_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            run["ms"] = dist_timed(rt, km, name, ex, av, bv, out)
            log(f"   {name}: replay {run['ms']:.3f} ms (CUDA events around apply, median "
                f"of 7; {smi}); peak {run['apply_peak_gib']:.3f} GiB above the plan"
                + (f"; phase 5's single-device K1 {t_single:.3f} ms" if t_single else ""))
            if placement == "replicated":
                run["busy_ms"] = dist_profiled(rt, km, name, ex, av, bv, out)
                if run["busy_ms"] is not None:
                    log(f"   {name}: device busy {run['busy_ms']:.3f} ms of the "
                        f"{run['ms']:.3f} ms replay, idle share "
                        f"{1 - run['busy_ms'] / run['ms']:.3f}")
            cell["runs"][f"S={shards} {placement}"] = run
            if shards == DIST_SHARDS and placement == "replicated":
                cell["ex"] = ex
            del ex
            torch.cuda.empty_cache()
    cell["single"] = single
    return cell


def phase_dist_batched(rt, km, ex, single, av, bv, g, out) -> None:
    """(c) apply_batched at batch 4: one batched K1 launch a live shard, each
    row within F32_TOL of apply on that row."""
    live = sum(ex.live_shards)
    a_stack = torch.randn(4, av.shape[0], generator=g, device=av.device)
    dist_counts_zero(rt, km)
    got = ex.apply_batched(a_stack, bv)
    torch.cuda.synchronize()
    require(km.seg.BATCHED_LAUNCHES == live and km.seg.LAUNCHES == 0,
            f"apply_batched: {km.seg.BATCHED_LAUNCHES} batched launches and "
            f"{km.seg.LAUNCHES} single ones, not {live} and 0")
    require(rt.stage_counts["numeric_reuse"] == 0, "apply_batched ran the plain stage")
    out["batched_launches"] = km.seg.BATCHED_LAUNCHES
    worst = 0.0
    for i in range(4):
        row = ex.apply(a_stack[i], bv)
        scale = ex.apply(a_stack[i].abs(), bv.abs())
        worst = max(worst, tolerance_check(f"batched row {i}", got[i], row, scale, F32_TOL))
    out["worst"] = max(out["worst"], worst)
    out["batched_ms"] = time_ms(lambda: ex.apply_batched(a_stack, bv))
    log(f"   (c) apply_batched batch 4 at S={ex.num_shards}: {live} batched K1 launches, rows "
        f"within F32_TOL of apply (max |diff| {worst:.3e}); {out['batched_ms']:.3f} ms "
        f"(CUDA events, median of 7)")


def phase_dist_fresh(rt, km, small_grid, dev, out) -> None:
    """(d) spgemm(mesh=...) and distributed_spgemm against the single-device
    spgemm at the 512^2 A*P; then a repeat that hits the dist cache."""
    _, a, p = rt.galerkin_triple(small_grid, small_grid, agg_size=4, device=dev)
    mesh = rt.compat.make_mesh((DIST_SHARDS,), ("data",), device=dev)
    want = rt.spgemm(a, p, method="sparse", plan_cache=False).c
    n = int(want.indptr[-1])
    scale = rt.spgemm(with_values(a, a.values.abs()), with_values(p, p.values.abs()),
                      method="sparse", plan_cache=False).c.values[:n]
    cache = rt.PlanCache(name="dist_fresh_smoke")
    dist_counts_zero(rt, km)
    res = rt.spgemm(a, p, mesh=mesh, plan_cache=cache)
    fresh = rt.distributed_spgemm(a, p, mesh)
    again = rt.spgemm(a, p, mesh=mesh, plan_cache=cache)
    torch.cuda.synchronize()
    require(res.stats["cache"] == "miss" and again.stats["cache"] == "hit",
            f"(d) dist cache states {res.stats['cache']}, {again.stats['cache']}")
    # spgemm(mesh=) replays each shard through K1; distributed_spgemm's
    # per-shard numeric_fresh is a fresh multiply, K1 a shard too
    require(km.seg.LAUNCHES == 3 * DIST_SHARDS,
            f"(d) {km.seg.LAUNCHES} K1 launches for three sharded multiplies of "
            f"{DIST_SHARDS} shards")
    out["launches"] = out.get("launches", 0) + km.seg.LAUNCHES
    for name, c in (("spgemm(mesh=)", res.c), ("distributed_spgemm", fresh),
                    ("spgemm(mesh=) cache hit", again.c)):
        require(torch.equal(c.indptr, want.indptr) and torch.equal(c.indices[:n],
                                                                    want.indices[:n]),
                f"(d) {name}: structure differs from the single-device spgemm")
        out["worst"] = max(out["worst"], tolerance_check(
            f"(d) {name}", c.values[:n], want.values[:n], scale, F32_TOL))
    log(f"   (d) {small_grid}^2 A*P: spgemm(mesh=) {res.stats['cache']} then "
        f"{again.stats['cache']}, distributed_spgemm: structure bitwise, values within "
        f"F32_TOL of the single-device spgemm; K1 launches {km.seg.LAUNCHES}")


def phase_dist_nccl(rt, km, a, p, av, pv, ref_values, root: Path, dev, out) -> None:
    """(e) the process-group backing: world size 1 (NCCL on the card), S = 8
    local shards; (a)'s replay bitwise the single-process one, then
    compressed_psum and one all_gather through the group."""
    import os

    import torch.distributed as tdist

    rendezvous = root / "build" / "chip_smoke_rendezvous"
    rendezvous.parent.mkdir(parents=True, exist_ok=True)
    rendezvous.unlink(missing_ok=True)
    backend = "nccl" if dev == "cuda" else "gloo"
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: loopback only
    tdist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=0,
                             world_size=1)
    try:
        mesh = rt.compat.make_mesh((DIST_SHARDS,), ("data",))
        require(mesh.group is not None and mesh.S_loc == DIST_SHARDS,
                f"(e) process-group mesh: {mesh}")
        for placement, want in ref_values.items():
            ex = rt.ShardedReuseExecutor.from_matrices(
                a, p, mesh, b_placement=placement, plan_cache=rt.PlanCache(name="dist_pg"))
            dist_counts_zero(rt, km)
            got = ex.merge_values(ex.apply(av, pv))
            torch.cuda.synchronize()
            require(km.seg.LAUNCHES == sum(ex.live_shards), f"(e) {placement}: "
                                                            f"{km.seg.LAUNCHES} K1 launches")
            out["launches"] = out.get("launches", 0) + km.seg.LAUNCHES
            require(torch.equal(got, want), f"(e) {placement}: the {backend} process-group "
                                            f"replay differs from the single-process one")
            del ex
        g = torch.Generator(device=dev).manual_seed(99)
        x = torch.randn(DIST_SHARDS, 4096, generator=g, device=dev)
        single = rt.compat.Mesh((DIST_SHARDS,), ("data",), dev)
        require(torch.equal(rt.compressed_psum(x, mesh), rt.compressed_psum(x, single)),
                "(e) compressed_psum through the group differs from the single process")
        require(torch.equal(mesh.all_gather(x), x), "(e) all_gather through the group")
        log(f"   (e) {backend} world size 1, {DIST_SHARDS} local shards: both placements "
            f"bitwise the single-process replay; compressed_psum and all_gather through "
            f"{backend} equal the single-process backing")
    finally:
        tdist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)


def phase_dist_pipeline(rt, dev) -> float:
    """(f) pipeline_forward at 4 stages on one card against the serial loop
    (the reference test's rtol 1e-4 / atol 1e-5)."""
    g = torch.Generator(device=dev).manual_seed(5)
    ws = torch.randn(4, 256, 256, generator=g, device=dev) * 0.05
    x = torch.randn(8, 32, 256, generator=g, device=dev)

    def layer(w, h):
        return torch.tanh(h @ w)

    want = x
    for i in range(4):
        want = layer(ws[i], want)
    got = rt.pipeline_forward(layer, ws, x, rt.compat.make_mesh((4,), ("pipe",), device=dev),
                              axis="pipe")
    err = float((got - want).abs().max())
    require(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5)),
            f"(f) pipeline_forward vs the serial loop: max |diff| {err:.3e}")
    log(f"   (f) pipeline_forward, 4 stages on one card: max |diff| vs serial {err:.3e}")
    return err


def phase_dist(rt, km, seed: int, root: Path, smi: str, k1_ms: dict, grid=2048,
               small_grid=512, rmat_scale=16, dev="cuda") -> dict:
    """Phase 16 (a)-(g): the sharded SpGEMM on the card."""
    out: dict = {}
    g = torch.Generator(device=dev).manual_seed(seed + 80)
    _, a, p = rt.galerkin_triple(grid, grid, agg_size=4, device=dev)
    av = torch.randn(a.nnz_cap, generator=g, device=dev)
    split = dist_pin_split(rt, a, p, rt.compat.make_mesh((DIST_SHARDS,), ("data",), device=dev))
    log(f"   pin split, {DIST_LABELS[0]} S={DIST_SHARDS} replicated (ms, host clock, "
        f"synchronised; {smi}): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    out["pin_split"] = split
    cells = {}
    cells[DIST_LABELS[0]] = phase_dist_cell(rt, km, DIST_LABELS[0], a, p, av, p.values,
                                            (DIST_SHARDS, 3, 1), out, smi,
                                            t_single=k1_ms.get(DIST_LABELS[0]))
    ap = cells[DIST_LABELS[0]]
    phase_dist_batched(rt, km, ap.pop("ex"), ap["single"], av, p.values, g, out)
    ref_values = {}
    for placement in ("replicated", "allgather"):
        ex = rt.ShardedReuseExecutor.from_matrices(a, p, rt.compat.make_mesh(
            (DIST_SHARDS,), ("data",), device=dev), b_placement=placement, plan_cache=False)
        ref_values[placement] = ex.merge_values(ex.apply(av, p.values))
        del ex
    del ap["single"]
    torch.cuda.empty_cache()
    rm = rt.rmat_csr(rmat_scale, 8, seed=0, device=dev)
    rv = torch.randn(rm.nnz_cap, generator=g, device=dev)
    cells[DIST_LABELS[1]] = phase_dist_cell(rt, km, DIST_LABELS[1], rm, rm, rv, rv,
                                            (DIST_SHARDS, 1), out, smi,
                                            t_single=k1_ms.get(DIST_LABELS[1]))
    cells[DIST_LABELS[1]].pop("ex")
    del cells[DIST_LABELS[1]]["single"], rm, rv
    torch.cuda.empty_cache()
    phase_dist_fresh(rt, km, small_grid, dev, out)
    phase_dist_nccl(rt, km, a, p, av, p.values, ref_values, root, dev, out)
    out["pipeline_err"] = phase_dist_pipeline(rt, dev)
    out["cells"] = cells
    log(f"   (g) K1 launches of phase 16: {out['launches']} single, "
        f"{out['batched_launches']} batched; max |sharded - single| {out['worst']:.3e}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the LM substrate's serving path (repro_torch.models and
# serve.engine): ServeEngine prefill then decode of every architecture at
# full width, in plain torch (the reference's models call none of K1-K8)
# ---------------------------------------------------------------------------

LM_TOL = 0.15  # the reference's bf16 logit bound (tests/test_models.py:85)
LM_STEPS = 8  # decode steps a causal architecture of (b) takes
# (b)'s runs: architecture -> (batch, prompt tokens); gemma2's and
# recurrentgemma's prompts pass their windows (4,096 and 2,048), so their
# local layers decode from ring caches
LM_RUNS = {"gemma2-9b": (2, 4160), "recurrentgemma-9b": (2, 2112), "mamba2-2.7b": (2, 1024),
           "qwen2-7b": (2, 1024), "codeqwen1.5-7b": (2, 1024), "qwen3-moe-30b-a3b": (2, 512),
           "qwen3-moe-235b-a22b": (2, 512), "phi-3-vision-4.2b": (2, 1024),
           "hubert-xlarge": (2, 1024)}


def lm_tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: lm_tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(lm_tree_map(fn, v) for v in tree)
    if isinstance(tree, tuple):
        return type(tree)(*(lm_tree_map(fn, v) for v in tree))
    return fn(tree)


def lm_leaves(tree) -> list:
    out = []
    lm_tree_map(out.append, tree)
    return out


def lm_params(lm, cfg, seed: int, dev, dtype=torch.bfloat16):
    """``init_params`` in ``dtype`` on ``dev``, then every leaf it leaves at zero
    drawn from the same generator: the "norm"-role matrices (the MoE router,
    the vision and audio projections, the SSM's B/C and dt projections, the
    encoder's positions) normal x 0.02, norms and other 1-D leaves normal x
    0.1. Left at zero, the router would tie every expert and mamba2's SSD
    would add nothing."""
    g = torch.Generator(device=dev).manual_seed(seed)
    params = lm.models.init_params(cfg, g, dtype=dtype, device=dev)

    def walk(t, p, stacked):
        if lm.is_template_leaf(t):
            shape, role = t[0][1:] if stacked else t[0], t[1]
            if role == "norm" or len(shape) == 1:
                scale = 0.1 if len(shape) == 1 else 0.02
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * scale)
            return
        for key in (sorted(t) if isinstance(t, dict) else range(len(t))):
            walk(t[key], p[key], stacked or key == "blocks")

    walk(lm.models.model_template(cfg), params, False)
    return params


def lm_expert_share(cfg, calls) -> float:
    """Mean share of the experts that the recorded routing calls used."""
    if not calls:
        return 1.0
    return sum(int(torch.unique(ids).numel()) for _, ids, _ in calls) / (len(calls) * cfg.num_experts)


def lm_decode_logits(lm, eng, prompts, tokens):
    """The engine's path step by step along ``tokens`` (B, S): prefill, then
    one decode_step a token, keeping every step's logits: (prefill's last
    logits (B, V), decode logits (B, S, V))."""
    last, caches, pos = eng.prefill(prompts)
    out = []
    for i in range(tokens.shape[1]):
        lg, caches = lm.models.decode_step(eng.params, caches, tokens[:, i:i + 1], pos + i,
                                           eng.cfg, eng.rules, max_len=eng.max_len)
        out.append(lg[:, 0])
    return last, torch.stack(out, 1)


class RoutingSpy:
    """Records (router logits, expert ids, keep mask) of every
    ``routing_symbolic`` call while installed (``moe_ffn_local`` looks it
    up in its module)."""

    def __init__(self, moe_mod):
        self.mod, self.real, self.calls = moe_mod, moe_mod.routing_symbolic, []

    def __enter__(self):
        def spy(*args, **kw):
            out = self.real(*args, **kw)
            self.calls.append((args[0], out[1], out[3]))
            return out
        self.mod.routing_symbolic = spy
        return self

    def __exit__(self, *exc):
        self.mod.routing_symbolic = self.real
        return False


def lm_expert_counts(cfg, ids, keep) -> tuple:
    e = cfg.num_experts
    kept = torch.bincount(ids[keep], minlength=e).tolist()
    dropped = torch.bincount(ids[~keep], minlength=e).tolist()
    return kept, dropped


def lm_check_serving(lm, label, cfg, params, prompts, steps, out, moe=False):
    """generate (greedy) through ServeEngine, then the same path step by
    step: finite logits, each step's argmax the engine's token, and each
    step's logits against forward over prompt + tokens at the same positions.
    MoE: the prefill's routing (capacity factor 1.25) is logged per expert;
    a decode step's B tokens never fill an expert's 8 slots, so decode is
    held to a forward whose capacity drops nothing either (checked), at the
    positions where both routed the token to the same experts (bf16 noise
    in the router's input swaps near-tied k-th and (k+1)-th experts: such
    positions are counted and logged) and, for the prefill's last logits,
    where the prefill kept that token whole (one MoE layer after the
    attention: a drop or a swap changes that token's output alone).
    Returns (engine, tokens)."""
    b, t = prompts.shape
    eng = lm.ServeEngine(params, cfg, max_len=t + steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RoutingSpy(lm.moe) as spy:
        toks = eng.generate(prompts, steps)
        torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated() / 2**30
    require(tuple(toks.shape) == (b, steps) and toks.dtype == torch.int32,
            f"{label}: generate gave {tuple(toks.shape)} {toks.dtype}")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: token out of range")
    live = torch.ones((b, steps + 1), dtype=torch.bool, device=prompts.device)
    if moe:
        (lg0, ids, keep), decode_calls = spy.calls[0], spy.calls[1:]
        kept, dropped = lm_expert_counts(cfg, ids, keep)
        log(f"   {label}: prefill routing of {b} x {t} tokens, capacity factor 1.25: "
            f"{sum(dropped)} of {ids.numel()} assignments dropped, {sum(k > 0 for k in kept)} "
            f"of {cfg.num_experts} experts used")
        log(f"      kept per expert: {kept}")
        log(f"      dropped per expert: {dropped}")
        require(len(decode_calls) == steps and all(bool(k.all()) for *_, k in decode_calls),
                f"{label}: a decode step dropped an assignment")
        live[:, 0] = keep.reshape(b, t, -1)[:, -1].all(-1)
        # the routing behind each compared position: the prefill's last
        # token, then each decode step's
        got_route = (torch.stack([lg0.reshape(b, t, -1)[:, -1]] + [c[0] for c in decode_calls], 1),
                     torch.stack([ids.reshape(b, t, -1)[:, -1]] + [c[1] for c in decode_calls], 1))
        out.update(prefill_dropped=sum(dropped), prefill_assignments=ids.numel())
    with torch.no_grad():
        last, dec = lm_decode_logits(lm, eng, prompts, toks)
    require(bool(torch.isfinite(last.float()).all() and torch.isfinite(dec.float()).all()),
            f"{label}: non-finite logits")
    greedy = torch.cat([last.argmax(-1)[:, None], dec[:, :-1].argmax(-1)], 1).to(torch.int32)
    require(torch.equal(greedy, toks), f"{label}: the step-by-step argmax is not generate's "
                                       f"({int((greedy != toks).sum())} of {toks.numel()})")
    seq = torch.cat([prompts, toks], 1)
    no_drop = cfg.num_experts / max(cfg.experts_per_token, 1)  # capacity >= every token
    with torch.no_grad(), moe_capacity(lm.moe, no_drop), RoutingSpy(lm.moe) as spy:
        full, _ = lm.models.forward(params, {"tokens": seq}, cfg, lm.models.NO_SHARDING,
                                    remat=False)
    require(all(bool(k.all()) for *_, k in spy.calls), f"{label}: the no-drop forward dropped")
    if moe:
        f_lg, f_ids, _ = spy.calls[-1]
        f_lg = f_lg.reshape(b, t + steps, -1)[:, t - 1:]
        f_ids = f_ids.reshape(b, t + steps, -1)[:, t - 1:]
        same = (got_route[1].sort(-1).values == f_ids.sort(-1).values).all(-1)
        delta = float((got_route[0] - f_lg).abs().max())
        log(f"   {label}: routing of the {live.numel()} compared tokens: {int((~same).sum())} "
            f"routed to other experts than the forward's (a near tie swapped by a router-"
            f"logit difference of at most {delta:.3g})")
        require(int(same.sum()) * 2 >= same.numel(), f"{label}: routing differs at most tokens")
        live &= same
        out.update(routing_swaps=int((~same).sum()), router_logit_diff=delta)
    want = torch.cat([full[:, t - 1:t], full[:, t:t + steps]], 1).float()
    got = torch.cat([last[:, None], dec], 1).float()
    got, want = got[live], want[live]
    err = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    scale = float(want.abs().max())
    log(f"   {label}: generate {b} x {steps} tokens after a {t}-token prompt: "
        f"{gen_s:.3f} s, peak {gen_peak:.3f} GiB; decode vs forward over {int(live.sum())} "
        f"of {live.numel()} positions: max |diff| {err:.4g} (max |logit| {scale:.4g}, bound "
        f"{LM_TOL}), relative Frobenius {rel:.3e}")
    require(err <= LM_TOL, f"{label}: decode differs from forward by {err:.4g} > {LM_TOL}")
    out.update(generate_s=gen_s, generate_peak_gib=gen_peak, decode_vs_forward=err,
               decode_vs_forward_rel=rel, max_logit=scale)
    del full
    return eng, toks


@contextlib.contextmanager
def moe_capacity(moe_mod, factor: float):
    """``moe_layer`` with its capacity factor set to ``factor`` for the
    block (``apply_layer`` looks it up in its module)."""
    real = moe_mod.moe_layer
    moe_mod.moe_layer = lambda *a, **kw: real(*a, **kw, capacity_factor=factor)
    try:
        yield
    finally:
        moe_mod.moe_layer = real


def lm_times(lm, label, cfg, eng, prompts, toks, out, reps=5, profile=False):
    """Prefill ms (CUDA events, median of ``reps``), decode ms a token over
    LM_STEPS steps (the same), tokens/s, peaks, each beside its bound."""
    b, t = prompts.shape
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        prefill = time_ms(lambda: eng.prefill(prompts), reps)
        prefill_peak = torch.cuda.max_memory_allocated() / 2**30
        with RoutingSpy(lm.moe) as spy:
            _, caches, pos = eng.prefill(prompts)
        prefill_share = lm_expert_share(cfg, spy.calls)
        with RoutingSpy(lm.moe) as spy:  # the experts a decode step reads
            lm.models.decode_step(eng.params, caches, toks[:, :1], pos, cfg, eng.rules,
                                  max_len=eng.max_len)
        decode_share = lm_expert_share(cfg, spy.calls)
        steps = min(LM_STEPS, toks.shape[1])

        def decode():
            for i in range(steps):
                lm.models.decode_step(eng.params, caches, toks[:, i:i + 1], pos + i, cfg,
                                      eng.rules, max_len=eng.max_len)

        torch.cuda.reset_peak_memory_stats()
        decode_tok = time_ms(decode, reps) / steps
        decode_peak = torch.cuda.max_memory_allocated() / 2**30
    pb, pkind = lm_prefill_bound(cfg, eng.params, prompts, prefill_share)
    db, dkind = lm_decode_bound(cfg, eng.params, caches, toks[:, :1], pos, decode_share)
    smi = out.get("smi", "")
    log(f"   {label} times ({smi}): prefill {b} x {t} {prefill:.3f} ms (bound {pb:.3f}, "
        f"{pkind}), peak {prefill_peak:.3f} GiB; decode {decode_tok:.3f} ms a step (bound "
        f"{db:.3f}, {dkind}), {b * 1e3 / decode_tok:.1f} tokens/s (bound "
        f"{b * 1e3 / db:.1f}), peak {decode_peak:.3f} GiB")
    out.update(prefill_ms=prefill, prefill_bound_ms=pb, prefill_bound_by=pkind,
               prefill_peak_gib=prefill_peak, decode_ms=decode_tok, decode_bound_ms=db,
               decode_bound_by=dkind, tokens_per_s=b * 1e3 / decode_tok,
               decode_peak_gib=decode_peak, prefill_expert_share=prefill_share,
               decode_expert_share=decode_share)
    if profile:
        def one_step():
            with torch.no_grad():
                lm.models.decode_step(eng.params, caches, toks[:, :1], pos, cfg, eng.rules,
                                      max_len=eng.max_len)
        host, busy, rows = profile_run(f"{label} decode step", one_step, steps=3)
        # the profiler slows the host's launches, so the idle share of the
        # step as timed without it is the one the users see
        log(f"   {label} decode step: device busy {busy:.3f} ms of {decode_tok:.3f} ms (CUDA "
            f"events, unprofiled): idle share {1 - busy / decode_tok:.3f}")
        out.update(profile_host_ms=host, profile_busy_ms=busy, idle_share=1 - busy / decode_tok,
                   profiled_idle_share=1 - busy / host,
                   profile_top=[(ms, count, key[:60]) for ms, count, key in rows[:8]])
    del caches


@contextlib.contextmanager
def compute_dtype(model_mod, dtype):
    """The model zoo's activation dtype (``COMPUTE_DTYPE``, bf16) set to
    ``dtype`` for the block: the same forward in f32."""
    old = model_mod.COMPUTE_DTYPE
    model_mod.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        model_mod.COMPUTE_DTYPE = old


def lm_cut(cfg):
    """One pattern repeat plus the tail, every width as published."""
    return dataclasses.replace(cfg, num_layers=len(cfg.pattern) + len(cfg.tail))


def phase_lm(lm, km, seed: int, smi: str, dev="cuda", smoke=False,
             llama=(8, 1024, 64), handoff_t=64, cpu_t=32, runs=None) -> dict:
    """Phase 17 (a)-(c): llama3.2-1b at its full config, every other
    architecture at full width and one pattern repeat, through ServeEngine."""
    out: dict = {"smi": smi}
    runs = LM_RUNS if runs is None else runs
    get = lambda arch: lm.get_config(arch, smoke=smoke)  # noqa: E731
    kernels_before = lm_kernel_launches(km)
    # (a) llama3.2-1b, full depth
    cfg = get("llama3.2-1b")
    b, t, steps = llama
    params = lm_params(lm, cfg, seed + 170, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 171)
    prompts = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev,
                            dtype=torch.int32)
    n_params = sum(x.numel() for x in lm_leaves(params))
    log(f"   (a) {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads / {cfg.num_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params:,} bf16 params ({lm_bytes(params) / 2**30:.3f} GiB)")
    a = out["llama"] = {"smi": smi}
    eng, toks = lm_check_serving(lm, cfg.name, cfg, params, prompts, steps, a)
    again = eng.generate(prompts, steps)
    require(torch.equal(again, toks), f"{cfg.name}: a second generate gave other tokens")
    log(f"   {cfg.name}: a second generate gave the same {toks.numel()} tokens bit for bit")
    # the prefill handoff against pure decode (tests/test_serve.py), 64-token prompt
    hp = prompts[:, :handoff_t]
    h_eng = lm.ServeEngine(params, cfg, max_len=2 * handoff_t)
    with torch.no_grad():
        h_last, h_caches, h_pos = h_eng.prefill(hp)
        c2 = lm.models.init_cache(cfg, b, max_len=2 * handoff_t, dtype=torch.float32, device=dev)
        for i in range(handoff_t):
            lg2, c2 = lm.models.decode_step(params, c2, hp[:, i:i + 1], i, cfg,
                                            lm.models.NO_SHARDING, max_len=2 * handoff_t)
        err1 = float((h_last.float() - lg2[:, 0].float()).abs().max())
        nxt = toks[:, :1]
        lga, _ = lm.models.decode_step(params, h_caches, nxt, h_pos, cfg,
                                       lm.models.NO_SHARDING, max_len=2 * handoff_t)
        lgb, _ = lm.models.decode_step(params, c2, nxt, h_pos, cfg, lm.models.NO_SHARDING,
                                       max_len=2 * handoff_t)
        err2 = float((lga.float() - lgb.float()).abs().max())
    log(f"   {cfg.name}: prefill handoff at a {handoff_t}-token prompt against {handoff_t} "
        f"pure decode steps: max |diff| {err1:.4g}, one step on: {err2:.4g} (bound {LM_TOL})")
    require(max(err1, err2) <= LM_TOL, f"{cfg.name}: the prefill handoff differs")
    a.update(handoff_err=max(err1, err2))
    del h_caches, c2, h_eng
    # the card against the CPU: the same bf16 params, forward of B = 1; both
    # against the same forward in f32 on the card (bf16's own noise here)
    cp = prompts[:1, :cpu_t]
    with torch.no_grad():
        on_card, _ = lm.models.forward(params, {"tokens": cp}, cfg, lm.models.NO_SHARDING,
                                       remat=False)
        t0 = time.perf_counter()
        host_params = lm_tree_map(lambda x: x.cpu(), params)
        on_host, _ = lm.models.forward(host_params, {"tokens": cp.cpu()}, cfg,
                                       lm.models.NO_SHARDING, remat=False)
        cpu_s = time.perf_counter() - t0
        del host_params
        with compute_dtype(lm.models.model, torch.float32):
            exact, _ = lm.models.forward(lm_tree_map(lambda x: x.float(), params),
                                         {"tokens": cp}, cfg, lm.models.NO_SHARDING,
                                         remat=False)
    exact, on_card, on_host = exact.float().cpu(), on_card.float().cpu(), on_host.float()
    rel = lambda x, y: float((x - y).norm() / y.norm())  # noqa: E731
    err = float((on_card - on_host).abs().max())
    rel_card, rel_host = rel(on_card, exact), rel(on_host, exact)
    log(f"   {cfg.name}: forward of 1 x {cpu_t} on the card against the CPU (same bf16 "
        f"params): max |diff| {err:.4g} (bound {LM_TOL}), relative Frobenius "
        f"{rel(on_card, on_host):.3e}; against the f32 forward: card {rel_card:.3e}, CPU "
        f"{rel_host:.3e} (bound: the card within 1.5x the CPU); max |logit| "
        f"{float(exact.abs().max()):.4g}; CPU run {cpu_s:.2f} s")
    require(err <= LM_TOL and rel_card <= 1.5 * rel_host,
            f"{cfg.name}: the card and the CPU disagree")
    a.update(cpu_err=err, cpu_rel=rel(on_card, on_host), f32_rel_card=rel_card,
             f32_rel_cpu=rel_host)
    # (c) times, the profile of 3 decode steps
    lm_times(lm, cfg.name, cfg, eng, prompts, toks, a, reps=5, profile=True)
    del eng, params
    torch.cuda.empty_cache()
    # (b) every other architecture at full width, one pattern repeat
    require(set(LM_RUNS) == set(lm.arch_ids) - {"llama3.2-1b"}, "LM_RUNS misses an architecture")
    for arch in runs:
        full = get(arch)
        cfg = lm_cut(full)
        b, t = runs[arch]
        t0 = time.perf_counter()
        params = lm_params(lm, cfg, seed + 172 + len(out), dev)
        r = out[arch] = {"smi": smi}
        log(f"   (b) {arch}: depth {full.num_layers} -> {cfg.num_layers} ({'+'.join(cfg.pattern)}"
            f"{' + ' + '+'.join(cfg.tail) if cfg.tail else ''}), d_model {cfg.d_model}, "
            f"vocab {cfg.vocab_size}, {sum(x.numel() for x in lm_leaves(params)):,} bf16 params")
        g = torch.Generator(device=dev).manual_seed(seed + 173)
        if not cfg.causal:  # hubert: an encoder, forward only
            frames = torch.randn((b, t, cfg.frontend_dim), generator=g, device=dev)
            fwd = lambda: lm.models.forward(params, {"frames": frames}, cfg,  # noqa: E731
                                            lm.models.NO_SHARDING, remat=False)[0]
            with torch.no_grad():
                torch.cuda.reset_peak_memory_stats()
                logits = fwd()
                peak = torch.cuda.max_memory_allocated() / 2**30
                require(tuple(logits.shape) == (b, t, cfg.vocab_size)
                        and bool(torch.isfinite(logits.float()).all()),
                        f"{arch}: forward gave {tuple(logits.shape)} or non-finite logits")
                ms = time_ms(fwd, 3)
            pb, kind = lm_prefill_bound(cfg, params, frames)
            log(f"   {arch}: forward of {b} x {t} frames: {ms:.3f} ms (bound {pb:.3f}, {kind}), "
                f"peak {peak:.3f} GiB, max |logit| {float(logits.float().abs().max()):.4g} ({smi})")
            r.update(prefill_ms=ms, prefill_bound_ms=pb, prefill_bound_by=kind,
                     prefill_peak_gib=peak)
        else:
            prompts = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev,
                                    dtype=torch.int32)
            eng, toks = lm_check_serving(lm, arch, cfg, params, prompts, LM_STEPS, r,
                                         moe="moe" in cfg.pattern)
            if cfg.window is not None:
                local = [i for i, k in enumerate(cfg.pattern) if k == "local"]
                s = lm.cache_len(cfg, "local", eng.max_len)
                log(f"   {arch}: local layers at pattern positions {local} decode from ring "
                    f"caches of {s} slots ({t}-token prompt, max_len {eng.max_len})")
                require(s == cfg.window < t, f"{arch}: the prompt does not pass the window")
            if cfg.frontend == "vision":
                patches = torch.randn((b, cfg.num_patches, cfg.frontend_dim), generator=g,
                                      device=dev)
                with torch.no_grad():
                    logits, _ = lm.models.forward(params, {"tokens": prompts, "patches": patches},
                                                  cfg, lm.models.NO_SHARDING, remat=False)
                require(tuple(logits.shape) == (b, t, cfg.vocab_size)
                        and bool(torch.isfinite(logits.float()).all()),
                        f"{arch}: forward with patches failed")
                log(f"   {arch}: forward with {cfg.num_patches} patches of {cfg.frontend_dim} "
                    f"in a {t}-token prompt: finite, max |logit| "
                    f"{float(logits.float().abs().max()):.4g}")
                del logits
            lm_times(lm, arch, cfg, eng, prompts, toks, r, reps=3)
            del eng
        log(f"   {arch}: {time.perf_counter() - t0:.2f} s")
        del params
        torch.cuda.empty_cache()
    after = lm_kernel_launches(km)
    require(after == kernels_before, f"the LM path launched a hand-written kernel: "
                                     f"{kernels_before} -> {after}")
    log("   kernel launches across phase 17: none (every launch counter as before), as "
        "the reference's models call none of K1-K8")
    return out


def lm_kernel_launches(km) -> dict:
    counts = read_launches(km)
    counts.update(read_new_launches(km))
    counts.update(segsum_reuse_batched=km.seg.BATCHED_LAUNCHES,
                  lp_reuse_batched=km.lp.BATCHED_LAUNCHES)
    return counts


# ---------------------------------------------------------------------------
# Phase 18: the LM substrate's training path (repro_torch.train, data, ckpt,
# launch/train.py) in plain torch with autograd, as the reference's models
# call none of K1-K8 and none has a backward kernel
# ---------------------------------------------------------------------------

# (d)'s runs: architecture -> (batch, tokens); phi-3-vision's 576 patches
# need more than 512 tokens, hubert takes 1,024 frames
TRAIN_RUNS = {"gemma2-9b": (2, 512), "recurrentgemma-9b": (2, 512), "mamba2-2.7b": (2, 512),
              "qwen2-7b": (2, 512), "codeqwen1.5-7b": (2, 512), "qwen3-moe-30b-a3b": (2, 512),
              "qwen3-moe-235b-a22b": (2, 512), "phi-3-vision-4.2b": (2, 1024),
              "hubert-xlarge": (2, 1024)}
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def timed_call(fn) -> tuple:
    """(fn(), device ms between CUDA events around the call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block (the embedding's
    backward then sorts instead of adding with atomics). ``warn_only``: an
    op with no deterministic version warns, and the warnings are logged."""
    import warnings
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        for w in {str(w.message).split("\n")[0] for w in caught}:
            log(f"      deterministic mode warned: {w[:160]}")
    finally:
        torch.use_deterministic_algorithms(was)


def train_profile(label: str, fn) -> dict:
    """One call of ``fn`` (a training step) under torch.profiler after a
    traced warm-up: the host interval, the device's busy time (kernels and
    copies) and idle share, the top kernels, and the GEMMs' device time by
    kernel: f32 ("f32f32" or "sgemm" in the name: the blockwise attention's
    einsums) and the rest (tensor-core bf16: the blocks' and the head's
    matmuls); also by op (aten mm/addmm against bmm/baddbmm, with the input
    dtype where the profiler records it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")), reverse=True)
    busy = sum(r[0] for r in rows)
    gemm = {"bf16": 0.0, "f32": 0.0}
    for ms, _, key in rows:
        if any(w in key for w in ("gemm", "nvjet", "xmma", "cutlass")):
            gemm["f32" if ("f32f32" in key or "sgemm" in key) else "bf16"] += ms
    by_op = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in GEMM_OPS:
            dts = getattr(e, "input_dtypes", None) or []
            kind = e.name.split("::")[1] + (f" {dts[0]}" if dts and dts[0] else "")
            by_op[kind] = by_op.get(kind, 0.0) + e.device_time_total / 1e3
    log(f"   {label}: host {host:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / host:.3f} (torch.profiler, one step)")
    log(f"      GEMM kernels: tensor-core (bf16) {gemm['bf16']:.3f} ms, f32 {gemm['f32']:.3f} ms; "
        f"GEMM ops: " + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_op.items())))
    for ms, count, key in rows[:12]:
        log(f"      {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return {"host_ms": host, "busy_ms": busy, "gemm_ms": gemm, "gemm_ops_ms": by_op,
            "top": [(ms, count, key[:60]) for ms, count, key in rows[:12]]}


def train_leaves_moved(tr, before, params) -> list:
    """Leaf paths whose sampled elements (every ``stride``-th, up to 65,536
    of a leaf, as ``train_samples`` took them) all kept their values."""
    still = []
    for (path, leaf), (stride, was) in zip(tr.tree.leaves_with_path(params), before):
        if torch.equal(leaf.detach().reshape(-1)[::stride], was):
            still.append("/".join(path))
    return still


def train_samples(tr, params) -> list:
    out = []
    for leaf in tr.tree.leaves(params):
        stride = max(1, leaf.numel() // 65536)
        out.append((stride, leaf.detach().reshape(-1)[::stride].clone()))
    return out


def tree_rel(tr, got, want) -> float:
    """Relative Frobenius distance of two trees, over all their leaves,
    computed where ``want`` lives (the card, for the CPU's step too)."""
    num = den = 0.0
    for a, b in zip(tr.tree.leaves(got), tr.tree.leaves(want)):
        a = a.to(b.device)
        num += float(torch.sum(torch.square(a.double() - b.double())))
        den += float(torch.sum(torch.square(b.double())))
    return math.sqrt(num / den)


def train_updates(tr, new, old) -> list:
    """new - old, leaf for leaf: a step's update."""
    return [x - y for x, y in zip(tr.tree.leaves(new), tr.tree.leaves(old))]


def train_one(lm, tr, cfg, params, batch, opt_cfg=None):
    """(loss, grads, updated params) of one step from ``params`` (cloned,
    with a fresh optimizer state): the grads from ``loss_and_grads``, then
    ``adamw_update`` (what ``train_step`` runs, split to keep the grads)."""
    loss, grads = tr.step.loss_and_grads(params, batch, cfg, lm.models.NO_SHARDING)
    p = tr.tree.tree_map(torch.clone, params)
    p, _, _ = tr.train.adamw_update(grads, tr.train.adamw_init(p), p,
                                    opt_cfg or tr.train.AdamWConfig(lr=1e-3, warmup_steps=2))
    return float(loss), grads, p


def phase_train_llama(lm, tr, seed: int, smi: str, dev, smoke, b, t, steps, cpu_t, out):
    """(a) and (b): llama3.2-1b at its full config, f32 params."""
    cfg = lm.get_config("llama3.2-1b", smoke=smoke)
    fresh = lambda: lm_params(lm, cfg, seed + 180, dev, dtype=torch.float32)  # noqa: E731
    params = fresh()
    n = sum(x.numel() for x in lm_leaves(params))
    data = tr.data.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                                      seed=0, device=dev)
    batch = data.get_batch(0)
    require(batch["tokens"].dtype == torch.int32 and tuple(batch["tokens"].shape) == (b, t),
            "the dataset gave another batch")
    log(f"   (a) {cfg.name}: {cfg.num_layers} layers, {n:,} f32 params, state (params, grads, "
        f"two moments) {16 * n / 1e9:.3f} GB; SyntheticLMDataset(seed=0) batch 0 of {b} x {t}, "
        f"repeated; AdamWConfig(lr=1e-3, warmup_steps=2)")
    opt_cfg = tr.train.AdamWConfig(lr=1e-3, warmup_steps=2)
    step_fn = tr.train.make_train_step(cfg, lm.models.NO_SHARDING, opt_cfg)
    opt = tr.train.adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        (params, opt, m), dt = timed_call(lambda: step_fn(params, opt, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(dt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"   {cfg.name}: losses {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"   {cfg.name}: grad norms {', '.join(f'{x:.4f}' for x in norms)}")
    log(f"   {cfg.name}: step ms {', '.join(f'{x:.3f}' for x in ms)} (CUDA events; the first "
        f"one pays the card's and cuBLAS's warm-up)")
    require(all(math.isfinite(x) for x in losses + norms), f"{cfg.name}: a non-finite loss or norm")
    require(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    require(int(opt.step) == steps, f"{cfg.name}: opt_state.step is {int(opt.step)}, not {steps}")
    a = out["llama"] = {"smi": smi, "losses": losses, "grad_norms": norms, "step_ms_all": ms,
                        "params": n, "batch": [b, t]}
    step_ms = statistics.median(ms[2:]) if len(ms) > 2 else statistics.median(ms)
    bound, kind, parts = lm_train_bound(cfg, params, b, t)
    a.update(step_ms=step_ms, tokens_per_s=b * t * 1e3 / step_ms, peak_gib=peak, bound_ms=bound,
             bound_by=kind, bound_parts=parts)
    log(f"   (b) {cfg.name} times ({smi}): step {step_ms:.3f} ms (median of steps 3-{steps}), "
        f"{b * t * 1e3 / step_ms:.1f} tokens/s; bound {bound:.3f} ms ({kind}: bf16 GEMMs "
        f"{parts['bf16_tflop']:.2f} TFLOP {parts['bf16_gemm_ms']:.3f} ms, f32 attention "
        f"{parts['f32_attention_tflop']:.3f} TFLOP {parts['f32_attention_ms']:.3f} ms, AdamW "
        f"{parts['adamw_ms']:.3f} ms), {bound / step_ms:.3f} of it; peak {peak:.3f} GiB")
    # (b) where the time goes: the loss and the update alone, then a profile
    logits = torch.randn((b, t, cfg.vocab_size), device=dev).to(torch.bfloat16).requires_grad_(True)

    def loss_alone():
        loss = tr.train.cross_entropy_loss(logits, batch["labels"])
        return torch.autograd.grad(loss, logits)

    a["loss_ms"] = time_ms(loss_alone, 3)
    del logits
    grads = tr.tree.tree_map(lambda p: torch.full_like(p, 1e-3), params)
    a["adamw_ms"] = time_ms(lambda: tr.train.adamw_update(grads, opt, params, opt_cfg), 3)
    del grads
    log(f"   {cfg.name}: alone, the loss forward + backward at ({b}, {t}, {cfg.vocab_size}) "
        f"{a['loss_ms']:.3f} ms, the AdamW update {a['adamw_ms']:.3f} ms (bound "
        f"{parts['adamw_ms']:.3f}) (CUDA events, medians of 3)")
    prof = train_profile(f"{cfg.name} training step", lambda: step_fn(params, opt, batch))
    a["profile"] = prof
    a["idle_share"] = 1 - prof["busy_ms"] / step_ms
    gemm = prof["gemm_ms"]
    rest = prof["busy_ms"] - sum(gemm.values()) - a["loss_ms"] - a["adamw_ms"]
    log(f"   {cfg.name} step split ({smi}): bf16 GEMMs {gemm.get('bf16', 0.0):.3f} ms, f32 "
        f"attention GEMMs {gemm.get('f32', 0.0):.3f} ms, loss {a['loss_ms']:.3f} ms, AdamW "
        f"{a['adamw_ms']:.3f} ms, the rest (elementwise, norms, softmax, copies) {rest:.3f} ms "
        f"of {prof['busy_ms']:.3f} ms busy; idle share {a['idle_share']:.3f} of the "
        f"unprofiled {step_ms:.3f} ms step")
    a["rest_ms"] = rest
    del params, opt
    torch.cuda.empty_cache()
    # (a) microbatches: 2 against 1 from one fresh state, the reference's bar
    results = []
    for nmb in (1, 2):
        p = fresh()
        p, _, m = tr.train.make_train_step(cfg, lm.models.NO_SHARDING, tr.train.AdamWConfig(),
                                           num_microbatches=nmb)(p, tr.train.adamw_init(p), batch)
        results.append((float(m["loss"]), float(m["grad_norm"]), tr.tree.leaves(p)[0].clone()))
        del p
        torch.cuda.empty_cache()
    (l1, g1, f1), (l2, g2, f2) = results
    leaf_err = float((f2 - f1).abs().max())
    log(f"   {cfg.name}: num_microbatches=2 against 1 (AdamWConfig()): loss {l2:.6f} / {l1:.6f}, "
        f"grad norm {g2:.6f} / {g1:.6f}, first leaf max |diff| {leaf_err:.3e} (bars: loss rtol "
        f"1e-2, first leaf rtol 1e-2 atol 1e-4)")
    require(abs(l2 - l1) <= 1e-2 * abs(l1), f"{cfg.name}: microbatched loss differs")
    require(bool(torch.allclose(f2, f1, rtol=1e-2, atol=1e-4)),
            f"{cfg.name}: microbatched first leaf differs")
    a.update(mb_loss=(l1, l2), mb_grad_norm=(g1, g2), mb_leaf_err=leaf_err)
    # (a) the card against the CPU: one step at 1 x cpu_t from the same
    # params, both against the same step in f32 on the card
    small = {k: v[:1, :cpu_t] for k, v in batch.items()}
    params = fresh()
    with compute_dtype(lm.models.model, torch.float32):
        _, g_f32, p_f32 = train_one(lm, tr, cfg, params, small)
    _, g_card, p_card = train_one(lm, tr, cfg, params, small)
    rel_g_card, rel_p_card = tree_rel(tr, g_card, g_f32), tree_rel(tr, p_card, p_f32)
    upd_f32 = train_updates(tr, p_f32, params)
    upd_card = tree_rel(tr, train_updates(tr, p_card, params), upd_f32)
    del g_card, p_card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = tr.tree.tree_map(lambda x: x.cpu(), params)
    _, g_cpu, p_cpu = train_one(lm, tr, cfg, host, {k: v.cpu() for k, v in small.items()})
    cpu_s = time.perf_counter() - t0
    rel_g_cpu, rel_p_cpu = tree_rel(tr, g_cpu, g_f32), tree_rel(tr, p_cpu, p_f32)
    upd_cpu = tree_rel(tr, train_updates(tr, p_cpu, host), upd_f32)
    log(f"   {cfg.name}: one step at 1 x {cpu_t} against the same step with f32 activations on "
        f"the card, relative Frobenius: grads card {rel_g_card:.3e}, CPU {rel_g_cpu:.3e}; updated "
        f"params card {rel_p_card:.3e}, CPU {rel_p_cpu:.3e} (the update alone: card "
        f"{upd_card:.3e}, CPU {upd_cpu:.3e}); bound: the card within 1.5x the CPU; CPU step "
        f"{cpu_s:.2f} s")
    require(rel_g_card <= 1.5 * rel_g_cpu and rel_p_card <= 1.5 * rel_p_cpu,
            f"{cfg.name}: the card's step is further from the f32 step than 1.5x the CPU's")
    a.update(f32_grad_rel_card=rel_g_card, f32_grad_rel_cpu=rel_g_cpu,
             f32_param_rel_card=rel_p_card, f32_param_rel_cpu=rel_p_cpu,
             f32_update_rel_card=upd_card, f32_update_rel_cpu=upd_cpu, cpu_step_s=cpu_s)
    del g_f32, p_f32, upd_f32, g_cpu, p_cpu, host, params
    torch.cuda.empty_cache()


def phase_train_resume(lm, tr, seed: int, dev, smoke, b, t, root: Path, out):
    """(c): checkpoint and resume at llama3.2-1b's width, one layer."""
    cfg = lm_cut(lm.get_config("llama3.2-1b", smoke=smoke))
    data = tr.data.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                                      seed=0, device=dev)
    step_fn = tr.train.make_train_step(cfg, lm.models.NO_SHARDING,
                                       tr.train.AdamWConfig(lr=1e-3, warmup_steps=2))
    ckpt_dir = root / "build" / "chip_smoke_ckpt"
    if ckpt_dir.exists():
        import shutil
        shutil.rmtree(ckpt_dir)
    c = out["resume"] = {}
    with deterministic():
        pa = lm_params(lm, cfg, seed + 181, dev, dtype=torch.float32)
        oa = tr.train.adamw_init(pa)
        for s in range(4):
            pa, oa, _ = step_fn(pa, oa, data.get_batch(s))
        pb = lm_params(lm, cfg, seed + 181, dev, dtype=torch.float32)
        ob = tr.train.adamw_init(pb)
        for s in range(2):
            pb, ob, _ = step_fn(pb, ob, data.get_batch(s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = tr.ckpt.save(str(ckpt_dir), 2, (pb, ob), extra={"arch": cfg.name})
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        like = tr.tree.tree_map(torch.empty_like, (pb, ob))
        t0 = time.perf_counter()
        (pr, orr), manifest = tr.ckpt.restore(str(ckpt_dir), tr.ckpt.latest_step(str(ckpt_dir)), like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del like
        same = all(torch.equal(x, y) and x.dtype == y.dtype and x.device == y.device
                   for x, y in zip(tr.tree.leaves((pr, orr)), tr.tree.leaves((pb, ob))))
        require(same and manifest["step"] == 2, "the restored state is not what was saved")
        del pb, ob
        for s in range(2, 4):
            pr, orr, _ = step_fn(pr, orr, data.get_batch(s))
        diff = max(float((x - y).abs().max()) for x, y in zip(tr.tree.leaves((pr, orr.mu, orr.nu)),
                                                               tr.tree.leaves((pa, oa.mu, oa.nu))))
        bitwise = all(torch.equal(x, y) for x, y in zip(tr.tree.leaves((pr, orr)),
                                                        tr.tree.leaves((pa, oa))))
    n = sum(x.numel() for x in lm_leaves(pa))
    log(f"   (c) {cfg.name} cut to {cfg.num_layers} layer ({n:,} f32 params), {b} x {t}: 4 steps "
        f"straight against 2 + save + restore + 2, under deterministic algorithms: the restored "
        f"state bitwise what was saved; resumed against straight: max |diff| {diff:.3e}, "
        f"bitwise {bitwise}")
    log(f"   (c) checkpoint of params + state: {nbytes / 1e9:.3f} GB in "
        f"{len(manifest['leaves'])} leaves, save {save_s:.3f} s ({nbytes / 1e9 / save_s:.3f} GB/s), "
        f"restore {restore_s:.3f} s ({nbytes / 1e9 / restore_s:.3f} GB/s)")
    require(bitwise, f"{cfg.name}: the resumed run differs from the straight run by {diff:.3e}")
    import shutil
    shutil.rmtree(ckpt_dir)
    c.update(resume_diff=diff, bitwise=bitwise, ckpt_bytes=nbytes, save_s=save_s,
             restore_s=restore_s, leaves=len(manifest["leaves"]))
    del pa, oa, pr, orr
    torch.cuda.empty_cache()


def train_arch(lm, tr, cfg, b, t, seed: int, dev, dtype, g) -> dict:
    """Two steps of ``make_train_step`` at B x T from ``lm_params`` in
    ``dtype``: the losses, grad norms, step ms, peak memory and the leaves
    that did not move."""
    params = lm_params(lm, cfg, seed, dev, dtype=dtype)
    if cfg.frontend == "audio":
        frames = torch.randn((b, t, cfg.frontend_dim), generator=g, device=dev)
        batch = tr.data.make_labels({"frames": frames})
    else:
        batch = tr.data.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                                           seed=0, device=dev).get_batch(0)
        if cfg.frontend == "vision":
            batch["patches"] = torch.randn((b, cfg.num_patches, cfg.frontend_dim), generator=g,
                                           device=dev)
    before = train_samples(tr, params)
    step_fn = tr.train.make_train_step(cfg, lm.models.NO_SHARDING,
                                       tr.train.AdamWConfig(lr=1e-3, warmup_steps=2))
    opt = tr.train.adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = {"losses": [], "grad_norms": [], "step_ms": [], "params": sum(
        x.numel() for x in lm_leaves(params)), "dtype": str(dtype).split(".")[-1]}
    for _ in range(2):
        (params, opt, m), dt = timed_call(lambda: step_fn(params, opt, batch))
        r["losses"].append(float(m["loss"]))
        r["grad_norms"].append(float(m["grad_norm"]))
        r["step_ms"].append(dt)
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["still"] = train_leaves_moved(tr, before, params)
    r["leaves"] = len(before)
    return r


def phase_train_archs(lm, tr, seed: int, smi: str, dev, smoke, runs, out):
    """(d): every other architecture at full width, one pattern repeat."""
    for i, arch in enumerate(runs):
        full = lm.get_config(arch, smoke=smoke)
        cfg = lm_cut(full)
        b, t = runs[arch]
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(seed + 183)
        r = train_arch(lm, tr, cfg, b, t, seed + 182 + i, dev, torch.float32, g)
        out[arch] = dict(r, smi=smi, batch=[b, t])
        log(f"   (d) {arch}: depth {full.num_layers} -> {cfg.num_layers}, {r['params']:,} "
            f"{r['dtype']} params, {b} x {t}: losses {r['losses'][0]:.4f}, {r['losses'][1]:.4f}; "
            f"grad norms {r['grad_norms'][0]:.4f}, {r['grad_norms'][1]:.4f}; step ms "
            f"{r['step_ms'][0]:.3f}, {r['step_ms'][1]:.3f}; peak {r['peak_gib']:.3f} GiB; "
            f"{r['leaves'] - len(r['still'])} of {r['leaves']} leaves moved; "
            f"{time.perf_counter() - t0:.2f} s")
        require(all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]),
                f"{arch}: a non-finite loss or grad norm")
        require(not r["still"], f"{arch}: leaves that did not move: {r['still']}")
        torch.cuda.empty_cache()


def phase_train_launcher(root: Path, out, steps=(20, 30), batch=8, seq=128, every=10,
                         extra=()):
    """(e): ``python -m repro_torch.launch.train`` twice in a subprocess; the
    second run resumes from the first one's last checkpoint."""
    import os
    import shutil
    ckpt_dir = root / "build" / "chip_smoke_launch"
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = []
    for n in steps:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
               "--smoke", "--steps", str(n), "--batch", str(batch), "--seq", str(seq),
               "--ckpt-every", str(every), "--ckpt-dir", str(ckpt_dir), *extra]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(root),
                             timeout=300)
        wall = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        log(f"   (e) launcher --steps {n}: exit {res.returncode}, {wall:.2f} s; "
            + " | ".join(lines[-4:]))
        require(res.returncode == 0 and lines and lines[-1] == "done",
                f"the launcher failed: {res.stderr[-2000:]}")
        runs.append((lines, wall))
    require(f"resumed from step {steps[0]}" in runs[1][0],
            f"the second launcher run did not resume from step {steps[0]}")
    last = sorted(p.name for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    require(last[-1] == f"step_{steps[1]:08d}", f"the launcher left checkpoints {last}")
    shutil.rmtree(ckpt_dir)
    out["launcher"] = {"wall_s": [w for _, w in runs], "log": [ls[-4:] for ls, _ in runs]}


def phase_train(lm, tr, km, seed: int, smi: str, root: Path, dev="cuda", smoke=False,
                llama=(8, 1024), steps=8, cpu_t=32, resume=(2, 256), runs=None,
                launcher=None) -> dict:
    """Phase 18 (a)-(e): the training path, as the module docstring says."""
    out: dict = {"smi": smi}
    kernels_before = lm_kernel_launches(km)
    t0 = time.perf_counter()
    phase_train_llama(lm, tr, seed, smi, dev, smoke, *llama, steps, cpu_t, out)
    log(f"   (a)-(b): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_train_resume(lm, tr, seed, dev, smoke, *resume, root, out)
    log(f"   (c): {time.perf_counter() - t0:.2f} s")
    runs = TRAIN_RUNS if runs is None else runs
    require(set(TRAIN_RUNS) == set(lm.arch_ids) - {"llama3.2-1b"},
            "TRAIN_RUNS misses an architecture")
    t0 = time.perf_counter()
    phase_train_archs(lm, tr, seed, smi, dev, smoke, runs, out)
    log(f"   (d): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_train_launcher(root, out, **(launcher or {}))
    log(f"   (e): {time.perf_counter() - t0:.2f} s")
    after = lm_kernel_launches(km)
    require(after == kernels_before, f"the training path launched a hand-written kernel: "
                                     f"{kernels_before} -> {after}")
    log("   kernel launches across phase 18: none (every launch counter as before), as "
        "the reference's models call none of K1-K8 and no kernel has a backward")
    return out


# ---------------------------------------------------------------------------
# Phase 19: the LM substrate's 2-D data x model mesh on a (1, 1) mesh at
# world size 1 (NCCL puts one rank on a card): the mesh path at full width
# ---------------------------------------------------------------------------

MESH_RTOL = 1e-6  # the (1, 1) mesh against NO_SHARDING: bitwise, or within this relative


@contextlib.contextmanager
def mesh_group(root: Path, dev):
    """A world-size-1 process group for the block (NCCL on the card, gloo on
    the CPU) through a file:// rendezvous under build/."""
    import os

    import torch.distributed as tdist

    rendezvous = root / "build" / "chip_smoke_mesh_rendezvous"
    rendezvous.parent.mkdir(parents=True, exist_ok=True)
    rendezvous.unlink(missing_ok=True)
    backend = "nccl" if dev == "cuda" else "gloo"
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: loopback only
    tdist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=0, world_size=1)
    try:
        yield backend
    finally:
        tdist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)


def mesh_agree(ms, tr, name, got, want) -> tuple:
    """(bitwise, worst relative max |diff|) of two trees (DTensors taken
    whole); fails past MESH_RTOL."""
    same, worst = True, 0.0
    for a, b in zip(tr.tree.leaves(got), tr.tree.leaves(want)):
        a, b = ms.compat.whole(a), ms.compat.whole(b)
        require(a.shape == b.shape and a.dtype == b.dtype, f"{name}: {a.shape} {a.dtype} against "
                                                           f"{b.shape} {b.dtype}")
        if not torch.equal(a, b):
            same = False
            scale = max(float(b.double().abs().max()), 1e-30)
            worst = max(worst, float((a.double() - b.double()).abs().max()) / scale)
    require(worst <= MESH_RTOL, f"{name}: the mesh differs from NO_SHARDING by {worst:.3e} "
                                f"relative (bound {MESH_RTOL})")
    return same, worst


def mesh_state(lm, tr, ms, cfg, rules, mesh, params):
    """``params`` placed by param_shardings, moments by zero1_shardings
    (placements checked); returns (params, opt state, moment specs)."""
    specs = lm.models.param_shardings(cfg, rules)
    zero1 = tr.train.zero1_shardings(specs, rules.dp_axes, mesh.shape,
                                     lm.models.param_specs(cfg, rules))
    placed = lm.models.place(params, specs, mesh)
    opt = tr.train.adamw_init(placed, mesh, zero1)
    want = [mesh.placements(z) for z in lm_leaves_specs(tr, zero1, params)]
    got = [tuple(m.placements) for m in tr.tree.leaves(opt.mu)]
    require(got == want, "the moments are not at zero1_shardings' placements")
    return placed, opt, zero1


def lm_leaves_specs(tr, specs, like) -> list:
    out = []
    tr.tree.map_specs(lambda spec, _: out.append(spec), specs, like)
    return out


def phase_mesh_llama(lm, tr, ms, mesh, rules, seed: int, smi: str, dev, smoke, b, t, steps,
                     serve, plain_ms_18, out):
    """(a) and (d): llama3.2-1b at its full config through the mesh."""
    cfg = lm.get_config("llama3.2-1b", smoke=smoke)
    no = lm.models.NO_SHARDING
    fresh = lambda: lm_params(lm, cfg, seed + 190, dev, dtype=torch.float32)  # noqa: E731
    batch = tr.data.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                                       seed=0, device=dev).get_batch(0)
    a = out["llama"] = {"smi": smi, "batch": [b, t]}
    params = fresh()
    with torch.no_grad():
        want, _ = lm.models.forward(params, {"tokens": batch["tokens"]}, cfg, no, remat=False)
        placed = lm.models.place(params, lm.models.param_shardings(cfg, rules), mesh)
        got, _ = lm.models.forward(placed, {"tokens": batch["tokens"]}, cfg, rules, mesh=mesh,
                                   remat=False)
    require(isinstance(got, ms.DTensor), "forward on the mesh did not give a DTensor")
    same, worst = mesh_agree(ms, tr, "(a) forward logits", got, want)
    a["forward"] = {"bitwise": same, "rel": worst}
    log(f"   (a) {cfg.name}, {b} x {t}, f32 params placed by param_shardings on {mesh}: forward "
        f"logits {tuple(want.shape)} against NO_SHARDING: bitwise {same}, relative {worst:.3e}")
    del want, got, placed, params
    torch.cuda.empty_cache()
    opt_cfg = tr.train.AdamWConfig(lr=1e-3, warmup_steps=2)
    runs = {}
    for label in ("plain", "mesh"):
        params = fresh()
        if label == "plain":
            opt = tr.train.adamw_init(params)
            step_fn = tr.train.make_train_step(cfg, no, opt_cfg)
        else:
            params, opt, _ = mesh_state(lm, tr, ms, cfg, rules, mesh, params)
            step_fn = tr.train.make_train_step(cfg, rules, opt_cfg, mesh=mesh)
        losses, norms, ms_all = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # this run's state, and what earlier runs keep
        for _ in range(steps):
            (params, opt, m), dt = timed_call(lambda: step_fn(params, opt, batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms_all.append(dt)
        peak = torch.cuda.max_memory_allocated()
        runs[label] = {"losses": losses, "grad_norms": norms, "step_ms_all": ms_all,
                       "step_ms": statistics.median(ms_all[1:]), "peak_gib": peak / 2**30,
                       "held_gib": held / 2**30, "peak_above_held_gib": (peak - held) / 2**30}
        kept = ""
        if label == "mesh":  # the plain run's params stay alive for the comparison below
            kept = sum(x.numel() * x.element_size() for x in lm_leaves(plain_params))
            runs[label]["plain_params_kept_gib"] = kept / 2**30
            kept = f", of it the plain run's params kept {kept / 2**30:.3f} GiB"
        log(f"   (a) {label}: losses {', '.join(f'{x:.6f}' for x in losses)}; grad norms "
            f"{', '.join(f'{x:.6f}' for x in norms)}; step ms "
            f"{', '.join(f'{x:.3f}' for x in ms_all)}; peak "
            f"{runs[label]['peak_gib']:.3f} GiB: held at the first step "
            f"{held / 2**30:.3f} GiB{kept}, peak above it "
            f"{runs[label]['peak_above_held_gib']:.3f} GiB")
        if label == "plain":
            plain_params = params
            del opt
        else:
            mesh_params, mesh_opt, mesh_step = params, opt, step_fn
        del params
        torch.cuda.empty_cache()
    same, worst = mesh_agree(ms, tr, "(a) train params", mesh_params, plain_params)
    for key in ("losses", "grad_norms"):
        for x, y in zip(runs["mesh"][key], runs["plain"][key]):
            require(abs(x - y) <= MESH_RTOL * abs(y), f"(a) {key}: {x} on the mesh, {y} plain")
    a["train"] = {"bitwise": same, "rel": worst, "runs": runs,
                  "losses_equal": runs["mesh"]["losses"] == runs["plain"]["losses"]}
    log(f"   (a) {steps} train steps, ZeRO-1 moments at zero1_shardings: params after them "
        f"against NO_SHARDING bitwise {same}, relative {worst:.3e}; losses equal "
        f"{a['train']['losses_equal']}")
    del plain_params
    torch.cuda.empty_cache()
    # (d) DTensor's host cost: the step through the mesh against the plain one
    mesh_ms, plain_ms = runs["mesh"]["step_ms"], runs["plain"]["step_ms"]
    prof = train_profile(f"{cfg.name} training step on the mesh",
                         lambda: mesh_step(mesh_params, mesh_opt, batch))
    idle = 1 - prof["busy_ms"] / mesh_ms
    a["times"] = {"mesh_step_ms": mesh_ms, "plain_step_ms": plain_ms,
                  "phase18_step_ms": plain_ms_18, "mesh_busy_ms": prof["busy_ms"],
                  "mesh_profiled_host_ms": prof["host_ms"], "mesh_idle_share": idle,
                  "tokens_per_s": b * t * 1e3 / mesh_ms}
    p18 = f"{plain_ms_18:.3f}" if plain_ms_18 is not None else "not run"
    log(f"   (d) {cfg.name} step ({smi}): through the mesh {mesh_ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms (medians of steps 2-{steps}, CUDA events; phase 18's plain step {p18} ms), "
        f"{mesh_ms / plain_ms:.3f}x; the mesh step's device busy {prof['busy_ms']:.3f} ms, idle "
        f"share {idle:.3f} of the unprofiled step")
    del mesh_params, mesh_opt, mesh_step
    torch.cuda.empty_cache()
    # (a) the engine on the mesh: decode rules, cache_shardings, greedy tokens
    nb, nt, nsteps = serve
    bf = lm_params(lm, cfg, seed + 191, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 192)
    prompts = torch.randint(0, cfg.vocab_size, (nb, nt), generator=g, device=dev,
                            dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = lm.ServeEngine(bf, cfg, max_len=nt + nsteps).generate(prompts, nsteps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    dec = dataclasses.replace(rules, decode=True)
    eng = lm.ServeEngine(lm.models.place(bf, lm.models.param_shardings(cfg, dec), mesh), cfg,
                         rules=dec, mesh=mesh, max_len=nt + nsteps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng.generate(prompts, nsteps)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    require(not isinstance(got, ms.DTensor) and torch.equal(got, want),
            "(a) ServeEngine on the mesh gave other tokens than without it")
    a["serve"] = {"tokens_equal": True, "generate_s": gen_s, "plain_generate_s": plain_s,
                  "shape": [nb, nt, nsteps]}
    log(f"   (a) ServeEngine(mesh=, decode rules, cache_shardings), bf16 params: {nb} x {nt} "
        f"prompt tokens, {nsteps} greedy steps: the same tokens as without the mesh; generate "
        f"{gen_s:.3f} s on the mesh, {plain_s:.3f} s without it (host clock, each engine's "
        f"first call)")
    del bf, eng, want, got
    torch.cuda.empty_cache()


def phase_mesh_moe(lm, tr, ms, mesh, rules, seed: int, dev, smoke, b, t, out):
    """(b): qwen3-moe-30b-a3b at full width, one repeat, through local_map."""
    cfg = lm_cut(lm.get_config("qwen3-moe-30b-a3b", smoke=smoke))
    no = lm.models.NO_SHARDING
    fresh = lambda: lm_params(lm, cfg, seed + 193, dev, dtype=torch.float32)  # noqa: E731
    batch = tr.data.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                                       seed=1, device=dev).get_batch(0)
    calls = [0]
    real = lm.moe.local_map

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    params = fresh()
    with torch.no_grad():
        want, _ = lm.models.forward(params, {"tokens": batch["tokens"]}, cfg, no, remat=False)
        placed = lm.models.place(params, lm.models.param_shardings(cfg, rules), mesh)
        lm.moe.local_map = counted
        try:
            got, _ = lm.models.forward(placed, {"tokens": batch["tokens"]}, cfg, rules, mesh=mesh,
                                       remat=False)
        finally:
            lm.moe.local_map = real
    fwd_calls = calls[0]
    require(fwd_calls == cfg.num_layers, f"(b) local_map ran {fwd_calls} times in "
                                         f"{cfg.num_layers} MoE layers")
    f_same, f_worst = mesh_agree(ms, tr, "(b) forward logits", got, want)
    del want, got, placed, params
    torch.cuda.empty_cache()
    opt_cfg = tr.train.AdamWConfig(lr=1e-3, warmup_steps=2)
    p1 = fresh()
    p1, _, m1 = tr.train.make_train_step(cfg, no, opt_cfg)(p1, tr.train.adamw_init(p1), batch)
    p2, o2, _ = mesh_state(lm, tr, ms, cfg, rules, mesh, fresh())
    lm.moe.local_map = counted
    try:
        p2, o2, m2 = tr.train.make_train_step(cfg, rules, opt_cfg, mesh=mesh)(p2, o2, batch)
    finally:
        lm.moe.local_map = real
    require(calls[0] > fwd_calls, "(b) the train step on the mesh did not run local_map")
    require(abs(float(m2["loss"]) - float(m1["loss"])) <= MESH_RTOL * abs(float(m1["loss"])),
            f"(b) loss {float(m2['loss'])} on the mesh, {float(m1['loss'])} plain")
    t_same, t_worst = mesh_agree(ms, tr, "(b) train params", p2, p1)
    n = sum(x.numel() for x in lm_leaves(p1))
    out["moe"] = {"forward": {"bitwise": f_same, "rel": f_worst},
                  "train": {"bitwise": t_same, "rel": t_worst, "loss": float(m2["loss"])},
                  "local_map_calls": calls[0], "params": n, "batch": [b, t]}
    log(f"   (b) {cfg.name} cut to {cfg.num_layers} layer ({n:,} f32 params), {b} x {t}, "
        f"through local_map ({calls[0]} calls: {fwd_calls} forward, the rest the step's "
        f"forward and recompute): forward logits bitwise {f_same} (relative {f_worst:.3e}); "
        f"one train step: loss {float(m2['loss']):.6f} / {float(m1['loss']):.6f}, params "
        f"bitwise {t_same} (relative {t_worst:.3e})")
    del p1, p2, o2
    torch.cuda.empty_cache()


def phase_mesh_restore(lm, tr, ms, mesh, rules, seed: int, dev, smoke, b, t, root: Path, out):
    """(c): the elastic restore, saved from the mesh, restored onto specs."""
    cfg = lm_cut(lm.get_config("llama3.2-1b", smoke=smoke))
    batch = tr.data.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                                       seed=2, device=dev).get_batch(0)
    params, opt, zero1 = mesh_state(lm, tr, ms, cfg, rules, mesh,
                                    lm_params(lm, cfg, seed + 194, dev, dtype=torch.float32))
    specs = lm.models.param_shardings(cfg, rules)
    params, opt, _ = tr.train.make_train_step(cfg, rules, tr.train.AdamWConfig(lr=1e-3),
                                              mesh=mesh)(params, opt, batch)
    ckpt_dir = root / "build" / "chip_smoke_mesh_ckpt"
    if ckpt_dir.exists():
        import shutil
        shutil.rmtree(ckpt_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tr.ckpt.save(str(ckpt_dir), 1, (params, opt))
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    named = lambda tree: tr.tree.map_specs(lambda spec, _: ms.NamedSharding(mesh, spec),  # noqa: E731
                                           specs if tree is params else zero1, tree)
    shardings = (named(params), type(opt)(mu=named(opt.mu), nu=named(opt.nu),
                                          step=opt.step.device))
    like = (params, opt)
    t0 = time.perf_counter()
    (pr, orr), manifest = tr.ckpt.restore(str(ckpt_dir), 1, like, shardings=shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bitwise = all(torch.equal(ms.compat.whole(x), ms.compat.whole(y))
                  for x, y in zip(tr.tree.leaves((pr, orr)), tr.tree.leaves((params, opt))))
    placed = all(tuple(x.placements) == tuple(y.placements)
                 for x, y in zip(tr.tree.leaves((pr, orr.mu, orr.nu)),
                                 tr.tree.leaves((params, opt.mu, opt.nu))))
    require(bitwise and placed and manifest["step"] == 1,
            f"(c) the restored state: bitwise {bitwise}, at the asked placements {placed}")
    import shutil
    shutil.rmtree(ckpt_dir)
    out["restore"] = {"bitwise": bitwise, "placed": placed, "bytes": nbytes, "save_s": save_s,
                      "restore_s": restore_s, "leaves": len(manifest["leaves"])}
    log(f"   (c) {cfg.name} cut to {cfg.num_layers} layer: params + ZeRO-1 state after a step "
        f"on the mesh, {nbytes / 1e9:.3f} GB in {len(manifest['leaves'])} leaves, saved in "
        f"{save_s:.3f} s, restored onto NamedShardings of param_shardings / zero1_shardings "
        f"in {restore_s:.3f} s: bitwise, at the asked placements")
    del params, opt, pr, orr
    torch.cuda.empty_cache()


def phase_mesh(lm, tr, ms, km, seed: int, smi: str, root: Path, plain_ms_18, dev="cuda",
               smoke=False, llama=(8, 1024), steps=4, serve=(8, 64, 16), moe=(2, 512),
               restore=(2, 256)) -> dict:
    """Phase 19 (a)-(e): the 2-D mesh path, as the module docstring says."""
    out: dict = {"smi": smi}
    kernels_before = lm_kernel_launches(km)
    with mesh_group(root, dev) as backend:
        mesh = ms.mesh.make_test_mesh((1, 1))
        rules = ms.mesh.rules_for_mesh(mesh)
        require(rules.enabled and rules.tp_axis == "model" and rules.dp_axes == ("data",),
                f"rules_for_mesh: {rules}")
        log(f"   {backend} world size 1: {mesh}, {rules}")
        t0 = time.perf_counter()
        phase_mesh_llama(lm, tr, ms, mesh, rules, seed, smi, dev, smoke, *llama, steps, serve,
                         plain_ms_18, out)
        log(f"   (a), (d): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        phase_mesh_moe(lm, tr, ms, mesh, rules, seed, dev, smoke, *moe, out)
        log(f"   (b): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        phase_mesh_restore(lm, tr, ms, mesh, rules, seed, dev, smoke, *restore, root, out)
        log(f"   (c): {time.perf_counter() - t0:.2f} s")
    after = lm_kernel_launches(km)
    require(after == kernels_before, f"the mesh path launched a hand-written kernel: "
                                     f"{kernels_before} -> {after}")
    log("   (e) kernel launches across phase 19: none (every launch counter as before)")
    print(json.dumps({"phase19": {k: v for k, v in out.items() if k != "smi"}},
                     default=str), flush=True)
    return out



# ---------------------------------------------------------------------------
# Phase 20: the dry run (launch/op_cost, roofline, cells, dryrun, reanalyze,
# report) held against the card: op counts of meta runs, no kernel launch
# ---------------------------------------------------------------------------

# (b)'s cells at full width on the 16 x 16 fake mesh: the llama step and
# decode, the MoE step (microbatches split from a data-sharded batch), and
# a batch-1 long-context decode (a batch the data axis does not split)
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("llama3.2-1b", "decode_32k"),
                ("qwen3-moe-30b-a3b", "train_4k"), ("gemma2-9b", "long_500k"))
DRYRUN_GEMM_RTOL = 0.02  # counted bf16 GEMM flops against lm_train_bound's
DRYRUN_PEAK_RTOL = 0.10  # predicted peak against phase 18's measured one
DRYRUN_COLUMNS = ("hlo_flops_per_chip", "hlo_bytes_per_chip", "model_flops", "t_compute_s",
                  "t_memory_s", "t_collective_s", "dominant", "useful_flops_ratio",
                  "roofline_fraction", "coll_breakdown")
CARD_GIB = 80  # the H100's HBM


def phase_dryrun_calibrate(lm, tr, dr, llama18: dict, smi: str, smoke, b, t, out):
    """(a) op_cost.count_ops on phase 18's program on meta, no mesh."""
    cfg = lm.get_config("llama3.2-1b", smoke=smoke)
    rules = lm.models.NO_SHARDING
    params = lm.models.param_specs(cfg, rules, dtype=torch.float32)
    opt = tr.train.adamw_init(params)
    batch = {k: torch.empty((b, t), dtype=torch.int32, device="meta") for k in ("tokens", "labels")}
    step = tr.train.make_train_step(cfg, rules, tr.train.AdamWConfig(lr=1e-3, warmup_steps=2))
    t0 = time.perf_counter()
    _, cost = dr.op_cost.count_ops(step, params, opt, batch)
    secs = time.perf_counter() - t0
    bound, _, parts = lm_train_bound(cfg, params, b, t)
    gemm = cost.flops_bf16 / 1e12
    terms = dr.roofline.terms(cost.flops_bf16, cost.flops_f32, cost.bytes, cost.link_bytes)
    roof_ms = max(terms) * 1e3
    peak = cost.peak_bytes / 2**30
    a = out["calibration"] = {
        "meta_s": secs, "bf16_tflop": gemm, "bound_bf16_tflop": parts["bf16_tflop"],
        "f32_tflop": cost.flops_f32 / 1e12, "f32_attention_tflop": parts["f32_attention_tflop"],
        "peak_gib": peak, "argument_gib": cost.argument_bytes / 2**30,
        "temp_gib": cost.temp_bytes / 2**30, "measured_peak_gib": llama18["peak_gib"],
        "terms_ms": [x * 1e3 for x in terms], "roofline_ms": roof_ms,
        "measured_step_ms": llama18["step_ms"], "bound_ms": bound}
    log(f"   (a) {cfg.name} train_step at {b} x {t}, f32 params, on meta ({secs:.2f} s): "
        f"bf16 GEMMs {gemm:.4f} TFLOP against lm_train_bound's {parts['bf16_tflop']:.4f} "
        f"({gemm / parts['bf16_tflop'] - 1:+.4f}); f32 {a['f32_tflop']:.4f} TFLOP against "
        f"the live pairs' {parts['f32_attention_tflop']:.4f} (the diagonal blocks' masked "
        f"pairs are computed)")
    log(f"      peak {peak:.3f} GiB predicted (arguments {a['argument_gib']:.3f}, temps "
        f"{a['temp_gib']:.3f}) against {llama18['peak_gib']:.3f} GiB measured in phase 18 "
        f"({peak / llama18['peak_gib'] - 1:+.4f}; {smi})")
    log(f"      roofline terms: compute {terms[0] * 1e3:.3f} ms, memory {terms[1] * 1e3:.3f} "
        f"ms, collective {terms[2] * 1e3:.3f} ms; the step took {llama18['step_ms']:.3f} ms, "
        f"{llama18['step_ms'] / roof_ms:.3f} x the roofline ({smi})")
    require(abs(gemm / parts["bf16_tflop"] - 1) <= DRYRUN_GEMM_RTOL,
            f"the counted bf16 GEMM flops {gemm:.4f} TFLOP are not within {DRYRUN_GEMM_RTOL} "
            f"of lm_train_bound's {parts['bf16_tflop']:.4f}")
    require(a["f32_tflop"] >= parts["f32_attention_tflop"],
            f"the counted f32 flops {a['f32_tflop']:.4f} TFLOP are below the attention's live "
            f"pairs' {parts['f32_attention_tflop']:.4f}")
    require(abs(peak / llama18["peak_gib"] - 1) <= DRYRUN_PEAK_RTOL,
            f"the predicted peak {peak:.3f} GiB is not within {DRYRUN_PEAK_RTOL} of the "
            f"measured {llama18['peak_gib']:.3f} GiB")
    require(roof_ms <= llama18["step_ms"], f"the roofline's {roof_ms:.3f} ms is above the "
                                           f"measured step's {llama18['step_ms']:.3f} ms")


def phase_dryrun_survey(dr, root: Path, cells, out, timeout_s=900) -> Path:
    """(b) python -m repro_torch.launch.dryrun in subprocesses (a fake group
    cannot live beside phase 19's NCCL group), one a cell, side by side,
    no card visible; the records ok, python -m repro_torch.launch.report
    --section roofline renders them. Returns the directory of records and
    op counts."""
    import os
    import shutil

    work = root / "build" / "chip_smoke_dryrun"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # meta tensors compute nothing: one thread a process, no card
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(root / "src"))
    procs = []
    t0 = time.perf_counter()
    try:
        for arch, shape in cells:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--out", str(work / f"{arch}__{shape}.jsonl"), "--ops-dir",
                   str(work / "ops")]
            log_file = open(work / f"{arch}__{shape}.log", "w")
            procs.append((arch, shape, log_file, subprocess.Popen(
                cmd, cwd=root, env=env, stdout=log_file, stderr=subprocess.STDOUT)))
        for arch, shape, log_file, p in procs:
            rc = p.wait(timeout=max(timeout_s - (time.perf_counter() - t0), 1))
            log_file.close()
            tail = (work / f"{arch}__{shape}.log").read_text()[-3000:]
            require(rc == 0, f"the dry run of {arch} x {shape} exited {rc}:\n{tail}")
    finally:
        for *_, log_file, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log_file.close()
    wall = time.perf_counter() - t0
    recs = []
    for arch, shape in cells:
        rec = [json.loads(x) for x in (work / f"{arch}__{shape}.jsonl").read_text().splitlines()]
        require(len(rec) == 1 and rec[0]["status"] == "ok", f"{arch} x {shape}: {rec}")
        recs.extend(rec)
    with open(work / "dryrun_results.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    shown = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--jsonl",
         str(work / "dryrun_results.jsonl"), "--section", "roofline"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    require(shown.returncode == 0, f"report.py exited {shown.returncode}: {shown.stderr[-2000:]}")
    table = shown.stdout
    for arch, shape in cells:
        require(f"| {arch} | {shape} |" in table, f"report.py's roofline table has no row of "
                                                  f"{arch} x {shape}:\n{table}")
    log(f"   (b) python -m repro_torch.launch.dryrun, {len(cells)} cells side by side on the "
        f"16 x 16 fake mesh at full width: {wall:.1f} s of wall clock")
    for r in recs:
        peak = r["bytes_per_chip_peak"] / 2**30
        fits = "fits" if peak <= CARD_GIB else "does not fit"
        log(f"      {r['arch']} x {r['shape']}: {r['trace_s']:.1f} s on meta; per-rank peak "
            f"{peak:.2f} GiB of the card's {CARD_GIB} ({fits}); "
            f"terms compute {r['t_compute_s']:.4f} s, memory {r['t_memory_s']:.4f} s, "
            f"collective {r['t_collective_s']:.4f} s ({r['dominant']})")
    for line in table.strip().splitlines():
        log(f"      {line}")
    out["survey"] = {"wall_s": wall, "cells": [
        {k: r[k] for k in ("arch", "shape", "mesh", "trace_s", "bytes_per_chip_peak",
                           "t_compute_s", "t_memory_s", "t_collective_s", "dominant")}
        for r in recs]}
    return work


def phase_dryrun_reanalyze(dr, work: Path, out) -> None:
    """(c) reanalyze over (b)'s records and op counts: the same columns."""
    src = work / "dryrun_results.jsonl"
    again = work / "reanalyzed.jsonl"
    dr.reanalyze.main(["--jsonl", str(src), "--ops-dir", str(work / "ops"), "--out", str(again)])
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    before = {key(r): r for r in map(json.loads, src.read_text().splitlines())}
    after = {key(r): r for r in map(json.loads, again.read_text().splitlines())}
    require(before.keys() == after.keys(), f"reanalyze gave {sorted(after)}")
    for k, r in before.items():
        diff = [c for c in DRYRUN_COLUMNS if r[c] != after[k][c]]
        require(not diff, f"reanalyze changed {diff} of {k}")
    out["reanalyzed"] = len(after)
    log(f"   (c) reanalyze over (b)'s {len(after)} records: every roofline column the same")


def phase_dryrun(lm, tr, dr, km, smi: str, root: Path, llama18: dict, smoke=False,
                 llama=(8, 1024), cells=DRYRUN_CELLS) -> dict:
    """Phase 20 (a)-(d): the dry run, as the module docstring says."""
    out: dict = {"smi": smi}
    kernels_before = lm_kernel_launches(km)
    t0 = time.perf_counter()
    phase_dryrun_calibrate(lm, tr, dr, llama18, smi, smoke, *llama, out)
    log(f"   (a): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    work = phase_dryrun_survey(dr, root, cells, out)
    log(f"   (b): {time.perf_counter() - t0:.2f} s")
    phase_dryrun_reanalyze(dr, work, out)
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    after = lm_kernel_launches(km)
    require(after == kernels_before, f"the dry run launched a hand-written kernel: "
                                     f"{kernels_before} -> {after}")
    log("   (d) kernel launches across phase 20: none (every launch counter as before)")
    print(json.dumps({"phase20": {k: v for k, v in out.items() if k != "smi"}}, default=str),
          flush=True)
    return out

# ---------------------------------------------------------------------------
# Phase 21: the seven examples (examples/torch_*.py) on the card, each main()
# in-process, with the kernels each must launch
# ---------------------------------------------------------------------------

# (example, its arguments) in the order phase 21 runs them; train_lm twice,
# the second run resuming from the first one's last checkpoint
EXAMPLE_RUNS = (("quickstart", ()), ("multigrid_reuse", ()), ("accumulator_crossover", ()),
                ("serve_spgemm", ()), ("dist_multigrid", ()), ("serve_lm", ()),
                ("train_lm", ("--ckpt-dir", "ckpt")), ("train_lm", ("--ckpt-dir", "ckpt",
                                                                    "--steps", "320")))


def example_launches(km) -> dict:
    """Every kernel's launch counter, by kernel."""
    return {"K1": km.seg.LAUNCHES, "K1 batched": km.seg.BATCHED_LAUNCHES,
            "K2": km.lp.LAUNCHES, "K2 batched": km.lp.BATCHED_LAUNCHES,
            "K3": km.lp.NUMERIC_LAUNCHES, "K4": km.num.LAUNCHES, "K5": km.sym.LAUNCHES,
            "K6": km.bsr.LAUNCHES, "K7": km.gm.LAUNCHES, "K8": km.fa.LAUNCHES}


def moved_since(before: dict, after: dict) -> dict:
    return {k: v - before[k] for k, v in after.items() if v != before[k]}


def load_example(root: Path, name: str):
    """``examples/torch_<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  root / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def armed_window_spy(rt, km, window: dict):
    """Wraps ``faults.failpoint`` so that the launches and fallbacks of each
    armed window are recorded in ``window`` (entered, left)."""
    real = rt.faults.failpoint

    @contextlib.contextmanager
    def spy(name, *args, **kwargs):
        window.setdefault("names", []).append(name)
        window["enter"] = (example_launches(km), dict(rt.telemetry.FALLBACK_COUNTS))
        with real(name, *args, **kwargs):
            yield
        window["leave"] = (example_launches(km), dict(rt.telemetry.FALLBACK_COUNTS))

    rt.faults.failpoint = spy
    try:
        yield
    finally:
        rt.faults.failpoint = real


def run_example(rt, km, root: Path, work: Path, name: str, argv) -> dict:
    """One example's main(argv + --device cuda) in-process, its working
    directory ``work``: exit 0 (an exception fails the phase), its printed
    lines logged, its wall seconds, the launches it made; FALLBACK_COUNTS
    set to 0 first."""
    mod = load_example(root, name)
    rt.telemetry.FALLBACK_COUNTS.clear()
    before = example_launches(km)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.chdir(work), contextlib.redirect_stdout(buf):
        code = mod.main(list(argv) + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"      | {line}")
    require(code == 0, f"{name}: main returned {code}")
    moved = moved_since(before, example_launches(km))
    log(f"   {name} {' '.join(argv)}: exit 0 in {wall:.2f} s (host clock, synchronised); "
        f"launches {moved}")
    return {"wall_s": wall, "launches": moved, "lines": lines}


def check_example(rt, name, run, window) -> None:
    """The kernels each example must launch on the card (none for the LM
    examples, as in phases 17-18):

    * quickstart: K5 and K4 or K3 (``pallas_spgemm``), K1 once (the one
      sparse fresh multiply; R*AP and the fresh check take the dense method);
    * multigrid_reuse: K1 13 times: the setup's two sparse fresh
      multiplies, 5 steps of two replays through the default ("auto")
      executors, and the batch check's replay (the fresh check takes the
      dense method); batched K1 4 times: 2 batches (the warm-up and the
      timed one) of two products;
    * accumulator_crossover: K1 twice (step 1's sparse multiplies), K2 four
      times (the lp multiply and three replays), K3 once (the spill);
    * serve_spgemm: batched K1 (every group of two or more) and single K1,
      K2 only inside the armed ``kernel:pallas`` window (two ladder steps,
      two short circuits), fault keys only there;
    * dist_multigrid: K1 once a live shard a replay: A*P 11 replays (setup,
      8 steps, 2 checks), R*AP 9 (setup, 8 steps), and 3 times for the
      single-device check (its pin's fresh multiply and its default
      executor's two replays); batched K1 twice a live A*P shard;
    * serve_lm, train_lm: no launch.
    """
    got = run["launches"]
    if name == "quickstart":
        require(got.get("K5", 0) >= 1 and got.get("K4", 0) + got.get("K3", 0) >= 1
                and got.get("K1") == 1 and set(got) <= {"K1", "K3", "K4", "K5"},
                f"quickstart: launches {got}")
    elif name == "multigrid_reuse":
        want = {"K1": 2 + 5 * 2 + 1, "K1 batched": 2 * 2}
        require(got == want, f"multigrid_reuse: launches {got}, not {want}")
    elif name == "accumulator_crossover":
        require(got == {"K1": 2, "K2": 4, "K3": 1}, f"accumulator_crossover: launches {got}")
    elif name == "serve_spgemm":
        require(window.get("names") == ["kernel:pallas"], f"serve_spgemm: armed {window}")
        (enter, fb_in), (leave, fb_out) = window["enter"], window["leave"]
        inside = moved_since(enter, leave)
        require(got.get("K1 batched", 0) >= 1 and got.get("K1", 0) >= 1,
                f"serve_spgemm: launches {got}: no batched or single K1")
        require(got.get("K2", 0) == inside.get("K2", 0) == 4 and "K2 batched" not in got
                and set(got) <= {"K1", "K1 batched", "K2"},
                f"serve_spgemm: launches {got}, inside the armed window {inside}")
        faults_in = {k: v for k, v in fb_out.items() if k.startswith("fault:")}
        require(not any(k.startswith("fault:") for k in fb_in)
                and faults_in == {"fault:pallas->pallas_lp": 2},
                f"serve_spgemm: fallbacks entering the window {fb_in}, leaving it {fb_out}")
        after = {k: v for k, v in rt.telemetry.FALLBACK_COUNTS.items() if k.startswith("fault:")}
        require(after == faults_in, f"serve_spgemm: fault keys after the window {after}")
        log(f"   serve_spgemm: inside the armed window {inside}, {faults_in}; outside it no "
            f"K2 launch and no fault key")
        return
    elif name == "dist_multigrid":
        live = re.search(r"live shards: A\*P (\d+), R\*AP (\d+)", "\n".join(run["lines"]))
        require(live is not None, "dist_multigrid: no live-shard line")
        ap, rap = (int(x) for x in live.groups())
        want = {"K1": 11 * ap + 9 * rap + 3, "K1 batched": 2 * ap}
        require(got == want, f"dist_multigrid: launches {got}, not {want}")
    else:
        require(got == {}, f"{name}: launched {got}")
    check_fallbacks(rt, name)


def phase_examples(rt, km, root: Path) -> dict:
    """Phase 21: each example of EXAMPLE_RUNS through its main() on the card,
    in a fresh directory under build/ (serve_spgemm's trace and train_lm's
    checkpoints land there), removed after; train_lm at its defaults (300
    steps, checkpoints at 100, 200, 300), then to 320, which must resume
    from step 300. Returns each run's wall seconds and launches."""
    import shutil

    work = root / "build" / "chip_smoke_examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out: dict = {}
    try:
        for name, argv in EXAMPLE_RUNS:
            window: dict = {}
            with armed_window_spy(rt, km, window):
                run = run_example(rt, km, root, work, name, argv)
            check_example(rt, name, run, window)
            key = name if name not in out else f"{name} (resumed)"
            out[key] = {"wall_s": run["wall_s"], "launches": run["launches"]}
            if key == "train_lm":
                require(run["lines"][-1] == "done" and "checkpoint @ 300" in run["lines"],
                        f"train_lm: {run['lines'][-3:]}")
            elif key == "train_lm (resumed)":
                require("resumed from step 300" in run["lines"] and run["lines"][-1] == "done",
                        f"train_lm --steps 320: {run['lines']}")
            else:
                require(run["lines"][-1].endswith("OK"), f"{name}: last line {run['lines'][-1]}")
        require((work / "trace_serve_quickstart.json").exists(),
                "serve_spgemm wrote no trace")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("   every example exited 0 with its reference lines; wall seconds: "
        + ", ".join(f"{k} {v['wall_s']:.2f}" for k, v in out.items()))
    print(json.dumps({"phase21": out}), flush=True)
    return out


def phase_analysis(root: Path) -> dict:
    """Phase 22: ``python -m repro_torch.analysis`` over src/repro_torch in a
    child process under the tests' import guard (``tests/torch_import_guard``:
    importing jax, jaxlib, flax or repro raises), its report written as JSON
    under build/ (removed after). Fails on a nonzero exit or any new finding;
    prints the counts of findings by rule and of inline allows by code."""
    spec = importlib.util.spec_from_file_location(
        "torch_import_guard", root / "tests" / "torch_import_guard.py")
    guard = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(guard)

    report_path = root / "build" / "chip_smoke_analysis.json"
    report_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        proc = guard.run_guarded("import runpy\nrunpy.run_module('repro_torch.analysis', "
                                 "run_name='__main__', alter_sys=True)\n",
                                 "--json", str(report_path))
        wall_s = time.perf_counter() - t0
        require(proc.returncode == 0, "repro_torch.analysis failed (exit "
                f"{proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        report = json.loads(report_path.read_text())
    finally:
        report_path.unlink(missing_ok=True)
    require(report["ok"] and report["counts"]["new"] == 0,
            f"repro_torch.analysis: new findings {report['new']}")
    require(report["stats"]["modules"] > 80 and report["stats"]["parse_errors"] == 0,
            f"repro_torch.analysis read too little: {report['stats']}")
    allows: dict = {}
    for finding in report["suppressed"]:
        allows[finding["code"]] = allows.get(finding["code"], 0) + 1
    out = {"modules": report["stats"]["modules"], "counts": report["counts"],
           "findings_by_rule": report["stats"]["findings_by_rule"], "allows": allows,
           "wall_s": wall_s}
    log(f"   {proc.stdout.strip().splitlines()[-1]} ({wall_s:.2f} s, jax and repro refused)")
    print(json.dumps({"phase22": out}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2b (build + kernels vs plain)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of each path after phase 5")
    args = ap.parse_args(argv)
    # cuBLAS's workspace as deterministic mode needs it (phase 18 (c)),
    # before CUDA starts; 4,096 KiB x 8 is also torch's default on Hopper
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a card",
              file=sys.stderr)
        return 2
    import repro_torch.core as rt_core
    import repro_torch.sparse as rt_sparse
    import repro_torch.configs as rt_configs
    import repro_torch.kernels as kernels_api
    from repro_torch.core import autotune, executor, telemetry
    from repro_torch.core.spgemm import STAGE_COUNTS
    from repro_torch.serve import SparseService
    import repro_torch.compat as rt_compat
    import repro_torch.dist as rt_dist
    from repro_torch.kernels import _build, ops, plan_columns, segsum_reuse, spgemm_lp
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
        spgemm_grouped = staticmethod(rt_core.spgemm_grouped)

    # the selection and robustness layer: counters, tuner, faults, obs
    rt.telemetry, rt.autotune, rt.faults, rt.recorder, rt.trace = (
        telemetry, autotune, faults, recorder, trace)
    rt.KernelFallbackError = KernelFallbackError
    # the serving tier
    rt.SparseService, rt.stage_counts = SparseService, STAGE_COUNTS
    rt.AdmissionRejected, rt.DeadlineExceeded = AdmissionRejected, DeadlineExceeded
    rt.check_csr, rt.replay_batched = staticmethod(check_csr), staticmethod(executor._replay_batched)
    # the sharded path
    rt.compat, rt.ShardedReuseExecutor = rt_compat, rt_dist.ShardedReuseExecutor
    rt.distributed_spgemm = staticmethod(rt_core.distributed_spgemm)
    rt.compressed_psum = staticmethod(rt_dist.compressed_psum)
    rt.pipeline_forward = staticmethod(rt_dist.pipeline_forward)
    rt.plan_nbytes, rt.hash_counts = staticmethod(rt_core.plan_nbytes), rt_core.HASH_COUNTS

    class lm:  # the LM substrate: the model zoo and its serving engine
        import repro_torch.models as models
        from repro_torch.models import moe
        from repro_torch.serve import ServeEngine
        get_config = staticmethod(rt_configs.get_config)
        arch_ids = rt_configs.ARCH_IDS

    from repro_torch.models.model import _cache_len, _is_template_leaf
    lm.cache_len, lm.is_template_leaf = staticmethod(_cache_len), staticmethod(_is_template_leaf)

    class tr:  # the training path: optimizer and step, data, checkpoints, trees
        import repro_torch.train as train
        from repro_torch.train import step
        import repro_torch.data as data
        import repro_torch.ckpt as ckpt
        import repro_torch._tree as tree

    class ms:  # the data x model mesh: launch/mesh, compat's DTensor mesh
        import repro_torch.launch.mesh as mesh
        from repro_torch import compat
        from repro_torch.compat import NamedSharding
        from torch.distributed.tensor import DTensor

    class dr:  # the dry run: op counts on meta tensors, the roofline, its tools
        from repro_torch.launch import op_cost, reanalyze, roofline

    class km:  # the kernels' modules: wrappers, plain versions, launch counts
        seg, lp, sym, num = segsum_reuse, spgemm_lp, spgemm_symbolic, spgemm_numeric

    km.ops = ops
    km.pc = plan_columns
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
    with Phase("phase 2b: plan_columns vs plain on the fresh path's sorted expansions"):
        pc_times = phase_plan_columns(km.pc, Path(__file__).resolve().parent)
    if args.kernels_only:
        log("kernels-only run: phases 1-2b passed; no result line")
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
    mg_default = mg["default_replay"]
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
    torch.cuda.empty_cache()
    with Phase("phase 16: the sharded SpGEMM (repro_torch.dist) through K1 a shard"):
        dist = phase_dist(rt, km, args.seed, Path(__file__).resolve().parent, smi,
                          {DIST_LABELS[0]: times["multigrid AP"]["segsum_reuse"],
                           DIST_LABELS[1]: times["power-law A*A"]["segsum_reuse"]})
    torch.cuda.empty_cache()
    with Phase("phase 17: the LM serving path (models/, serve/engine.py), every architecture"):
        phase_lm(lm, km, args.seed, smi)
    torch.cuda.empty_cache()
    with Phase("phase 18: the LM training path (train/, data/, ckpt/, launch/train.py)"):
        train = phase_train(lm, tr, km, args.seed, smi, Path(__file__).resolve().parent)
    torch.cuda.empty_cache()
    with Phase("phase 19: the 2-D data x model mesh (launch/mesh, DTensor placements, the "
               "MoE's local_map path, ZeRO-1, the elastic restore) at world size 1"):
        phase_mesh(lm, tr, ms, km, args.seed, smi, Path(__file__).resolve().parent,
                   train["llama"]["step_ms"])
    with Phase("phase 20: the dry run (launch/op_cost, roofline, cells, dryrun, reanalyze, "
               "report) held against the card"):
        phase_dryrun(lm, tr, dr, km, smi, Path(__file__).resolve().parent, train["llama"])
    torch.cuda.empty_cache()
    with Phase("phase 21: the seven examples (examples/torch_*.py) on the card"):
        phase_examples(rt, km, Path(__file__).resolve().parent)
    with Phase("phase 22: the port's contract linter (python -m repro_torch.analysis) "
               "without jax or repro"):
        phase_analysis(Path(__file__).resolve().parent)

    k1, k2 = times["multigrid AP"], times["power-law A*A"]
    serve_worst = max(serve[k]["worst"]
                      for k in ("pallas", "pallas_lp", "auto", "singletons", "chaos"))
    kernels = [
        {"name": "segsum_reuse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segsum_reuse.cu",
         "replaces": "src/repro/kernels/segsum_reuse.py:107",
         "launches": mg_launches["segsum_reuse"],
         "max_abs_err": max(mg_worst, pw["fresh_worst"], synth_worst["segsum_reuse"],
                            synth_worst["batched_segsum_reuse"], serve_worst, dist["worst"]),
         "ms": k1["segsum_reuse"], "plain_ms": k1["plain"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None, "shape": "multigrid AP",
         "batched_ms": serve["times"]["multigrid A*P"]["segsum_reuse"]["batch8_ms"],
         "batched_launches": serve["launches"]["segsum_reuse_batched"],
         "batched_shape": "multigrid A*P, batch 8",
         "sharded_launches": dist["launches"],
         "sharded_batched_launches": dist["batched_launches"],
         "sharded_ms": dist["cells"][DIST_LABELS[0]]["runs"][f"S={DIST_SHARDS} replicated"]["ms"],
         "sharded_shape": f"multigrid A*P, S={DIST_SHARDS} replicated (whole apply)",
         "default_replay_ms": mg_default["ms"],
         "default_launches": mg_default["launches"]["segsum_reuse"]
         + mg_default["launches"]["segsum_reuse_batched"]},
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
    kernels.append({
        "name": "plan_columns", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/plan_columns.cu", "replaces": None,
        "launches": mg_launches["plan_columns"], "max_abs_err": pc_times["max_abs_err"],
        "ms": pc_times["ms"],
        "plain_ms": pc_times["plain_ms"], "bound_ms": pc_times["bound_ms"],
        "bound_by": pc_times["bound_by"], "library_ms": None, "shape": pc_times["shape"]})
    for k in kernels:
        k["max_err"] = k["max_abs_err"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it end to end.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --kernels-only   # phases 1-2: build + kernel vs plain
    python3 chip_smoke.py --profile        # adds a device-time breakdown per path

Phases, in order:
  1. the card (name and power limit from nvidia-smi) and the kernel build
     (one nvcc per CUDA source, all started together);
  2. each replay kernel against its plain torch version on synthetic plans
     (fm not a multiple of the tile, a sentinel tail, one segment spanning
     many blocks; f32, bf16, f16 and mixed values);
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
  6. one JSON line of the kernels; the last line is the result.

The launch counters are set to 0 just before phases 3 and 4 drive the main
path and read just after. Any failed check raises, so the script exits
non-zero and prints no result. It needs torch, numpy and scipy; it exits
non-zero when no CUDA card is visible or when the repo's src/ is missing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
        lines = dict.fromkeys(line.strip() for line in text.splitlines()
                              if "registers" in line or "spill" in line)
        for line in lines:  # one line per distinct report, not per instantiation
            log(f"   nvcc[{name}]: {line}")
    return smi


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
    torch.cuda.synchronize()
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
    check_against_scipy("A*A (normal)", res.c, a_s @ a_s, abs(a_s) @ abs(a_s))
    log(f"   scipy check: {time.perf_counter() - t0:.2f} s")
    out.update(powerlaw_launches=launches, powerlaw_worst=worst, rmat=a, rmat_res=res,
               rmat_ex=ex, rmat_nnz=nnz)


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

    def sparse_mm(x, y):
        def csr_t(c):
            nnz = int(c.indptr[-1])
            return torch.sparse_csr_tensor(c.indptr.long(), c.indices[:nnz].long(),
                                           c.values[:nnz], size=c.shape)
        xt, yt = csr_t(x), csr_t(y)
        return lambda: torch.sparse.mm(xt, yt)

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
    from repro_torch.kernels import _build, segsum_reuse as seg_mod, spgemm_lp as lp_mod

    class rt:  # the port's public entry points used below
        spgemm = staticmethod(rt_core.spgemm)
        ReuseExecutor = rt_core.ReuseExecutor
        galerkin_triple = staticmethod(rt_sparse.galerkin_triple)
        rmat_csr = staticmethod(rt_sparse.rmat_csr)

    with Phase("phase 1: device and build"):
        phase_device(_build)
    with Phase("phase 2: kernels vs plain on synthetic plans"):
        synth_worst = phase_kernels_vs_plain(seg_mod, lp_mod, args.seed)
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

    k1, k2 = times["multigrid AP"], times["power-law A*A"]
    kernels = [
        {"name": "segsum_reuse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segsum_reuse.cu",
         "replaces": "src/repro/kernels/segsum_reuse.py:107",
         "launches": mg["multigrid_launches"]["segsum_reuse"],
         "max_abs_err": max(mg["multigrid_worst"], synth_worst["segsum_reuse"]),
         "ms": k1["segsum_reuse"], "plain_ms": k1["plain"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None, "shape": "multigrid AP"},
        {"name": "lp_reuse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lp_reuse.cu",
         "replaces": "src/repro/kernels/spgemm_lp.py:302",
         "launches": pw["powerlaw_launches"]["lp_reuse"],
         "max_abs_err": max(pw["powerlaw_worst"], synth_worst["lp_reuse"]),
         "ms": k2["lp_reuse"], "plain_ms": k2["plain"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None, "shape": "power-law A*A"},
    ]
    for k in kernels:
        k["max_err"] = k["max_abs_err"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

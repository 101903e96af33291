#!/usr/bin/env python3
"""Time K3 spgemm_lp's hash against the identity hash on one CUDA card.

    python3 scripts/k3_variants.py [--out results.json]

The port's library hashes a key to its home slot with a multiplicative hash
(csrc/spgemm_lp.cu, lp_hash). This script also compiles the same source
with -DSPGEMM_LP_IDENTITY_HASH (home slot = key & (size - 1)), under a
library name that the port never loads, and runs both through the same
wrapper. At
RMAT-16 A*A (rmat_csr(16, 8), the structure from kernels/ops) and multigrid
512^2 A*P (galerkin_triple(512, 512, 4)), on the operands as numeric_values'
bucketed wrappers pad them, it times (CUDA events, median of 7) each build
on every row and on each K3 size class's rows alone (lp_row_class), beside
K4 spgemm_numeric on the same rows and torch.sparse.mm on the whole product.
Every K3 output is held against spgemm_lp_plain (1e-4 * S + 1e-6, S the sum
of |products|) on all rows at A*P and on a sample of each class's rows,
widest included, at A*A. Prints the card's name and power limit, one line
per (shape, class, build), and last a JSON object of the results. Exits
non-zero without a card or on a failed check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = 64  # rows per class held against the plain version at A*A
# the comparison builds: name -> the macro defined for it
VARIANTS = {"identity hash": "SPGEMM_LP_IDENTITY_HASH"}


def build_variants(_build) -> dict:
    """One nvcc of csrc/spgemm_lp.cu per comparison build (VARIANTS), all at
    once beside the port's own build of it; returns {name: loaded library}."""
    src = _build.CSRC_DIR / "spgemm_lp.cu"
    tag = _build.library_path("spgemm_lp").stem.split("-")[-1]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, define in VARIANTS.items():
        path = _build.BUILD_DIR / f"libspgemm_lp_{define.lower()}-{tag}.so"
        proc = tmp = None
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-D{define}", "-o", str(tmp),
                   str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        procs[name] = (path, tmp, proc)
    _build.build(("spgemm_lp", "spgemm_numeric", "spgemm_symbolic"))
    libs = {}
    for name, (path, tmp, proc) in procs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the {name} build:\n{out}")
            os.replace(tmp, path)
        libs[name] = ctypes.CDLL(str(path))
    return libs


def operands(rt, ops, shape: str, seed: int):
    """(a, b, c_idx, c_nnz) of one shape, C's structure from kernels/ops."""
    if shape == "power-law A*A":
        a = rt.rmat_csr(16, 8, seed=0, device="cuda")
        b = a
    else:
        _, a, b = rt.galerkin_triple(512, 512, agg_size=4, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(seed + 4)
        vals = torch.randn(a.nnz_cap, generator=g, device="cuda")
        a = rt.CSR(a.indptr, a.indices, torch.where(vals == 0, 1.0, vals), a.shape)
    c_nnz, c_idx, _ = ops.pallas_spgemm(a, b, kernel="dense_acc")
    return a, b, c_idx, c_nnz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON results to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.core as rt_core
    import repro_torch.sparse as rt_sparse
    from repro_torch.core.meta import round_capacity
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import spgemm_lp as lp
    from repro_torch.kernels import spgemm_numeric as num
    from repro_torch.kernels.spgemm_numeric import _pad_width

    class rt:
        rmat_csr = staticmethod(rt_sparse.rmat_csr)
        galerkin_triple = staticmethod(rt_sparse.galerkin_triple)
        CSR = rt_sparse.CSR
        csr_to_ell = staticmethod(rt_sparse.csr_to_ell)
        flops_stats = staticmethod(rt_core.flops_stats)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    builds = {"port": _build.load("spgemm_lp"), **build_variants(_build)}
    port_lib = builds["port"]
    g = torch.Generator(device="cuda").manual_seed(args.seed + 15)
    results = []
    try:
        for shape in ("power-law A*A", "multigrid 512^2 A*P"):
            a, b, c_idx, c_nnz = operands(rt, ops, shape, args.seed)
            ea, eb = rt.csr_to_ell(a), rt.csr_to_ell(b)
            k, r_c = b.shape[1], c_idx.shape[1]
            a_idx = _pad_width(ea.indices, round_capacity(ea.r_pad))
            a_val = _pad_width(ea.values, a_idx.shape[1])
            b_idx = _pad_width(eb.indices, round_capacity(eb.r_pad))
            b_val = _pad_width(eb.values, b_idx.shape[1])
            c_idx_p = _pad_width(c_idx, round_capacity(r_c))
            fm_row = rt.flops_stats(a, b.row_nnz())[1]
            cls = lp.lp_row_class(c_nnz, None)
            groups = [("all", torch.arange(a.shape[0], device="cuda"))]
            groups += [(f"class {c}" + (" (device memory)" if c == len(lp.CLASS_SLOTS)
                                        else f" (<= {lp.CLASS_SLOTS[c]} slots)"),
                        torch.nonzero(cls == c).flatten())
                       for c in sorted(set(cls.tolist()) - {-1})]
            lib_ms = cs.time_ms(cs.sparse_mm(a, b))
            print(f"{shape}: m {a.shape[0]}, fm {int(fm_row.sum())}, nnz(C) "
                  f"{int(c_nnz.sum())}, rA {a_idx.shape[1]}, rB {b_idx.shape[1]}, rC "
                  f"{c_idx_p.shape[1]}; torch.sparse.mm {lib_ms:.3f} ms", flush=True)
            for label, rows in groups:
                whole = label == "all"
                ra, rv, rn = ((a_idx, a_val, ea.row_nnz) if whole else
                              (a_idx[rows], a_val[rows], ea.row_nnz[rows]))
                rc, rcn = (c_idx_p, c_nnz) if whole else (c_idx_p[rows], c_nnz[rows])
                k4_ms = cs.time_ms(lambda: num.spgemm_numeric(
                    ra, rv, rn, b_idx, b_val, rc, rcn, k=k, b_nnz=eb.row_nnz))
                # the plain version on every row at A*P, on a sample at A*A
                check = (torch.arange(rows.shape[0], device="cuda")
                         if shape != "power-law A*A" or rows.shape[0] <= SAMPLE
                         else cs.sample_rows(rcn, SAMPLE, g))
                want = lp.spgemm_lp_plain(ra[check], rv[check], rn[check], b_idx, b_val,
                                          eb.row_nnz, rc[check], rcn[check], k=k)
                scale = lp.spgemm_lp_plain(ra[check], rv[check].abs(), rn[check], b_idx,
                                           b_val.abs(), eb.row_nnz, rc[check], rcn[check], k=k)
                row = {"shape": shape, "rows": label, "n_rows": int(rows.shape[0]),
                       "products": int(fm_row[rows].sum()), "c_entries": int(rcn.sum()),
                       "k4_ms": k4_ms, "sparse_mm_ms": lib_ms if whole else None}
                for name, lib in builds.items():
                    _build._LIBS["spgemm_lp"] = lib

                    def call():
                        return lp.spgemm_lp(ra, rv, rn, b_idx, b_val, eb.row_nnz, rc, rcn, k=k)
                    got = call()[check]
                    err = cs.tolerance_check(f"{shape} {label} {name}", got, want, scale,
                                             cs.F32_TOL)
                    del got
                    ms = cs.time_ms(call)
                    results.append({**row, "build": name, "ms": ms, "max_abs_err": err,
                                    "checked_rows": int(check.shape[0])})
                    lib_s = f", torch.sparse.mm {lib_ms:.3f} ms" if whole else ""
                    print(f"{shape} {label}: {row['n_rows']} rows, {row['products']} "
                          f"products, {row['c_entries']} C entries; K3 {name}: {ms:.3f} ms, "
                          f"K4 {k4_ms:.3f} ms{lib_s}; max |K3 - plain| {err:.3e} on "
                          f"{check.shape[0]} rows", flush=True)
                del ra, rv, rn, rc, rcn, want, scale
                torch.cuda.empty_cache()
            del a, b, c_idx, c_nnz, ea, eb, a_idx, a_val, b_idx, b_val, c_idx_p
            torch.cuda.empty_cache()
    finally:
        _build._LIBS["spgemm_lp"] = port_lib
    text = json.dumps({"device": smi, "results": results})
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K4 spgemm_numeric and K5 spgemm_symbolic against an earlier build of
their sources, in turns, on one CUDA card.

    python3 scripts/k45_variants.py --parent-dir DIR [--out results.json]
    python3 scripts/k45_variants.py --parent-rev REV  # in a git checkout

DIR holds an earlier commit's kernels/csrc/spgemm_numeric.cu,
spgemm_symbolic.cu and the headers they include (ell_common.cuh,
replay_common.cuh); --parent-rev fills build/k45_parent/ from ``git show
REV:src/repro_torch/kernels/csrc/<file>``. The script compiles those sources
(the parent's C interfaces: K4 with a `tile` argument, one shared-memory
pass per 16,384 columns; K5 with no scratch) beside the port's own build,
under library names the port never loads. At RMAT-16 A*A (rmat_csr(16, 8)) and
multigrid 512^2 A*P (galerkin_triple(512, 512, 4)), on the operands as
numeric_values' bucketed wrappers pad them, it times (CUDA events, median of
7) K4 on every row and on each K4 window class's rows alone (window_class),
in turns parent, port, port, parent, beside torch.sparse.mm
on the whole product and one fill of the (m, rC) output (the zeros that
K4 writes first); and K5 on every row, parent, port, port, parent. Every
K4 output is held against spgemm_numeric_plain (1e-4 * S + 1e-6) on all rows
at A*P and on a sample of rows, widest included, at A*A; every K5 output
equals spgemm_symbolic_plain bitwise. Prints the card's name and power
limit, one line per measurement, and last a JSON object of the results.
Exits non-zero without a card or on a failed check.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = 64  # rows per class held against the plain version at A*A
PARENT_FILES = ("spgemm_numeric.cu", "spgemm_symbolic.cu", "ell_common.cuh",
                "replay_common.cuh")
PARENT_TILE = 16384  # the parent K4's f32 columns per shared-memory pass
# the parent's C interfaces (kernels/spgemm_numeric.py, spgemm_symbolic.py)
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
PARENT_K4_ARGS = [_P, _P, _INT, _P, _I64, _P, _P, _INT, _P, _I64, _I64, _P, _P, _I64,
                  _P, _I64, _I64, _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P]
PARENT_K5_ARGS = [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P]


def fill_parent(rev: str, dest: Path) -> None:
    dest.mkdir(parents=True, exist_ok=True)
    for name in PARENT_FILES:
        text = subprocess.run(["git", "show", f"{rev}:src/repro_torch/kernels/csrc/{name}"],
                              cwd=ROOT, capture_output=True, text=True, check=True).stdout
        (dest / name).write_text(text)


def compile_all(_build, parent_dir: Path) -> dict:
    """nvcc the parent's two sources, both at once beside the port's own
    build; {name: loaded library}. Each is compiled from a copy under a file
    name of its own: nvcc names a file's module and its anonymous namespace
    after the file, and two libraries of one name loaded in one process run
    one's code."""
    jobs = {"parent K4": parent_dir / "spgemm_numeric.cu",
            "parent K5": parent_dir / "spgemm_symbolic.cu"}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in jobs.items():
        tag = name.replace(" ", "_").lower()
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(src.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        path = _build.BUILD_DIR / f"libk45_{tag}-{h.hexdigest()[:16]}.so"
        proc = tmp = None
        if not path.exists():
            copy = _build.BUILD_DIR / f"k45_{tag}_{src.name}"
            copy.write_bytes(src.read_bytes())
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src.parent),
                   "-o", str(tmp), str(copy)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        procs[name] = (path, tmp, proc)
    _build.build(("spgemm_numeric", "spgemm_symbolic"))
    libs = {}
    for name, (path, tmp, proc) in procs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the {name} build:\n{out}")
            os.replace(tmp, path)
            for line in dict.fromkeys(ln.strip() for ln in out.splitlines()
                                      if "registers" in ln or "spill" in ln):
                print(f"nvcc[{name}]: {line}", flush=True)
        libs[name] = ctypes.CDLL(str(path))
    return libs


def call_parent(lib, name: str, argtypes, *args) -> None:
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = fn(*args)
    if err:
        raise RuntimeError(f"parent {name}: CUDA error {err}")


def parent_k4(lib, codes, a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, k):
    """The parent's spgemm_numeric: f32 out, then A's dtype (``codes``: the
    dtype codes of the C interface)."""
    out = torch.empty(c_idx.shape, dtype=torch.float32, device=a_idx.device)
    stream = torch.cuda.current_stream().cuda_stream
    call_parent(lib, "spgemm_numeric", PARENT_K4_ARGS, a_idx.data_ptr(), a_val.data_ptr(),
                codes[a_val.dtype], a_nnz.data_ptr(), a_idx.shape[1],
                b_idx.data_ptr(), b_val.data_ptr(), codes[b_val.dtype],
                b_nnz.data_ptr(), b_idx.shape[0], b_idx.shape[1], c_idx.data_ptr(),
                c_nnz.data_ptr(), c_idx.shape[1], out.data_ptr(), c_idx.shape[0], k,
                min(PARENT_TILE, k), 0, None, None, None, None, None, None, None, stream)
    return out.to(a_val.dtype)


def parent_k5(lib, a_idx, a_nnz, bm):
    out = torch.empty(a_idx.shape[0], dtype=torch.int32, device=a_idx.device)
    stream = torch.cuda.current_stream().cuda_stream
    call_parent(lib, "spgemm_symbolic", PARENT_K5_ARGS, a_idx.data_ptr(), a_idx.shape[1],
                a_nnz.data_ptr(), bm.data_ptr(), bm.shape[0], bm.shape[1], out.data_ptr(),
                a_idx.shape[0], stream)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-dir", help="the earlier sources (default build/k45_parent)")
    ap.add_argument("--parent-rev", help="fill the parent directory from this git revision")
    ap.add_argument("--out", help="also write the JSON results to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k45_variants: no CUDA device visible", file=sys.stderr)
        return 2
    parent_dir = Path(args.parent_dir or ROOT / "build" / "k45_parent")
    if args.parent_rev:
        fill_parent(args.parent_rev, parent_dir)
    missing = [f for f in PARENT_FILES if not (parent_dir / f).exists()]
    if missing:
        print(f"k45_variants: {parent_dir} lacks {missing} (give --parent-rev)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.core as rt_core
    import repro_torch.sparse as rt_sparse
    from repro_torch.core.meta import round_capacity
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import segsum_reuse as seg
    from repro_torch.kernels import spgemm_numeric as num
    from repro_torch.kernels import spgemm_symbolic as sym
    from repro_torch.kernels.spgemm_numeric import _pad_width

    class rt:
        rmat_csr = staticmethod(rt_sparse.rmat_csr)
        galerkin_triple = staticmethod(rt_sparse.galerkin_triple)
        CSR = rt_sparse.CSR
        csr_to_ell = staticmethod(rt_sparse.csr_to_ell)
        flops_stats = staticmethod(rt_core.flops_stats)
        bitmask_rows = staticmethod(rt_core.bitmask_rows)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = compile_all(_build, parent_dir)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 45)
    results = []
    for shape in ("power-law A*A", "multigrid 512^2 A*P"):
        if shape == "power-law A*A":
            a = rt.rmat_csr(16, 8, seed=0, device="cuda")
            b = a
        else:
            _, a, b = rt.galerkin_triple(512, 512, agg_size=4, device="cuda")
            gv = torch.Generator(device="cuda").manual_seed(args.seed + 4)
            vals = torch.randn(a.nnz_cap, generator=gv, device="cuda")
            a = rt.CSR(a.indptr, a.indices, torch.where(vals == 0, 1.0, vals), a.shape)
        c_nnz, c_idx, _ = ops.pallas_spgemm(a, b, kernel="dense_acc")
        ea, eb = rt.csr_to_ell(a), rt.csr_to_ell(b)
        k = b.shape[1]
        a_idx = _pad_width(ea.indices, round_capacity(ea.r_pad))
        a_val = _pad_width(ea.values, a_idx.shape[1])
        b_idx = _pad_width(eb.indices, round_capacity(eb.r_pad))
        b_val = _pad_width(eb.values, b_idx.shape[1])
        c_idx_p = _pad_width(c_idx, round_capacity(c_idx.shape[1]))
        bm = rt.bitmask_rows(b)
        fm_row = rt.flops_stats(a, b.row_nnz())[1]
        lib_ms = cs.time_ms(cs.sparse_mm(a, b))
        # the yardstick of the output's zeros: one fill of the same bytes
        zeros = torch.empty(c_idx_p.shape, dtype=a_val.dtype, device="cuda")
        fill_ms = cs.time_ms(zeros.zero_)
        del zeros
        results.append({"shape": shape, "kernel": "fill of the (m, rC) output",
                        "rows": "all", "build": "torch", "ms": fill_ms})
        print(f"{shape}: m {a.shape[0]}, k {k}, fm {int(fm_row.sum())}, nnz(C) "
              f"{int(c_nnz.sum())}, rA {a_idx.shape[1]}, rB {b_idx.shape[1]}, rC "
              f"{c_idx_p.shape[1]}, k32 {bm.shape[1]}; torch.sparse.mm {lib_ms:.3f} ms; "
              f"one fill of the (m, rC) output (torch zero_) {fill_ms:.3f} ms", flush=True)

        # K5: every row, parent / port / port / parent, bitwise against plain
        want5 = sym.spgemm_symbolic_plain(a_idx, ea.row_nnz, bm)
        k5_calls = {"parent": lambda: parent_k5(libs["parent K5"], a_idx, ea.row_nnz, bm),
                    "port": lambda: sym.spgemm_symbolic(a_idx, ea.row_nnz, bm)}
        for build in ("parent", "port", "port", "parent"):
            cs.require(torch.equal(k5_calls[build](), want5),
                       f"{shape} K5 {build} differs from its plain version")
            ms = cs.time_ms(k5_calls[build])
            bound = cs.symbolic_bound(int(a.indptr[-1]), a.shape[0], b.shape[0],
                                      bm.shape[1])[0]
            results.append({"shape": shape, "kernel": "K5", "rows": "all",
                            "build": build, "ms": ms, "bound_ms": bound})
            print(f"{shape} K5 all rows, {build}: {ms:.3f} ms (bound {bound:.3f} ms); "
                  f"== plain bitwise", flush=True)
        del want5
        torch.cuda.empty_cache()

        # K4: every row and each window class alone
        cls = num.window_class(c_idx_p, c_nnz, k)
        groups = [("all", torch.arange(a.shape[0], device="cuda"))]
        groups += [(f"class {c} (" + ("wide" if c == len(num.CLASS_COLS) else
                                      f"<= {num.CLASS_COLS[c]} columns") + ")",
                    torch.nonzero(cls == c).flatten())
                   for c in sorted(set(cls.tolist()) - {-1})]
        for label, rows in groups:
            whole = label == "all"
            ra, rv, rn = ((a_idx, a_val, ea.row_nnz) if whole else
                          (a_idx[rows], a_val[rows], ea.row_nnz[rows]))
            rc, rcn = (c_idx_p, c_nnz) if whole else (c_idx_p[rows], c_nnz[rows])
            check = (torch.arange(rows.shape[0], device="cuda")
                     if shape != "power-law A*A" or rows.shape[0] <= SAMPLE
                     else cs.sample_rows(rcn, SAMPLE, g))
            ell = (ra, rv, rn, b_idx, b_val)
            want = num.spgemm_numeric_plain(ra[check], rv[check], rn[check], b_idx, b_val,
                                            rc[check], rcn[check], k=k, b_nnz=eb.row_nnz)
            scale = num.spgemm_numeric_plain(ra[check], rv[check].abs(), rn[check], b_idx,
                                             b_val.abs(), rc[check], rcn[check], k=k,
                                             b_nnz=eb.row_nnz)
            k4_calls = {"parent": lambda: parent_k4(libs["parent K4"], seg.DTYPE_CODES, *ell,
                                                    eb.row_nnz, rc, rcn, k),
                        "port": lambda: num.spgemm_numeric(*ell, rc, rcn, k=k,
                                                           b_nnz=eb.row_nnz)}
            row = {"shape": shape, "kernel": "K4", "rows": label,
                   "n_rows": int(rows.shape[0]), "products": int(fm_row[rows].sum()),
                   "c_entries": int(rcn.sum()),
                   "sparse_mm_ms": lib_ms if whole else None}
            for build in ("parent", "port", "port", "parent"):
                got = k4_calls[build]()[check]
                err = cs.tolerance_check(f"{shape} {label} K4 {build}", got, want, scale,
                                         cs.F32_TOL)
                del got
                ms = cs.time_ms(k4_calls[build])
                results.append({**row, "build": build, "ms": ms, "max_abs_err": err,
                                "checked_rows": int(check.shape[0])})
                lib_s = f", torch.sparse.mm {lib_ms:.3f} ms" if whole else ""
                print(f"{shape} K4 {label}: {row['n_rows']} rows, {row['products']} "
                      f"products, {row['c_entries']} C entries; {build}: {ms:.3f} ms"
                      f"{lib_s}; max |K4 - plain| {err:.3e} on {check.shape[0]} rows",
                      flush=True)
            del ra, rv, rn, rc, rcn, want, scale, ell
            torch.cuda.empty_cache()
        del a, b, c_idx, c_nnz, ea, eb, a_idx, a_val, b_idx, b_val, c_idx_p, bm
        torch.cuda.empty_cache()
    text = json.dumps({"device": smi, "results": results})
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

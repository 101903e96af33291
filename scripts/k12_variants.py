#!/usr/bin/env python3
"""Time K1 segsum_reuse and K2 lp_reuse against an earlier build of their
sources, in turns, on one CUDA card.

    python3 scripts/k12_variants.py --parent-dir DIR [--out results.json]
    python3 scripts/k12_variants.py --parent-rev REV  # in a git checkout

DIR holds an earlier commit's kernels/csrc/segsum_reuse.cu, lp_reuse.cu and
replay_common.cuh; --parent-rev fills build/k12_parent/ from ``git show
REV:src/repro_torch/kernels/csrc/<file>``. The script compiles those sources
under library names the port never loads (the parent's C interface: no
workspace, an output zeroed by the caller, which the parent's wrappers did
with torch.zeros), beside the port's own build. At multigrid 2048^2 A*P
(galerkin_triple(2048, 2048, 4), the plan of ReuseExecutor.from_matrices,
K1's shape on the main path) and RMAT-16 A*A (rmat_csr(16, 8), K2's), with
f32 values, it times (CUDA events, median of 7) each kernel in turns parent,
port, port, parent; beside them one cudaMemsetAsync of the f32 output (the
fill the port no longer does) and one PyTorch read of the three plan arrays'
live products (an amax of each: the plan bytes the kernels must read, as an
achieved-bandwidth yardstick the port never calls). Every output is held against replay_plain (1e-4 * S + 1e-6).
Prints the card's name and power limit, one line per measurement, and last a
JSON object of the results. Exits non-zero without a card or on a failed
check.
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
PARENT_FILES = ("segsum_reuse.cu", "lp_reuse.cu", "replay_common.cuh")
KERNELS = ("segsum_reuse", "lp_reuse")
ORDER = ["parent", "port", "port", "parent"]
# the parent's C interface (kernels/segsum_reuse.py's _ARGTYPES before the workspace)
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
PARENT_ARGS = [_P, _P, _P, _P, _INT, _I64, _P, _INT, _I64, _P, _I64, _I64, _P]


def fill_parent(rev: str, dest: Path) -> None:
    dest.mkdir(parents=True, exist_ok=True)
    for name in PARENT_FILES:
        text = subprocess.run(["git", "show", f"{rev}:src/repro_torch/kernels/csrc/{name}"],
                              cwd=ROOT, capture_output=True, text=True, check=True).stdout
        (dest / name).write_text(text)


def compile_parent(_build, parent_dir: Path) -> dict:
    """nvcc the parent's two sources, both at once beside the port's own
    build; {kernel: loaded parent library}. Each is compiled from a copy
    under a file name of its own: nvcc names a file's module and its
    anonymous namespace after the file, and two libraries of one name loaded
    in one process run one's code."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in KERNELS:
        src = parent_dir / f"{kernel}.cu"
        tag = f"k12_parent_{kernel}"
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(parent_dir.glob("*.cuh")):
            h.update(header.read_bytes())
        path = _build.BUILD_DIR / f"lib{tag}-{h.hexdigest()[:16]}.so"
        proc = tmp = None
        if not path.exists():
            copy = _build.BUILD_DIR / f"{tag}.cu"
            copy.write_bytes(src.read_bytes())
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(parent_dir),
                   "-o", str(tmp), str(copy)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        procs[kernel] = (path, tmp, proc)
    _build.build(KERNELS)
    libs = {}
    for kernel, (path, tmp, proc) in procs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the parent's {kernel}:\n{out}")
            os.replace(tmp, path)
            for line in dict.fromkeys(ln.strip() for ln in out.splitlines()
                                      if "registers" in ln or "spill" in ln):
                print(f"nvcc[parent {kernel}]: {line}", flush=True)
        libs[kernel] = ctypes.CDLL(str(path))
    return libs


def call_parent(seg_mod, lib, kernel: str, a_slot, b_slot, seg, a, b, nnz_cap):
    """One replay through the parent's library (its C interface: a zeroed
    output, no workspace)."""
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes, fn.restype = PARENT_ARGS, ctypes.c_int
    codes = seg_mod.DTYPE_CODES
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.zeros(nnz_cap, dtype=torch.float32, device="cuda")
    err = fn(a_slot.data_ptr(), b_slot.data_ptr(), seg.data_ptr(), a.data_ptr(),
             codes[a.dtype], a.shape[0], b.data_ptr(), codes[b.dtype], b.shape[0],
             out.data_ptr(), seg.shape[0], nnz_cap, stream)
    if err:
        raise RuntimeError(f"{kernel}: CUDA error {err}")
    return out


def cuda_memset():
    """cudaMemsetAsync of the CUDA toolkit's runtime, for the fill yardstick."""
    for name in ("libcudart.so", "/usr/local/cuda/lib64/libcudart.so"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise RuntimeError("libcudart.so not found")
    fn = lib.cudaMemsetAsync
    fn.argtypes, fn.restype = [_P, _INT, ctypes.c_size_t, _P], _INT
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-dir", help="the earlier sources (default build/k12_parent)")
    ap.add_argument("--parent-rev", help="fill the parent directory from this git revision")
    ap.add_argument("--out", help="also write the JSON results to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k12_variants: no CUDA device visible", file=sys.stderr)
        return 2
    parent_dir = Path(args.parent_dir or ROOT / "build" / "k12_parent")
    if args.parent_rev:
        fill_parent(args.parent_rev, parent_dir)
    missing = [f for f in PARENT_FILES if not (parent_dir / f).exists()]
    if missing:
        print(f"k12_variants: {parent_dir} lacks {missing} (give --parent-rev)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.core as rt_core
    import repro_torch.sparse as rt_sparse
    from repro_torch.kernels import _build
    from repro_torch.kernels import segsum_reuse as seg_mod
    from repro_torch.kernels import spgemm_lp as lp_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = compile_parent(_build, parent_dir)
    memset = cuda_memset()
    port = {"segsum_reuse": seg_mod.segsum_reuse_arrays, "lp_reuse": lp_mod.lp_reuse_arrays}
    g = torch.Generator(device="cuda").manual_seed(args.seed + 12)
    results = []
    for shape in ("multigrid 2048^2 A*P", "power-law A*A"):
        if shape == "power-law A*A":
            a = rt_sparse.rmat_csr(16, 8, seed=0, device="cuda")
            b, nb_live = a, 0  # one value buffer for both operands: its bytes count once
        else:
            _, a, b = rt_sparse.galerkin_triple(2048, 2048, agg_size=4, device="cuda")
            nb_live = int(b.indptr[-1])
        res = rt_core.spgemm(a, b, method="sparse", plan_cache=False)
        plan, st = res.plan, res.stats
        del res
        nnz_cap = plan.indices.shape[0]
        fm = st["fm"]
        a_vals = cs.random_values(a.nnz_cap, torch.float32, g)
        b_vals = a_vals if b is a else cs.random_values(b.nnz_cap, torch.float32, g)
        pargs = (plan.a_slot_s, plan.b_slot_s, plan.seg_ids, a_vals, b_vals)
        want = seg_mod.replay_plain(*pargs, nnz_cap)
        scale = seg_mod.replay_plain(plan.a_slot_s, plan.b_slot_s, plan.seg_ids,
                                     a_vals.abs(), b_vals.abs(), nnz_cap)
        bound, by = cs.bound_ms(fm, int(a.indptr[-1]), nb_live, st["nnz_c"])
        out = torch.empty(nnz_cap, dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        fill_ms = cs.time_ms(lambda: memset(out.data_ptr(), 0, 4 * nnz_cap, stream))
        live = [x[:fm] for x in (plan.a_slot_s, plan.b_slot_s, plan.seg_ids)]
        read_ms = cs.time_ms(lambda: [x.amax() for x in live])
        del out, live
        print(f"{shape}: fm {fm}, fm_cap {plan.seg_ids.shape[0]}, nnz(C) {st['nnz_c']}, "
              f"nnz_cap {nnz_cap}; bound {bound:.3f} ms ({by}); one cudaMemsetAsync of the "
              f"output {fill_ms:.3f} ms; torch read of the live plan (12 B x fm) {read_ms:.3f} "
              f"ms = {12 * fm / read_ms / 1e9:.2f} TB/s", flush=True)
        results.append({"shape": shape, "kernel": "fill of the f32 output (cudaMemsetAsync)",
                        "build": "cudart", "ms": fill_ms})
        results.append({"shape": shape, "kernel": "torch read of the live plan",
                        "build": "torch", "ms": read_ms, "bytes": 12 * fm})
        for kernel in KERNELS:
            for build in ORDER:
                if build == "port":
                    run = lambda k=kernel: port[k](*pargs, nnz_cap=nnz_cap)  # noqa: E731
                else:
                    run = (lambda k=kernel, lib=libs[kernel]:  # noqa: E731
                           call_parent(seg_mod, lib, k, *pargs, nnz_cap))
                got = run()
                err = cs.tolerance_check(f"{shape} {kernel} {build}", got, want, scale,
                                         cs.F32_TOL)
                del got
                ms = cs.time_ms(run)
                results.append({"shape": shape, "kernel": kernel, "build": build, "ms": ms,
                                "bound_ms": bound, "max_abs_err": err})
                print(f"{shape} {kernel} {build}: {ms:.3f} ms "
                      f"(bound {bound:.3f} ms, {bound / ms:.2f} of it); max |kernel - plain| "
                      f"{err:.3e}", flush=True)
        del plan, want, scale, pargs, a_vals, b_vals, a, b
        torch.cuda.empty_cache()
    text = json.dumps({"device": smi, "results": results})
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

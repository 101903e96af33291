#!/usr/bin/env python3
"""Time K6 bsr_spgemm against an earlier build of its source, in turns, on
one CUDA card.

    python3 scripts/k6_variants.py --parent-dir DIR [--out results.json]
    python3 scripts/k6_variants.py --parent-rev REV  # in a git checkout

DIR holds an earlier commit's kernels/csrc/bsr_spgemm.cu and
replay_common.cuh; --parent-rev fills build/k6_parent/ from ``git show
REV:src/repro_torch/kernels/csrc/<file>``. The script compiles the parent's
source from a copy under a file name of its own (two libraries built from
files of one name, loaded in one process, run one's code) beside the port's
own build; both take the same C interface. At the block multigrid (the
5-point operator of galerkin_triple(512, 512, 4) squared at block
granularity, the plan of plan_bsr_numeric: chip_smoke.py's phase 10) it
times (CUDA events, median of 7) bs 8 f32, bs 8 bf16 and bs 16 f32 in turns
parent, port, port, parent, each beside its bound (A's blocks, the plan and
C once at 3.35 TB/s, against 2 * bs^3 flops a product at 67 TFLOP/s) and one
PyTorch copy of as many bytes as the bound counts (an achieved-bandwidth
yardstick the port never calls). Every output is held against
bsr_spgemm_plain (1e-4 * S + 1e-6 in f32, 8e-3 * S + 1e-6 in bf16). Prints
the card's name and power limit, one line per measurement, and last a JSON
object of the results. Exits non-zero without a card or on a failed check.
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
PARENT_FILES = ("bsr_spgemm.cu", "replay_common.cuh")
ORDER = ["parent", "port", "port", "parent"]
CASES = ((8, torch.float32), (8, torch.bfloat16), (16, torch.float32))


def fill_parent(rev: str, dest: Path) -> None:
    dest.mkdir(parents=True, exist_ok=True)
    for name in PARENT_FILES:
        text = subprocess.run(["git", "show", f"{rev}:src/repro_torch/kernels/csrc/{name}"],
                              cwd=ROOT, capture_output=True, text=True, check=True).stdout
        (dest / name).write_text(text)


def compile_parent(_build, parent_dir: Path) -> ctypes.CDLL:
    """nvcc the parent's source, from a copy named k6_parent_bsr_spgemm.cu,
    while the port's own library builds; the loaded parent library."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = parent_dir / "bsr_spgemm.cu"
    tag = "k6_parent_bsr_spgemm"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(parent_dir.glob("*.cuh")):
        h.update(header.read_bytes())
    path = _build.BUILD_DIR / f"lib{tag}-{h.hexdigest()[:16]}.so"
    proc = tmp = None
    if not path.exists():
        copy = _build.BUILD_DIR / f"{tag}.cu"
        copy.write_bytes(src.read_bytes())
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(parent_dir), "-o", str(tmp),
               str(copy)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(("bsr_spgemm",))
    for line in dict.fromkeys(ln.strip() for ln in _build.BUILD_LOG.get("bsr_spgemm", "").splitlines()
                              if "registers" in ln or "spill" in ln):
        print(f"nvcc[port]: {line}", flush=True)
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's bsr_spgemm:\n{out}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))


def call_parent(k6, lib, a, b, ca, cb, cn):
    """One numeric phase through the parent's library."""
    fn = lib.bsr_spgemm_launch
    fn.argtypes, fn.restype = k6._ARGTYPES, ctypes.c_int
    nnzb_c, t_max = ca.shape
    bs = a.shape[1]
    out = torch.empty(nnzb_c, bs, bs, dtype=a.dtype, device=a.device)
    err = fn(a.data_ptr(), k6.DTYPE_CODES[a.dtype], a.shape[0], b.data_ptr(),
             k6.DTYPE_CODES[b.dtype], b.shape[0], ca.data_ptr(), cb.data_ptr(), cn.data_ptr(),
             nnzb_c, t_max, out.data_ptr(), bs, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent bsr_spgemm: CUDA error {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-dir", help="the earlier sources (default build/k6_parent)")
    ap.add_argument("--parent-rev", help="fill the parent directory from this git revision")
    ap.add_argument("--grid", type=int, default=512, help="the block grid (default 512)")
    ap.add_argument("--out", help="also write the JSON results to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device visible", file=sys.stderr)
        return 2
    parent_dir = Path(args.parent_dir or ROOT / "build" / "k6_parent")
    if args.parent_rev:
        fill_parent(args.parent_rev, parent_dir)
    missing = [f for f in PARENT_FILES if not (parent_dir / f).exists()]
    if missing:
        print(f"k6_variants: {parent_dir} lacks {missing} (give --parent-rev)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.sparse as rt_sparse
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_spgemm as k6

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lib = compile_parent(_build, parent_dir)
    _, a, _ = rt_sparse.galerkin_triple(args.grid, args.grid, agg_size=4, device="cuda")
    nnzb = int(a.indptr[-1])
    ip, ix = a.indptr, a.indices[:nnzb].contiguous()
    plan = k6.plan_bsr_numeric(ip, ix, ip, ix)
    ca, cb, cn = plan[2:]
    nnzb_c, t_max = ca.shape
    contribs = int(cn.sum())
    g = torch.Generator(device="cuda").manual_seed(args.seed + 6)
    print(f"block multigrid {args.grid}^2: {ip.shape[0] - 1} block rows, {nnzb} A blocks, "
          f"{nnzb_c} C blocks, T_max {t_max}, {contribs} block products", flush=True)
    results = []
    for bs, dt in CASES:
        name = f"bs {bs} {cs.DT_NAME[dt]}"
        v = torch.randn(nnzb, bs, bs, generator=g, device="cuda").to(dt)
        spans = k6.tile_a_spans(ca, cn, bs, nnzb)
        staged = float((spans <= k6.A_SPAN_BLOCKS[bs]).float().mean())
        want = k6.bsr_spgemm_plain(v, v, ca, cb, cn)
        scale = k6.bsr_spgemm_plain(v.abs(), v.abs(), ca, cb, cn)
        item = v.element_size()
        moved = v.numel() * item + (2 * t_max + 1) * nnzb_c * 4 + nnzb_c * bs * bs * item
        t_bytes = moved / cs.HBM_BYTES_PER_S * 1e3
        t_ops = 2 * bs ** 3 * contribs / cs.F32_FLOPS_PER_S * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        src = torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = cs.time_ms(lambda: dst.copy_(src))
        del src, dst
        print(f"{name}: bound {bound:.3f} ms ({by}; bytes {t_bytes:.3f}, operations "
              f"{t_ops:.3f}); tiles with the A span staged {staged:.4f}; torch copy of "
              f"{moved / 1e6:.1f} MB {copy_ms:.3f} ms = {moved / copy_ms / 1e9:.2f} TB/s",
              flush=True)
        results.append({"case": name, "build": "torch copy of the bound's bytes", "ms": copy_ms,
                        "bytes": moved})
        tol = cs.F32_TOL if dt == torch.float32 else cs.BF16_TOL
        for build in ORDER:
            if build == "port":
                run = lambda: k6.bsr_spgemm_numeric(v, v, ca, cb, cn)  # noqa: E731
            else:
                run = lambda: call_parent(k6, lib, v, v, ca, cb, cn)  # noqa: E731
            got = run()
            err = cs.tolerance_check(f"{name} {build}", got, want, scale, tol)
            del got
            ms = cs.time_ms(run)
            results.append({"case": name, "build": build, "ms": ms, "bound_ms": bound,
                            "bound_by": by, "max_abs_err": err})
            print(f"{name} {build}: {ms:.3f} ms ({bound / ms:.2f} of the bound, "
                  f"{moved / ms / 1e9:.2f} TB/s of the bound's bytes); max |kernel - plain| "
                  f"{err:.3e}", flush=True)
        del v, want, scale
        torch.cuda.empty_cache()
    text = json.dumps({"device": smi, "results": results})
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

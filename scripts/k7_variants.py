#!/usr/bin/env python3
"""Time K7 grouped_matmul's variants against each other on one CUDA card.

    python3 scripts/k7_variants.py [--out results.json]

The port's library runs the variant that grouped_matmul.cu's launcher picks
by the dtype pair ("wgmma" for bf16 x bf16 and f16 x f16, "tf32" -- split
TF32 on wgmma -- for the others). This script also compiles copies of the
same source with -DGROUPED_MATMUL_FORCE_VARIANT=1, which runs every pair on
the f32-tile "fma" kernel (how f32 and the mixed pairs ran before the
"tf32" variant, and bf16 and f16 before "wgmma"), and with =2, which runs
the "tf32" pairs on "mma" (the same split on mma.sync), each under a file
and library name of its own that the port never loads (two libraries built
from files of one name must not share a process). At the qwen3-moe-30b-a3b
shapes of
chip_smoke.py's phase 11 (4,096 tokens routed top-8 over 128 experts, 40,576
padded rows), the up projection x @ w1 (d 2,048 -> 768) and the down
projection (768 -> 2,048, on x @ w1's output), for each (x, w) dtype pair of
PAIRS, it holds each build's output against the plain version
(chip_smoke.py's K7_TOL and K7_FRO) and times it twice, in turns (CUDA
events, median of 7 each: port, comparisons, comparisons reversed, port)
beside the
bound of the port's variant (chip_smoke.k7_bound) and, where x and w share
a dtype, torch.bmm over the gathered expert weights (the gather not timed;
f32 in full f32). Prints the card's name and power limit, one line per
(shape, pair, build), and last a JSON object of the results. Exits non-zero
without a card or on a failed check.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# the comparison builds: name -> the macro defined for it
COMPARISONS = {"fma": "GROUPED_MATMUL_FORCE_VARIANT=1", "mma": "GROUPED_MATMUL_FORCE_VARIANT=2"}
# (x, w) dtype pairs: both wgmma pairs, then tf32 at 3, 2, 2 and 1 products
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
         (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float16))


def build_comparisons(_build) -> dict:
    """One nvcc per comparison build, each from a copy of the source named
    after it, all at once beside the port's own build; returns {name:
    ctypes library}."""
    src = _build.CSRC_DIR / "grouped_matmul.cu"
    tag = _build.library_path("grouped_matmul").stem.split("-")[-1]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, define in COMPARISONS.items():
        stem = f"k7_{name}_grouped_matmul"
        path = _build.BUILD_DIR / f"lib{stem}-{tag}.so"
        proc = tmp = None
        if not path.exists():
            copy = _build.BUILD_DIR / f"{stem}.cu"
            copy.write_bytes(src.read_bytes())
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-D{define}", "-I",
                   str(_build.CSRC_DIR), "-o", str(tmp), str(copy)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        procs[name] = (path, tmp, proc)
    _build.build(("grouped_matmul",))
    libs = {}
    for name, (path, tmp, proc) in procs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the {name} build:\n{out}")
            os.replace(tmp, path)
        libs[name] = ctypes.CDLL(str(path))
    return libs


def comparison_call(lib, gm):
    """grouped_matmul(x, w, block_expert) through a comparison library."""
    fn = lib.grouped_matmul_launch
    fn.argtypes, fn.restype = gm._ARGTYPES, ctypes.c_int

    def call(x, w, be):
        t, d = x.shape
        e, _, f = w.shape
        out = torch.empty(t, f, dtype=x.dtype, device=x.device)
        err = fn(x.data_ptr(), gm.DTYPE_CODES[x.dtype], w.data_ptr(), gm.DTYPE_CODES[w.dtype],
                 be.data_ptr(), out.data_ptr(), t, d, f, e,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"comparison grouped_matmul launch failed: CUDA error {err}")
        return out
    return call


def variant_name(lib, gm, x_dtype, w_dtype) -> str:
    fn = lib.grouped_matmul_variant
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_char_p
    return fn(gm.DTYPE_CODES[x_dtype], gm.DTYPE_CODES[w_dtype]).decode()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON results to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.configs as rt_configs
    from repro_torch.kernels import _build

    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = build_comparisons(_build)
    for fn, regs, spills in cs.ptxas_functions(_build.BUILD_LOG.get("grouped_matmul", "")):
        print(f"nvcc[grouped_matmul]: {fn}: {regs} registers, {spills}", flush=True)
    calls = {"port": gm.grouped_matmul}
    calls.update({name: comparison_call(lib, gm) for name, lib in libs.items()})

    cfg = rt_configs.get_config("qwen3-moe-30b-a3b")
    d, f, n_exp, top_k = cfg.d_model, cfg.moe_d_ff, cfg.num_experts, cfg.experts_per_token
    g = torch.Generator(device="cuda").manual_seed(args.seed + 40)
    rows, tokens, be, n_rows = cs.moe_layout(4096, n_exp, top_k, g, "cuda")
    used = int((torch.bincount(be.long(), minlength=n_exp) > 0).sum())
    x = torch.zeros(n_rows, d, device="cuda")
    x[rows] = torch.randn(4096, d, generator=g, device="cuda")[tokens]
    w1 = torch.randn(n_exp, d, f, generator=g, device="cuda") * 0.02
    w2 = torch.randn(n_exp, f, d, generator=g, device="cuda") * 0.02
    results = []
    for xd, wd in PAIRS:
        pair = cs.pair_name(xd, wd)
        xi, w1d, w2d = x.to(xd), w1.to(wd), w2.to(wd)
        y1 = gm.grouped_matmul(xi, w1d, be)
        for proj, (xp, w) in (("x@w1", (xi, w1d)), ("down", (y1, w2d))):
            label = f"{cfg.name} {n_rows} rows {proj} {pair}"
            want = gm.grouped_matmul_plain(xp, w, be)
            flops = 2 * n_rows * xp.shape[1] * w.shape[2]
            bound, bound_by = cs.k7_bound(gm, xp, w, n_rows, used)
            bmm_ms = None
            if xd == wd:
                wg = w[be.long()]  # the yardstick's gather, outside the timing
                xb = xp.view(-1, 128, xp.shape[1])
                bmm_ms = cs.time_ms(lambda: torch.bmm(xb, wg))
                del wg
            # each build timed twice, in turns: port, others, others reversed, port
            for name in list(calls) + list(calls)[::-1]:
                call = calls[name]
                ran = gm.variant(xd, wd) if name == "port" else variant_name(libs[name], gm, xd, wd)
                got = call(xp, w, be)
                err, rel, ok = cs.close_excess(got, want, cs.K7_TOL[xd], cs.K7_FRO[xd])
                if not ok:
                    raise SystemExit(f"{label} {name} ({ran}): max |kernel - plain| {err:.3e}, "
                                     f"relative Frobenius {rel:.3e}: outside K7_TOL / K7_FRO")
                ms = cs.time_ms(lambda: call(xp, w, be))
                results.append({"shape": label, "proj": proj, "pair": pair, "build": name,
                                "variant": ran, "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                                "products": gm.products(xd, wd) if name == "port" else 0,
                                "bmm_ms": bmm_ms, "max_abs_err": err, "rel_fro": rel})
                bmm_s = f"torch.bmm {bmm_ms:.3f} ms" if bmm_ms is not None else "no torch.bmm"
                print(f"{label}: {name} build, variant {ran}: {ms:.3f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s of the contract, bound {bound:.3f} ms "
                      f"({bound_by}), {bmm_s}); max |kernel - plain| {err:.3e}, relative "
                      f"Frobenius {rel:.3e}", flush=True)
                del got
            del want
        del xi, w1d, w2d, y1
        torch.cuda.empty_cache()
    text = json.dumps({"device": smi, "n_rows": n_rows, "results": results})
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

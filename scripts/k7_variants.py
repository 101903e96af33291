#!/usr/bin/env python3
"""Time K7 grouped_matmul's variants against each other on one CUDA card.

    python3 scripts/k7_variants.py [--out results.json]

The port's library runs the variant that grouped_matmul.cu's launcher picks
by the dtype pair ("wgmma" for bf16 x bf16 and f16 x f16, "fma" for the
others). This script also compiles the same source with
-DGROUPED_MATMUL_FORCE_VARIANT=1 (bf16 and f16 on the f32-tile "fma"
kernel, which is how every dtype ran before the tensor-core variant), under
a library name that the port never loads. At the qwen3-moe-30b-a3b
shapes of chip_smoke.py's phase 11 (4,096 tokens routed top-8 over 128
experts, 40,576 padded rows), the up projection x @ w1 (d 2,048 -> 768) and
the down projection (768 -> 2,048, on x @ w1's output), in bf16 and f16, it
holds each build's output against the plain version (chip_smoke.py's K7_TOL
and K7_FRO) and times it twice, in turns (CUDA events, median of 7 each:
port, comparisons, comparisons reversed, port) beside torch.bmm over
the gathered expert weights (the gather not timed). Prints the card's name
and power limit, one line per (shape, build), and last a JSON object of the
results. Exits non-zero without a card or on a failed check.
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
COMPARISONS = {"fma": "GROUPED_MATMUL_FORCE_VARIANT=1"}


def build_comparisons(_build) -> dict:
    """One nvcc per comparison build, all at once beside the port's own
    build; returns {name: ctypes library}."""
    src = _build.CSRC_DIR / "grouped_matmul.cu"
    tag = _build.library_path("grouped_matmul").stem.split("-")[-1]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, define in COMPARISONS.items():
        path = _build.BUILD_DIR / f"libgrouped_matmul_{define.lower().replace('=', '')}-{tag}.so"
        proc = tmp = None
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
                   f"-D{define}", "-o", str(tmp), str(src)]
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
    for dt in (torch.bfloat16, torch.float16):
        xd, w1d, w2d = x.to(dt), w1.to(dt), w2.to(dt)
        y1 = gm.grouped_matmul(xd, w1d, be)
        for proj, (xi, w) in (("x@w1", (xd, w1d)), ("down", (y1, w2d))):
            label = f"{cfg.name} {n_rows} rows {proj} {cs.DT_NAME[dt]}"
            want = gm.grouped_matmul_plain(xi, w, be)
            flops = 2 * n_rows * xi.shape[1] * w.shape[2]
            t_bytes = ((xi.numel() + used * w[0].numel() + n_rows * w.shape[2])
                       * xi.element_size() / cs.HBM_BYTES_PER_S * 1e3)
            bound = max(t_bytes, flops / cs.BF16_FLOPS_PER_S * 1e3)
            wg = w[be.long()]  # the yardstick's gather, outside the timing
            xb = xi.view(-1, 128, xi.shape[1])
            bmm_ms = cs.time_ms(lambda: torch.bmm(xb, wg))
            del wg
            # each build timed twice, in turns: port, others, others reversed, port
            for name in list(calls) + list(calls)[::-1]:
                call = calls[name]
                ran = gm.variant(dt, dt) if name == "port" else variant_name(libs[name], gm, dt, dt)
                got = call(xi, w, be)
                err, rel, ok = cs.close_excess(got, want, cs.K7_TOL[dt], cs.K7_FRO[dt])
                if not ok:
                    raise SystemExit(f"{label} {name} ({ran}): max |kernel - plain| {err:.3e}, "
                                     f"relative Frobenius {rel:.3e}: outside K7_TOL / K7_FRO")
                ms = cs.time_ms(lambda: call(xi, w, be))
                results.append({"shape": label, "proj": proj, "dtype": cs.DT_NAME[dt],
                                "build": name, "variant": ran, "ms": ms, "bound_ms": bound,
                                "bmm_ms": bmm_ms, "max_abs_err": err, "rel_fro": rel})
                print(f"{label}: {name} build, variant {ran}: {ms:.3f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s, bound {bound:.3f} ms, torch.bmm "
                      f"{bmm_ms:.3f} ms); max |kernel - plain| {err:.3e}, relative Frobenius "
                      f"{rel:.3e}", flush=True)
            del want
        del xd, w1d, w2d, y1
        torch.cuda.empty_cache()
    text = json.dumps({"device": smi, "n_rows": n_rows, "results": results})
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

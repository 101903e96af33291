#!/usr/bin/env python3
"""Time K8 flash attention's variants against each other on one CUDA card.

    python3 scripts/k8_variants.py [--f32-only] [--out results.json]

The port's library runs the variant that flash_attention.cu's launcher picks
by dtype and head dim ("wgmma" for bf16/f16 at D 64-256, "mma" at D 16 and
32, "tf32" for f32 at D 64-256). This script also compiles the same source
twice more, with -DFLASH_ATTENTION_FORCE_VARIANT=1 (every dtype on the
f32-tile "fma" kernel at every D, which is how every dtype ran before the
tensor-core variants and how f32 ran before "tf32") and =2 (bf16/f16 on
"mma" at every D), under other library names that the port never loads.

f32: at chip_smoke.py phase 12's three f32 shapes (T 8,192: gemma2-9b local
and global, llama3.2-1b) and at qwen3-moe-30b-a3b widths (D 128), the
port's build and the "fma" build in turns (port, fma, fma, port), beside
scaled_dot_product_attention in f32 where there is no softcap, with both
bounds: three TF32 products at 495 TFLOP/s and one pass of f32 FMAs at 67
TFLOP/s. bf16 (skipped with
--f32-only): the phase 12 bf16 shapes, D 32 and 16 with llama3.2-1b's
heads, and gemma2-9b global widths with q and k scaled by 8 (scores in the
hundreds, so the softcap's tanh saturates), each build once, beside SDPA
where there is no softcap. Every output is held against the plain version
(chip_smoke.py's K8_TOL and K8_FRO) and timed (CUDA events, median of 7).
Prints the card's name and power limit, one line per (shape, build), and
last a JSON object of the results. Exits non-zero without a card or on a
failed check.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FORCED = {"fma": 1, "mma": 2}  # FLASH_ATTENTION_FORCE_VARIANT of each comparison build
T = 8192


def build_forced(_build) -> dict:
    """One nvcc per forced variant, all at once beside the port's own build;
    returns {variant: ctypes library}."""
    src = _build.CSRC_DIR / "flash_attention.cu"
    tag = _build.library_path("flash_attention").stem.split("-")[-1]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, code in FORCED.items():
        path = _build.BUILD_DIR / f"libflash_attention_force_{name}-{tag}.so"
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
                   f"-DFLASH_ATTENTION_FORCE_VARIANT={code}", "-o", str(tmp), str(src)]
            procs[name] = (path, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True))
        else:
            procs[name] = (path, None, None)
    _build.build(("flash_attention",))
    libs = {}
    for name, (path, tmp, proc) in procs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the forced {name} build:\n{out}")
            os.replace(tmp, path)
        libs[name] = ctypes.CDLL(str(path))
    return libs


def forced_call(lib, fa):
    """flash_attention(q, k, v, **kw) through a comparison library."""
    fn = lib.flash_attention_launch
    fn.argtypes, fn.restype = fa._ARGTYPES, ctypes.c_int

    def call(q, k, v, causal=True, window=None, softcap=None):
        hq, tq, d = q.shape
        hkv, tk, _ = k.shape
        out = torch.empty_like(q)
        nbytes = fa.scratch_bytes(lib, q.dtype, hkv, tk, d)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 fa.DTYPE_CODES[q.dtype], hq, hkv, tq, tk, d, 1.0 / math.sqrt(d), int(causal),
                 int(window is not None), 0 if window is None else int(window),
                 0.0 if softcap is None else float(softcap),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forced flash_attention launch failed: CUDA error {err}")
        return out
    return call


def variant_name(lib, fa, dtype, d) -> str:
    fn = lib.flash_attention_variant
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_char_p
    return fn(fa.DTYPE_CODES[dtype], d).decode()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f32-only", action="store_true",
                    help="only the f32 shapes (port and fma builds in turns)")
    ap.add_argument("--out", help="also write the JSON results to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.configs as rt_configs
    from repro_torch.kernels import _build
    import torch.nn.functional as F

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = build_forced(_build)
    calls = {"port": fa.flash_attention}
    calls.update({name: forced_call(lib, fa) for name, lib in libs.items()})

    class rt:
        get_config = staticmethod(rt_configs.get_config)

    lla = rt.get_config("llama3.2-1b")
    gem = rt.get_config("gemma2-9b")
    shapes = [(label, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, kw, 1.0, sdpa)
              for label, cfg, kw, dt, sdpa in cs.attention_shapes(rt) if dt == torch.bfloat16]
    for d in (32, 16):
        shapes.append((f"llama3.2-1b heads at D {d}", lla.num_heads, lla.num_kv_heads, d,
                       dict(causal=True), 1.0, True))
    shapes.append(("gemma2-9b global bf16, q and k x 8", gem.num_heads, gem.num_kv_heads,
                   gem.resolved_head_dim, dict(causal=True, window=None,
                                               softcap=gem.attn_softcap), 8.0, False))
    g = torch.Generator(device="cuda").manual_seed(14)
    results = []

    def check(label, name, ran, got, want, dt):
        err, rel, ok = cs.close_excess(got, want, cs.K8_TOL[dt], cs.K8_FRO[dt])
        if not ok:
            raise SystemExit(f"{label} {name} ({ran}): max |kernel - plain| {err:.3e}, "
                             f"relative Frobenius {rel:.3e}: outside K8_TOL / K8_FRO")
        return err, rel

    qwe = rt.get_config("qwen3-moe-30b-a3b")
    f32_shapes = [(label, cfg, kw, sdpa) for label, cfg, kw, dt, sdpa in cs.attention_shapes(rt)
                  if dt == torch.float32]
    # D 128, which no phase 12 f32 shape has
    f32_shapes.append(("qwen3-moe-30b-a3b f32", qwe, dict(causal=True), True))
    for label, cfg, kw, sdpa in f32_shapes:
        dt = torch.float32
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = (torch.randn(h, T, d, generator=g, device="cuda") for h in (hq, hkv, hkv))
        want = fa.flash_attention_plain(q, k, v, **kw)
        flops = 4 * d * hq * cs.live_pairs(T, kw.get("causal", True), kw.get("window"))
        bound_tf32 = 3 * flops / cs.TF32_FLOPS_PER_S * 1e3
        bound_fma = flops / cs.F32_FLOPS_PER_S * 1e3
        sdpa_ms = None
        if sdpa:
            sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, enable_gqa=True))
        for turn, name in enumerate(("port", "fma", "fma", "port")):  # in turns
            call = calls[name]
            ran = fa.variant(dt, d) if name == "port" else variant_name(libs[name], fa, dt, d)
            err, rel = check(label, name, ran, call(q, k, v, **kw), want, dt)
            ms = cs.time_ms(lambda: call(q, k, v, **kw))
            results.append({"shape": label, "hq": hq, "hkv": hkv, "d": d, "kw": kw, "amp": 1.0,
                            "dtype": "f32", "turn": turn, "build": name, "variant": ran,
                            "ms": ms, "bound_ms": bound_tf32, "fma_bound_ms": bound_fma,
                            "sdpa_ms": sdpa_ms, "max_abs_err": err, "rel_fro": rel})
            sdpa_s = f", SDPA f32 {sdpa_ms:.3f} ms" if sdpa_ms is not None else ""
            print(f"{label}: turn {turn}, {name} build, variant {ran}: {ms:.3f} ms (split-TF32 "
                  f"bound {bound_tf32:.3f} ms, share {bound_tf32 / ms:.3f}; f32-FMA bound "
                  f"{bound_fma:.3f} ms{sdpa_s}); max |kernel - plain| {err:.3e}, relative "
                  f"Frobenius {rel:.3e}", flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    if args.f32_only:
        shapes = []
    dt = torch.bfloat16
    for label, hq, hkv, d, kw, amp, sdpa in shapes:
        q, k, v = ((torch.randn(h, T, d, generator=g, device="cuda") * a).to(dt)
                   for h, a in ((hq, amp), (hkv, amp), (hkv, 1.0)))
        want = fa.flash_attention_plain(q, k, v, **kw)
        flops = 4 * d * hq * cs.live_pairs(T, kw.get("causal", True), kw.get("window"))
        bound = flops / cs.BF16_FLOPS_PER_S * 1e3
        sdpa_ms = None
        if sdpa:
            sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, enable_gqa=True))
        for name, call in calls.items():
            ran = fa.variant(dt, d) if name == "port" else variant_name(libs[name], fa, dt, d)
            err, rel = check(label, name, ran, call(q, k, v, **kw), want, dt)
            ms = cs.time_ms(lambda: call(q, k, v, **kw))
            row = {"shape": label, "hq": hq, "hkv": hkv, "d": d, "kw": kw, "amp": amp,
                   "dtype": "bf16", "build": name, "variant": ran, "ms": ms, "bound_ms": bound,
                   "sdpa_ms": sdpa_ms, "max_abs_err": err, "rel_fro": rel}
            results.append(row)
            sdpa_s = f", SDPA {sdpa_ms:.3f} ms" if sdpa_ms is not None else ""
            print(f"{label}: {name} build, variant {ran}: {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, bound {bound:.3f} ms{sdpa_s}); "
                  f"max |kernel - plain| {err:.3e}, relative Frobenius {rel:.3e}", flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    text = json.dumps({"device": smi, "t": T, "results": results})
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Accumulator crossover on the PyTorch port: the paper's KKLP position, end
to end.

The port of examples/accumulator_crossover.py. The meta-algorithm
(core/meta.py, the paper's §3.3 GPU rule) keys numeric-phase kernel
selection on average row flops: modest rows go to the dense accumulator,
flop-heavy rows (>= 256) to the linear-probing hash accumulator. This script
walks the whole wiring; on the card every step runs a CUDA kernel:

  1. choose_kernel's decision on both sides of the cutoff;
  2. spgemm(method="lp"): values from the LP-hash replay kernel K2;
  3. a pinned ReuseExecutor replaying through backend="pallas_lp" (K2)
     against backend="xla", the plain replay;
  4. the spill path: the LP-hash numeric kernel K3 with a deliberately tiny
     L1 table, against its plain version, which adds each key's products in
     the order of the insert stream as the reference's accumulator oracle
     does. On the CPU the wrapper runs that plain version, and the check is
     bitwise; on the card K3 adds with atomics, so the check is the port's
     f32 tolerance (|K3 - plain| <= 1e-4 * S + 1e-6, S the product of
     absolute values), and the printed line says which bar was held.

Runs on the card by default; --device cpu runs it on the CPU:

    PYTHONPATH=src python examples/torch_accumulator_crossover.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import PlanCache, ReuseExecutor, choose_kernel, spgemm
from repro_torch.kernels.ops import resolve_numeric_kernel
from repro_torch.kernels.spgemm_lp import spgemm_lp, spgemm_lp_plain
from repro_torch.sparse import dense_spgemm_oracle, gustavson_ell_structure, random_csr
from repro_torch.sparse.formats import csr_to_ell

F32_TOL = (1e-4, 1e-6)  # |kernel - plain| <= 1e-4 * S + 1e-6: f32 adds in another order
L1_SIZE = 8


def pick_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The asked device; ``ap.error`` (exit 2) for a card that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return device


def operands(device):
    """{"modest rows": (A, B), "flop-heavy rows": (A, B)}, the reference's
    seeds."""
    return {"modest rows": (random_csr(64, 64, 3.0, 1, device=device),
                            random_csr(64, 64, 3.0, 2, device=device)),
            "flop-heavy rows": (random_csr(4, 32, 16.0, 3, device=device),
                                random_csr(32, 64, 32.0, 4, device=device))}


def crossover(a, b):
    """Step 1 on one side: (avg row flops, choose_kernel, the numeric
    kernel that resolve_numeric_kernel gives)."""
    res = spgemm(a, b, method="sparse", plan_cache=PlanCache())
    fm = res.stats["fm"]
    return fm / a.m, choose_kernel(a, b, {"fm": fm}), resolve_numeric_kernel(a, b)


def lp_multiply(a, b):
    """Step 2: spgemm(method="lp") and its max |error| against the dense
    oracle."""
    res = spgemm(a, b, method="lp", plan_cache=PlanCache())
    err = np.abs(res.c.to_dense().cpu().numpy() - dense_spgemm_oracle(a, b)).max()
    return res, float(err)


def lp_replays(plan, a, b, steps: int = 3):
    """Step 3: ``steps`` seeded replays through "pallas_lp" and "xla";
    yields (pallas_lp values, xla values)."""
    ex = ReuseExecutor(plan, backend="pallas_lp")
    ex_xla = ReuseExecutor(plan, backend="xla")
    rng = np.random.default_rng(0)
    for _ in range(steps):
        av = torch.from_numpy(rng.standard_normal(a.nnz_cap).astype(np.float32)).to(a.device)
        bv = torch.from_numpy(rng.standard_normal(b.nnz_cap).astype(np.float32)).to(b.device)
        yield ex.apply(av, bv), ex_xla.apply(av, bv)


def spill(a, b, l1_size: int = L1_SIZE):
    """Step 4: K3 with an L1 of ``l1_size`` slots, its plain version on the
    same ELL operands, and the plain version on absolute values (the
    tolerance's scale). Returns (got, want, scale)."""
    ea, eb = csr_to_ell(a), csr_to_ell(b)
    c_idx, c_nnz = (torch.from_numpy(x).to(a.device) for x in gustavson_ell_structure(a, b))
    args = (ea.indices, ea.values, ea.row_nnz, eb.indices, eb.values, eb.row_nnz, c_idx, c_nnz)
    got = spgemm_lp(*args, l1_size=l1_size)
    want = spgemm_lp_plain(*args, l1_size=l1_size)
    scale = spgemm_lp_plain(ea.indices, ea.values.abs(), ea.row_nnz, eb.indices,
                            eb.values.abs(), eb.row_nnz, c_idx, c_nnz, l1_size=l1_size)
    return got, want, scale


def spill_check(got, want, scale) -> tuple[bool, str]:
    """Step 4's bar: bitwise on the CPU, F32_TOL on the card. Returns
    (held, what the bar was)."""
    if got.device.type == "cpu":
        return torch.equal(got, want), "bitwise == accumulator oracle"
    err = (got.double() - want.double()).abs()
    held = bool((err <= F32_TOL[0] * scale.double() + F32_TOL[1]).all())
    return held, (f"within F32_TOL of the accumulator oracle (K3's atomics; max |err| "
                  f"{float(err.max()):.2e})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = pick_device(ap, ap.parse_args(argv).device)
    ops = operands(device)

    # 1. both sides of the avg-row-flops cutoff
    for label, (a, b) in ops.items():
        arf, pick, kernel = crossover(a, b)
        print(f"{label}: avg row flops {arf:.1f} -> choose_kernel={pick}, "
              f"numeric kernel={kernel}")

    # 2. spgemm(method="lp"): the KKLP position on the plan pipeline
    heavy_a, heavy_b = ops["flop-heavy rows"]
    res, err = lp_multiply(heavy_a, heavy_b)
    print(f"spgemm(method='lp'): backend={res.stats['lp_backend']}, "
          f"max |err| vs dense oracle = {err:.2e}")
    assert err < 1e-4

    # 3. pinned replay through the LP accumulator
    for step, (lp_vals, xla_vals) in enumerate(lp_replays(res.plan, heavy_a, heavy_b)):
        err = float((lp_vals - xla_vals).abs().max())
        print(f"replay {step}: pallas_lp vs xla max |err| = {err:.2e}")
        assert err < 1e-5

    # 4. spill: L1 of 8 slots (cutoff 4) against rows with ~32 distinct
    # columns; most keys overflow to L2
    held, bar = spill_check(*spill(heavy_a, heavy_b))
    print(f"spill path (l1_size={L1_SIZE}): {bar}: {held}")
    assert held
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

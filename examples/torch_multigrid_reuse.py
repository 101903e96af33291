"""The paper's headline application scenario on the PyTorch port: multigrid
setup with structure reuse (§4, Reuse case).

The port of examples/multigrid_reuse.py. An AMG-style solver recomputes
A_coarse = R*A*P every time matrix VALUES change (nonlinear solves, time
stepping) while the STRUCTURE stays fixed. Two-phase SpGEMM pays symbolic
once; from then on a ``ReuseExecutor`` pins each plan (one structure hash,
ever) and replays the numeric phase as one dispatch per multiply, or ONE
batched dispatch for a whole ensemble of timesteps (``apply_batched``).

On the card the setup's two fresh multiplies take their numeric phase from
the CUDA kernel K1, and the executors' default "auto" backend replays
through K1 too (a batch through K1's batched launch), as every f32 replay
on the card does; on the CPU "auto" is the plain torch replay, as the
reference's. Times are host clock around synchronised calls. Runs on the
card by default; --device cpu runs it on the CPU:

    PYTHONPATH=src python examples/torch_multigrid_reuse.py [--device cpu]

The distributed version of this scenario, the same pinned plans sharded
over a mesh through ``repro_torch.dist.ShardedReuseExecutor``, is
examples/torch_dist_multigrid.py.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import ReuseExecutor, spgemm
from repro_torch.sparse import CSR, galerkin_triple

STEPS = 5
BATCH = 8


def pick_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The asked device; ``ap.error`` (exit 2) for a card that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return device


def sync(device) -> None:
    """Wait for the card (the reference's ``block_until_ready``)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def values_on(device, x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(device)


def setup(device):
    """NoReuse: symbolic + numeric once, and executors pinning both plans.
    Returns (r, a, p, ap, rap, ex_ap, ex_rap, setup seconds)."""
    r, a, p = galerkin_triple(96, 96, agg_size=4, device=device)
    t0 = time.perf_counter()
    ap = spgemm(a, p, method="sparse")
    rap = spgemm(r, ap.c, method="sparse")
    ex_ap = ReuseExecutor(ap.plan)
    ex_rap = ReuseExecutor(rap.plan)
    sync(device)
    return r, a, p, ap, rap, ex_ap, ex_rap, time.perf_counter() - t0


def timestep(ex_ap, ex_rap, r: CSR, p: CSR, a_values: torch.Tensor):
    """One Reuse timestep: new A values, both products replayed. Returns
    (AP values, RAP values)."""
    ap_vals = ex_ap.apply(a_values, p.values)
    return ap_vals, ex_rap.apply(r.values, ap_vals)


def batched(ex_ap, ex_rap, r: CSR, p: CSR, a_batch: torch.Tensor):
    """A batch of timesteps, one dispatch a product: P shared, A stacked.
    Returns (AP values, RAP values), each (batch, nnz_cap)."""
    ap_b = ex_ap.apply_batched(a_batch, p.values)
    r_b = r.values.expand(a_batch.shape[0], r.nnz_cap)
    return ap_b, ex_rap.apply_batched(r_b, ap_b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = pick_device(ap, ap.parse_args(argv).device)

    r, a, p, _, rap, ex_ap, ex_rap, setup_s = setup(device)
    print(f"fine grid: {a.shape[0]} dofs, nnz={int(a.nnz())}")
    print(f"setup (symbolic+numeric): {setup_s * 1e3:.1f} ms  "
          f"A_coarse nnz={rap.stats['nnz_c']} (numeric phase {rap.stats['replay_backend']})")

    # --- time stepping: values change, structure fixed (Reuse) -----------
    rng = np.random.default_rng(0)
    reuse_times = []
    for _ in range(STEPS):
        a_t = values_on(device, rng.standard_normal(a.nnz_cap))
        t0 = time.perf_counter()
        ap_vals, _ = timestep(ex_ap, ex_rap, r, p, a_t)
        sync(device)
        reuse_times.append(time.perf_counter() - t0)
    reuse_ms = float(np.mean(reuse_times[1:])) * 1e3
    print(f"reuse numeric-only per timestep: {reuse_ms:.1f} ms  "
          f"({setup_s * 1e3 / reuse_ms:.1f}x faster than setup)")

    # --- ensemble: a batch of timesteps in ONE dispatch per product ------
    a_batch = values_on(device, rng.standard_normal((BATCH, a.nnz_cap)))
    batched(ex_ap, ex_rap, r, p, a_batch)  # warm-up
    sync(device)
    t0 = time.perf_counter()
    ap_b, _ = batched(ex_ap, ex_rap, r, p, a_batch)
    sync(device)
    batch_ms = (time.perf_counter() - t0) * 1e3
    print(f"batched reuse, {BATCH} timesteps in 2 dispatches: "
          f"{batch_ms:.1f} ms total, {batch_ms / BATCH:.2f} ms/timestep "
          f"({reuse_ms / (batch_ms / BATCH):.1f}x vs per-call reuse)")

    # validate one reuse iteration against a fresh run
    fresh = spgemm(CSR(a.indptr, a.indices, a_t, a.shape), p).c
    nnz = int(fresh.nnz())
    np.testing.assert_allclose(ap_vals[:nnz].cpu().numpy(), fresh.values[:nnz].cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    # and the batch's last member against the per-call replay
    np.testing.assert_allclose(ex_ap.apply(a_batch[-1], p.values).cpu().numpy(),
                               ap_b[-1].cpu().numpy(), rtol=1e-5, atol=1e-6)
    print("reuse + batched results validated. OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

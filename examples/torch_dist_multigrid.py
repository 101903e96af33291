"""Sharded multigrid setup on the PyTorch port: a pinned ShardedPlan replayed
across a V-cycle.

The port of examples/dist_multigrid.py, the distributed version of
examples/torch_multigrid_reuse.py: the paper's headline Reuse scenario
composed with the 1-D row decomposition of ``repro_torch.dist``. The
Galerkin products A_coarse = R*(A*P) pin one sharded plan per multiply at
setup; every timestep then replays both numeric phases shard by shard with
zero structure hashing and zero re-partitioning (the printed telemetry
shows it). P stays ``replicated`` (it is small and read ~delta_A times);
set ``B_PLACEMENT`` to "allgather" to trade that memory for a values-only
all-gather per replay.

The mesh is ``launch.mesh.make_data_mesh(8)``: eight shards held in one
process on one device, where the reference forces eight host devices. On
the card each shard with live products replays through the CUDA kernel K1
(one launch a live shard; one batched launch a live shard for
``apply_batched``). Eager PyTorch never retraces: where the reference
prints retraces this prints ``STAGE_COUNTS``, the stage calls of the steps.

Checks: the merged sharded replay against the single-device executor,
bitwise on the CPU (each shard sums its products in the single plan's
order) and within the port's f32 tolerance on the card (K1's tiles start at
other products in a shard than in the whole plan: |sharded - single| <=
1e-4 * S + 1e-6, S the replay of absolute values); the batch's last row
against a single replay of its values, bitwise (K1 adds in a fixed order).

Runs on the card by default; --device cpu runs it on the CPU:

    PYTHONPATH=src python examples/torch_dist_multigrid.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import HASH_COUNTS, STAGE_COUNTS, ReuseExecutor, reset_hash_counts
from repro_torch.core.spgemm import reset_stage_counts
from repro_torch.dist import ShardedReuseExecutor
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sparse import galerkin_triple

B_PLACEMENT = "replicated"
SHARDS = 8
STEPS = 8
BATCH = 8
F32_TOL = (1e-4, 1e-6)  # |sharded - single| <= 1e-4 * S + 1e-6 on the card


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


def setup(device, placement: str = B_PLACEMENT):
    """Pin both sharded plans (one structure hash each). Returns (mesh, r,
    a, p, ex_ap, ex_rap, setup seconds, structure hashes)."""
    mesh = make_data_mesh(SHARDS, device=device)
    r, a, p = galerkin_triple(96, 96, agg_size=4, device=device)
    reset_hash_counts()
    t0 = time.perf_counter()
    ex_ap = ShardedReuseExecutor.from_matrices(a, p, mesh, b_placement=placement)
    ap = ex_ap.merge(ex_ap.apply(a.values, p.values))
    ex_rap = ShardedReuseExecutor.from_matrices(r, ap, mesh, b_placement=placement)
    ex_rap.apply(r.values, ap.values)
    sync(device)
    return mesh, r, a, p, ex_ap, ex_rap, time.perf_counter() - t0, sum(HASH_COUNTS.values())


def timestep(ex_ap, ex_rap, r, p, a_values: torch.Tensor):
    """One V-cycle step: AP replayed, its values routed into the pinned RAP
    layout on the device (``merge_values``), RAP replayed. Returns (AP
    values (S, nnz_cap), RAP values)."""
    ap_v = ex_ap.apply(a_values, p.values)
    return ap_v, ex_rap.apply(r.values, ex_ap.merge_values(ap_v))


def single_device(a, p, a_values: torch.Tensor) -> tuple:
    """The single-device executor's replay of A*P on ``a_values`` and of
    their absolute values, on C's live slots."""
    ex = ReuseExecutor.from_matrices(a, p)
    want = ex.to_csr(ex.apply(a_values, p.values))
    n = int(want.indptr[-1])
    return want.values[:n], ex.apply(a_values.abs(), p.values.abs())[:n]


def sharded_matches(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> bool:
    """Bitwise on the CPU, F32_TOL on the card."""
    if got.device.type == "cpu":
        return bool(torch.equal(got, want))
    err = (got.double() - want.double()).abs()
    return bool((err <= F32_TOL[0] * scale.double() + F32_TOL[1]).all())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = pick_device(ap, ap.parse_args(argv).device)

    mesh, r, a, p, ex_ap, ex_rap, setup_s, hashes = setup(device)
    print(f"mesh: {mesh.shape['data']} shards | fine grid: {a.shape[0]} dofs, "
          f"nnz={int(a.nnz())} | live shards: A*P {sum(ex_ap.live_shards)}, "
          f"R*AP {sum(ex_rap.live_shards)}")
    print(f"setup (partition+symbolic+pin x2): {setup_s * 1e3:.1f} ms, "
          f"structure hashes={hashes}")

    # --- V-cycle time stepping: values change, structure fixed ------------
    rng = np.random.default_rng(0)
    reset_stage_counts()
    reset_hash_counts()
    times = []
    for _ in range(STEPS):
        new_vals = values_on(device, rng.standard_normal(a.nnz_cap))
        t0 = time.perf_counter()
        timestep(ex_ap, ex_rap, r, p, new_vals)
        sync(device)
        times.append(time.perf_counter() - t0)
    reuse_ms = float(np.mean(times[1:])) * 1e3
    print(f"sharded reuse per timestep: {reuse_ms:.1f} ms "
          f"({setup_s * 1e3 / reuse_ms:.1f}x faster than setup); "
          f"stage calls={dict(STAGE_COUNTS)}, "
          f"hashes={sum(HASH_COUNTS.values())} across {len(times)} steps")

    # --- ensemble: a batch of timesteps, ONE dispatch per product ---------
    a_batch = values_on(device, rng.standard_normal((BATCH, a.nnz_cap)))
    ex_ap.apply_batched(a_batch, p.values)  # warm-up
    sync(device)
    t0 = time.perf_counter()
    ap_b = ex_ap.apply_batched(a_batch, p.values)  # (batch, S, nnz_cap)
    sync(device)
    batch_ms = (time.perf_counter() - t0) * 1e3
    print(f"batched sharded replay, {BATCH} timesteps in 1 dispatch: "
          f"{batch_ms:.1f} ms total, {batch_ms / BATCH:.2f} ms/timestep")

    # --- validate: sharded replay against the single-device executor ------
    want, scale = single_device(a, p, new_vals)
    got = ex_ap.merge(ex_ap.apply(new_vals, p.values))
    nnz = int(got.indptr[-1])
    assert sharded_matches(got.values[:nnz], want[:nnz], scale[:nnz])
    assert torch.equal(ap_b[-1], ex_ap.apply(a_batch[-1], p.values))
    bar = "bitwise" if device.type == "cpu" else "within F32_TOL; batched == single bitwise"
    print(f"sharded == single-device ({bar}) validated. OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

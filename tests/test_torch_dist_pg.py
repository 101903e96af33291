"""The process-group backing of ``repro_torch.compat``'s mesh, on gloo.

Two ranks are spawned (``torch.multiprocessing.start_processes``, spawn)
and meet through a ``file://`` rendezvous in a temporary directory, so no
port is taken and parallel test workers cannot collide. One spawn runs
every case and each rank saves what it computed; the test process then
holds the ranks' results against the single-process backing on the same
seeded operands:

  * S = 4 (two shards a rank), both B placements: ``merge`` and
    ``merge_values`` bitwise the single-process result, ``apply`` this
    rank's rows of the single-process ``apply``, ``apply_batched`` too;
  * ``build_sharded_plan``'s cap-sync: both ranks pick the single-process
    ``nnz_cap``, and each holds its rows of the single-process plan;
  * the primitives: ``all_gather``, ``psum`` and ``ppermute`` by +1 and -1;
  * ``compressed_psum`` against the single-process mean (exactly: the same
    int8 payloads and scales, summed in the same order);
  * ``pipeline_forward`` over 2 stages against the serial loop at
    rtol 1e-4 / atol 1e-5 (the reference test's tolerance);
  * ``distributed_spgemm`` bitwise the single-process one.

The spawn has its own join deadline and fails rather than hangs.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from repro_torch import compat
from repro_torch.core import PlanCache, distributed_spgemm
from repro_torch.dist import ShardedReuseExecutor, build_sharded_plan, compressed_psum
from repro_torch.dist import pipeline_forward
from repro_torch.sparse import random_csr

WORLD = 2
SHARDS = 4
JOIN_S = 120
PIPE_D = 16


def _operands():
    a = random_csr(96, 64, 4.0, 1, device="cpu")
    b = random_csr(64, 80, 3.0, 2, device="cpu")
    g = torch.Generator().manual_seed(5)
    a_stack = torch.randn(3, a.nnz_cap, generator=g)
    x = torch.randn(SHARDS, 128, generator=g)
    ws = torch.randn(WORLD, PIPE_D, PIPE_D, generator=g) * 0.3
    mbs = torch.randn(6, 4, PIPE_D, generator=g)
    return a, b, a_stack, x, ws, mbs


def _layer(w, h):
    return torch.tanh(h @ w)


def _run_cases(mesh, pipe_mesh, rank_rows) -> dict:
    """Every case on one mesh backing; ``rank_rows`` cuts a whole stack to
    the rows this process holds (the identity in one process)."""
    a, b, a_stack, x, ws, mbs = _operands()
    out = {}
    for placement in ("replicated", "allgather"):
        ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                                plan_cache=PlanCache())
        v = ex.apply(a.values, b.values)
        c = ex.merge(v)
        out[placement] = {
            "apply": v, "indptr": c.indptr, "indices": c.indices, "values": c.values,
            "merge_values": ex.merge_values(v),
            "batched": ex.apply_batched(a_stack, b.values),
        }
        plan = build_sharded_plan(a, b, mesh, b_placement=placement)
        out[placement]["plan"] = {name: getattr(plan, name) for name in (
            "indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s", "a_perm",
            "b_shard_perm", "b_perm")}
        c2 = distributed_spgemm(a, b, mesh, b_placement=placement)
        out[placement]["fresh"] = (c2.indptr, c2.indices, c2.values)
    local = rank_rows(torch.arange(SHARDS * 3, dtype=torch.float32).view(SHARDS, 3))
    out["all_gather"] = mesh.all_gather(local)
    out["psum"] = mesh.psum(local)
    out["ppermute+1"] = mesh.ppermute(local, 1)
    out["ppermute-1"] = mesh.ppermute(local, -1)
    out["compressed_psum"] = compressed_psum(rank_rows(x), mesh)
    out["pipeline"] = pipeline_forward(_layer, ws, mbs, pipe_mesh, axis="pipe")
    return out


def _worker(rank: int, init_file: str, result_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = compat.make_mesh((SHARDS,), ("data",))
        pipe_mesh = compat.make_mesh((WORLD,), ("pipe",))
        assert mesh.group is not None and mesh.S_loc == SHARDS // WORLD
        out = _run_cases(mesh, pipe_mesh, lambda t: mesh.local(t))
        out["offset"] = mesh.shard_offset
        torch.save(out, os.path.join(result_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results from one two-rank gloo spawn."""
    root = tmp_path_factory.mktemp("gloo")
    procs = torch_mp.start_processes(_worker, args=(str(root / "rendezvous"), str(root)),
                                     nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not procs.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {JOIN_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    assert all(not p.is_alive() for p in procs.processes)
    return [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The same cases on the single-process backing."""
    torch.set_num_threads(1)
    mesh = compat.make_mesh((SHARDS,), ("data",), device="cpu")
    pipe_mesh = compat.make_mesh((WORLD,), ("pipe",), device="cpu")
    return _run_cases(mesh, pipe_mesh, lambda t: t)


def _rows(t, rank):
    per = SHARDS // WORLD
    return t[rank * per:(rank + 1) * per]


@pytest.mark.parametrize("placement", ["replicated", "allgather"])
def test_merge_is_bitwise_the_single_process_result(ranks, single, placement):
    want = single[placement]
    for rank, got in enumerate(ranks):
        got = got[placement]
        for key in ("indptr", "indices", "values", "merge_values"):
            assert torch.equal(got[key], want[key]), (rank, key)
        assert torch.equal(got["apply"], _rows(want["apply"], rank))
        assert torch.equal(got["batched"], _rows(want["batched"].transpose(0, 1),
                                                 rank).transpose(0, 1))
        for x, y in zip(got["fresh"], want["fresh"]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("placement", ["replicated", "allgather"])
def test_cap_sync_agrees_across_ranks(ranks, single, placement):
    want = single[placement]["plan"]
    for rank, got in enumerate(ranks):
        got = got[placement]["plan"]
        assert got["indices"].shape[1] == want["indices"].shape[1]  # nnz_cap
        assert got["seg_ids"].shape[1] == want["seg_ids"].shape[1]  # fm_cap
        for name, arr in got.items():
            expect = want[name] if name == "b_perm" else _rows(want[name], rank)
            assert torch.equal(arr, expect), (rank, name)


def test_primitives_match_the_single_process_backing(ranks, single):
    for rank, got in enumerate(ranks):
        assert got["offset"] == rank * SHARDS // WORLD
        assert torch.equal(got["all_gather"], single["all_gather"])
        for key in ("psum", "ppermute+1", "ppermute-1", "compressed_psum"):
            assert torch.equal(got[key], _rows(single[key], rank)), (rank, key)


def test_pipeline_over_two_ranks_matches_the_serial_loop(ranks):
    _, _, _, _, ws, mbs = _operands()
    want = mbs
    for i in range(WORLD):
        want = _layer(ws[i], want)
    for got in ranks:
        np.testing.assert_allclose(got["pipeline"].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5)

"""repro_torch.dist (ShardedPlan, ShardedReuseExecutor, spgemm(mesh=...))
against the JAX package's ``repro.dist`` at S = 8.

The reference runs once per module, in one subprocess that forces 8 host
devices (the flag must be set before JAX starts, and this process must keep
seeing one device). It writes its plans, dist plan keys, replayed values,
merged C, telemetry and the error class of each validation scenario to an
``.npz`` beside a JSON file. The port runs the same seeded operands on the
single-process mesh of ``compat.make_mesh((8,), ("data",), device="cpu")``:

  * plan integer arrays and the dist plan key bitwise the reference's;
  * replayed values (``apply``, ``apply_batched``) within rtol/atol 1e-5
    of the reference's (its replay tolerance);
  * ``merge`` bitwise the port's single-device ``ReuseExecutor`` (plain on
    the CPU: each shard adds the same products in the same order);
  * one structure hash at pin and none across 8 replays; DISPATCH_COUNTS,
    the first replay's ``dist_replay`` stage, cache hit/miss/bypass and the
    ``spgemm(mesh=...)`` stats keys as the reference's;
  * every validation scenario raising the reference's error class;
  * ``distributed_spgemm`` against the dense oracle at rtol/atol 1e-4.

This file imports no JAX itself: its ``cuda`` tests (K1 once a shard on the
card) run with ``pytest --noconftest -m cuda tests/test_torch_dist_executor.py``
on a machine with a card and no JAX.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.core import (DISPATCH_COUNTS, HASH_COUNTS, STAGE_COUNTS, PlanCache,
                              ReuseExecutor, distributed_spgemm, spgemm)
from repro_torch.core import telemetry as ttelemetry
from repro_torch.core.plan_cache import structure_key
from repro_torch.core.spgemm import prepare_sparse_inputs
from repro_torch.dist import ShardedReuseExecutor, dist_plan_key
from repro_torch.kernels import segsum_reuse as k1
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.sparse import CSR, dense_spgemm_oracle, random_csr

REPO = Path(__file__).resolve().parents[1]
S = 8
TOL = 1e-5
PLACEMENTS = ("replicated", "allgather")
PLAN_FIELDS = ("indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s", "a_perm",
               "b_shard_perm", "b_perm")
# (name, (m, k, nnz per row, seed) of A, (k, n, nnz per row, seed) of B)
LAYOUTS = {"main": ((96, 64, 4.0, 1), (64, 80, 3.0, 2)),
           "indivisible": ((91, 32, 3.0, 91), (32, 24, 2.0, 92)),
           "empty_shards": ((5, 32, 3.0, 5), (32, 24, 2.0, 6))}
SCENARIOS = ("host_short_a", "host_2d_a", "host_short_b", "host_nan", "device_nan_a",
             "device_inf_b", "off_short_a", "bad_placement", "batched_unstacked",
             "merge_batched", "host_bad_csr")

REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core import PlanCache, ReuseExecutor
from repro.core.executor import DISPATCH_COUNTS, reset_dispatch_counts
from repro.core.plan_cache import HASH_COUNTS, reset_hash_counts, structure_key
from repro.core.spgemm import TRACE_COUNTS, prepare_sparse_inputs, reset_trace_counts, spgemm
from repro.dist import ShardedReuseExecutor, dist_plan_key
from repro.sparse import CSR, random_csr

LAYOUTS = json.loads(sys.argv[2])
SCENARIOS = json.loads(sys.argv[3])
mesh = make_mesh((8,), ("data",))
arrays, meta = {}, {}
for name, (ap, bp) in LAYOUTS.items():
    a, b = random_csr(*ap), random_csr(*bp)
    rng = np.random.default_rng(7)
    av = jnp.asarray(rng.standard_normal(a.nnz_cap), jnp.float32)
    bv = jnp.asarray(rng.standard_normal(b.nnz_cap), jnp.float32)
    a_stack = jnp.asarray(rng.standard_normal((3, a.nnz_cap)), jnp.float32)
    for placement in ("replicated", "allgather"):
        tag = f"{name}/{placement}"
        reset_hash_counts(); reset_trace_counts(); reset_dispatch_counts()
        ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                                plan_cache=PlanCache())
        meta[tag] = {"hash_at_pin": sum(HASH_COUNTS.values())}
        pa, pb, _, _, fm_cap = prepare_sparse_inputs(a, b, "pow2")
        meta[tag]["key"] = dist_plan_key(structure_key(pa, pb, fm_cap, "pow2"), 8, placement)
        for f in ("indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s", "a_perm",
                  "b_shard_perm", "b_perm"):
            arrays[f"{tag}/plan/{f}"] = np.asarray(getattr(ex.plan, f))
        v = ex.apply(av, bv)
        meta[tag]["trace_first_apply"] = dict(TRACE_COUNTS)
        arrays[f"{tag}/apply"] = np.asarray(v)
        arrays[f"{tag}/batched"] = np.asarray(ex.apply_batched(a_stack, bv))
        meta[tag]["dispatch"] = dict(DISPATCH_COUNTS)
        c = ex.merge(v)
        for f in ("indptr", "indices", "values"):
            arrays[f"{tag}/merge/{f}"] = np.asarray(getattr(c, f))
        arrays[f"{tag}/merge_values"] = np.asarray(ex.merge_values(v))
cache = PlanCache()
a, b = random_csr(*LAYOUTS["main"][0]), random_csr(*LAYOUTS["main"][1])
res = spgemm(a, b, mesh=mesh, plan_cache=cache)
meta["spgemm"] = {"stats_keys": sorted(res.stats), "cache": res.stats["cache"],
                  "repeat_cache": spgemm(a, b, mesh=mesh, plan_cache=cache).stats["cache"],
                  "mesh_shape": list(res.stats["mesh_shape"])}

def scenario(name):
    bad = CSR(a.indptr, a.indices.at[0].set(a.k + 5), a.values, a.shape)
    mode = "device" if name.startswith("device") else ("off" if name.startswith("off") else "host")
    placement = "allgather" if name in ("device_inf_b", "host_short_b") else "replicated"
    if name == "bad_placement":
        placement = "bogus"
    if name == "host_bad_csr":
        ShardedReuseExecutor.from_matrices(bad, b, mesh, validate="host", plan_cache=False)
        return
    ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement, validate=mode,
                                            plan_cache=False)
    av, bv = a.values, b.values
    if name in ("host_short_a", "off_short_a"):
        av = av[:3]
    if name == "host_short_b":
        bv = bv[:3]
    if name == "host_2d_a":
        av = av[None]
    if name in ("host_nan", "device_nan_a"):
        av = av.at[0].set(jnp.nan)
    if name == "device_inf_b":
        bv = bv.at[1].set(jnp.inf)
    if name == "batched_unstacked":
        ex.apply_batched(av, bv)
    elif name == "merge_batched":
        ex.merge(ex.apply_batched(jnp.stack([av, av]), bv))
    else:
        jax.block_until_ready(ex.apply(av, bv))

meta["scenarios"] = {}
for name in SCENARIOS:
    try:
        scenario(name)
        meta["scenarios"][name] = "ok"
    except Exception as e:  # the class name is the result
        meta["scenarios"][name] = type(e).__name__
np.savez(sys.argv[1] + ".npz", **arrays)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(meta, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    ttelemetry.reset_all()
    yield


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs from one 8-device JAX subprocess."""
    out = tmp_path_factory.mktemp("dist_ref") / "ref"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out), json.dumps(LAYOUTS),
         json.dumps(SCENARIOS)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(str(out) + ".npz") as z:
        arrays = dict(z)
    return arrays, json.loads(Path(str(out) + ".json").read_text())


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((S,), ("data",), device="cpu")


def _operands(name):
    ap, bp = LAYOUTS[name]
    a, b = random_csr(*ap, device="cpu"), random_csr(*bp, device="cpu")
    rng = np.random.default_rng(7)
    av = torch.from_numpy(rng.standard_normal(a.nnz_cap).astype(np.float32))
    bv = torch.from_numpy(rng.standard_normal(b.nnz_cap).astype(np.float32))
    a_stack = torch.from_numpy(rng.standard_normal((3, a.nnz_cap)).astype(np.float32))
    return a, b, av, bv, a_stack


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_plan_and_key_are_bitwise_the_references(ref, mesh, layout, placement):
    arrays, meta = ref
    tag = f"{layout}/{placement}"
    a, b, *_ = _operands(layout)
    HASH_COUNTS.clear()
    ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                            plan_cache=PlanCache())
    assert sum(HASH_COUNTS.values()) == meta[tag]["hash_at_pin"] == 1
    for f in PLAN_FIELDS:
        got, want = getattr(ex.plan, f).numpy(), arrays[f"{tag}/plan/{f}"]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
    pa, pb, _, _, fm_cap = prepare_sparse_inputs(a, b, "pow2")
    assert dist_plan_key(structure_key(pa, pb, fm_cap, "pow2"), S, placement) == meta[tag]["key"]


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_replayed_values_match_the_reference(ref, mesh, layout, placement):
    arrays, meta = ref
    tag = f"{layout}/{placement}"
    a, b, av, bv, a_stack = _operands(layout)
    ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                            plan_cache=PlanCache())
    v = ex.apply(av, bv)
    assert STAGE_COUNTS["dist_replay"] == meta[tag]["trace_first_apply"]["dist_replay"] == 1
    np.testing.assert_allclose(v.numpy(), arrays[f"{tag}/apply"], rtol=TOL, atol=TOL)
    got = ex.apply_batched(a_stack, bv)
    assert got.shape == (3, S, ex.nnz_cap)
    np.testing.assert_allclose(got.numpy(), arrays[f"{tag}/batched"], rtol=TOL, atol=TOL)
    for i in range(3):  # batched rows are the single replays, bit for bit
        assert torch.equal(got[i], ex.apply(a_stack[i], bv))
    assert {k: v for k, v in DISPATCH_COUNTS.items() if v} == {"dist_apply": 4,
                                                               "dist_apply_batched": 1}
    assert meta[tag]["dispatch"] == {"dist_apply": 1, "dist_apply_batched": 1}
    c = ex.merge(v)
    for f in ("indptr", "indices"):
        assert np.array_equal(getattr(c, f).numpy(), arrays[f"{tag}/merge/{f}"]), f
    np.testing.assert_allclose(c.values.numpy(), arrays[f"{tag}/merge/values"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ex.merge_values(v).numpy(), arrays[f"{tag}/merge_values"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_merge_is_bitwise_the_single_device_executor(mesh, layout, placement):
    a, b, av, bv, _ = _operands(layout)
    single = ReuseExecutor.from_matrices(a, b, plan_cache=PlanCache())
    want = single.to_csr(single.apply(av, bv))
    n = int(want.indptr[-1])
    ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                            plan_cache=PlanCache())
    v = ex.apply(av, bv)
    c = ex.merge(v)
    assert torch.equal(c.indptr, want.indptr)
    assert torch.equal(c.indices[:n], want.indices[:n])
    assert torch.equal(c.values[:n], want.values[:n])
    assert torch.equal(ex.merge_values(v), want.values[:n])
    # f64 operands take the plain replay: bitwise the single-device f64 one too
    av64, bv64 = av.double(), bv.double()
    assert torch.equal(ex.merge_values(ex.apply(av64, bv64)), single.apply(av64, bv64)[:n])


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_one_hash_at_pin_and_none_across_eight_replays(mesh, placement):
    a, b, *_ = _operands("main")
    HASH_COUNTS.clear()
    ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                            plan_cache=PlanCache())
    assert sum(HASH_COUNTS.values()) == 1
    HASH_COUNTS.clear()
    rng = np.random.default_rng(0)
    for _ in range(8):
        ex.apply(torch.from_numpy(rng.standard_normal(a.nnz_cap).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(b.nnz_cap).astype(np.float32)))
    assert sum(HASH_COUNTS.values()) == 0
    assert STAGE_COUNTS["dist_replay"] == 8  # a stage call a replay (no retraces)


def test_cache_states_and_the_spgemm_mesh_entry(ref, mesh):
    _, meta = ref
    a, b, *_ = _operands("main")
    cache = PlanCache()
    states = [ShardedReuseExecutor.from_matrices(a, b, mesh, plan_cache=c).cache_state
              for c in (cache, cache, False)]
    assert states == ["miss", "hit", "bypass"]
    cache = PlanCache()
    res = spgemm(a, b, mesh=mesh, plan_cache=cache)
    assert sorted(res.stats) == meta["spgemm"]["stats_keys"]
    assert res.stats["cache"] == meta["spgemm"]["cache"] == "miss"
    assert list(res.stats["mesh_shape"]) == meta["spgemm"]["mesh_shape"] == [S]
    assert res.stats["num_shards"] == S and res.stats["b_placement"] == "replicated"
    np.testing.assert_allclose(res.c.to_dense().numpy(), dense_spgemm_oracle(a, b),
                               rtol=1e-4, atol=1e-4)
    g = torch.Generator().manual_seed(3)
    a2 = CSR(a.indptr, a.indices, torch.randn(a.nnz_cap, generator=g), a.shape)
    res2 = spgemm(a2, b, mesh=mesh, plan_cache=cache)
    assert res2.stats["cache"] == meta["spgemm"]["repeat_cache"] == "hit"
    np.testing.assert_allclose(res2.c.to_dense().numpy(), dense_spgemm_oracle(a2, b),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [{"tune": "measure"}, {"method": "dense"}, {"method": "lp"}],
                         ids=["tune", "dense", "lp"])
def test_mesh_guards_raise_config_errors(mesh, kw):
    a, b, *_ = _operands("main")
    with pytest.raises(SpgemmConfigError):
        spgemm(a, b, mesh=mesh, **kw)


def _scenario(name, mesh):
    a, b, *_ = _operands("main")
    bad_ix = a.indices.clone()
    bad_ix[0] = a.k + 5
    mode = "device" if name.startswith("device") else ("off" if name.startswith("off") else "host")
    placement = "allgather" if name in ("device_inf_b", "host_short_b") else "replicated"
    if name == "bad_placement":
        placement = "bogus"
    if name == "host_bad_csr":
        ShardedReuseExecutor.from_matrices(CSR(a.indptr, bad_ix, a.values, a.shape), b, mesh,
                                           validate="host", plan_cache=False)
        return
    ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement, validate=mode,
                                            plan_cache=False)
    av, bv = a.values.clone(), b.values.clone()
    if name in ("host_short_a", "off_short_a"):
        av = av[:3]
    if name == "host_short_b":
        bv = bv[:3]
    if name == "host_2d_a":
        av = av[None]
    if name in ("host_nan", "device_nan_a"):
        av[0] = float("nan")
    if name == "device_inf_b":
        bv[1] = float("inf")
    if name == "batched_unstacked":
        ex.apply_batched(av, bv)
    elif name == "merge_batched":
        ex.merge(ex.apply_batched(torch.stack([av, av]), bv))
    else:
        ex.apply(av, bv)


@pytest.mark.parametrize("name", SCENARIOS)
def test_validation_raises_what_the_reference_raises(ref, mesh, name):
    _, meta = ref
    try:
        _scenario(name, mesh)
        got = "ok"
    except Exception as e:  # the class name is the result
        got = type(e).__name__
    assert got == meta["scenarios"][name]


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_distributed_spgemm_matches_the_oracle(mesh, layout, placement):
    a, b, *_ = _operands(layout)
    c = distributed_spgemm(a, b, mesh, b_placement=placement)
    np.testing.assert_allclose(c.to_dense().numpy(), dense_spgemm_oracle(a, b),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shards", [3, 1, 128])
def test_other_shard_counts_merge_bitwise(shards):
    """m indivisible by 3, one shard, more shards than rows."""
    a, b, av, bv, _ = _operands("main")
    single = ReuseExecutor.from_matrices(a, b, plan_cache=PlanCache())
    want = single.apply(av, bv)
    n = int(single.plan.indptr[-1])
    m = compat.make_mesh((shards,), ("data",), device="cpu")
    for placement in PLACEMENTS:
        ex = ShardedReuseExecutor.from_matrices(a, b, m, b_placement=placement,
                                                plan_cache=PlanCache())
        assert torch.equal(ex.merge_values(ex.apply(av, bv)), want[:n])
        assert ex.live_shards == [bool(x) for x in
                                  (ex.plan.seg_ids < ex.nnz_cap).any(1).tolist()]


@pytest.mark.parametrize("policy", ["pow2", "exact8"])
def test_plan_rows_start_on_32_bytes(mesh, policy):
    """K1's int4 plan loads read a shard's row where it lies: every cap is a
    multiple of 8, so each row of a stacked int32 array starts 32-byte
    aligned whenever the stack does (the allocator aligns to 64)."""
    a, b, *_ = _operands("indivisible")
    for placement in PLACEMENTS:
        ex = ShardedReuseExecutor.from_matrices(a, b, mesh, b_placement=placement,
                                                pad_policy=policy, plan_cache=PlanCache())
        for f in ("seg_ids", "a_slot_s", "b_slot_s"):
            t = getattr(ex.plan, f)
            assert t.shape[1] % 8 == 0 and t.data_ptr() % 32 == 0, f
            assert all(t[i].data_ptr() % 32 == 0 and t[i].is_contiguous()
                       for i in range(t.shape[0])), f


# --------------------------------------------------------------------------
# On the card: K1 once a shard with live products
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


def _f32_tol_check(got, plain, scale):
    """|K1 - plain| <= 1e-4 * S + 1e-6, S the sum of |products| of a slot."""
    assert torch.isfinite(got).all()
    assert bool(((got - plain).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_replay_launches_k1_once_a_live_shard(cuda, layout, placement):
    a, b, av, bv, a_stack = _operands(layout)
    a, b = (CSR(x.indptr.to(cuda), x.indices.to(cuda), x.values.to(cuda), x.shape)
            for x in (a, b))
    av, bv, a_stack = av.to(cuda), bv.to(cuda), a_stack.to(cuda)
    m = compat.make_mesh((S,), ("data",), device=cuda)
    ex = ShardedReuseExecutor.from_matrices(a, b, m, b_placement=placement,
                                            plan_cache=PlanCache())
    live = sum(ex.live_shards)
    assert live == int((ex.plan.seg_ids < ex.nnz_cap).any(1).sum())
    single = ReuseExecutor.from_matrices(a, b, plan_cache=PlanCache())
    n = int(single.plan.indptr[-1])
    plain = single.apply(av, bv)[:n]
    scale = single.apply(av.abs(), bv.abs())[:n]
    ttelemetry.reset_all()
    before, before_b = k1.LAUNCHES, k1.BATCHED_LAUNCHES
    got = ex.merge_values(ex.apply(av, bv))
    torch.cuda.synchronize()
    assert k1.LAUNCHES - before == live
    assert STAGE_COUNTS["numeric_reuse"] == 0  # no plain replay for f32
    _f32_tol_check(got, plain, scale)
    batched = ex.apply_batched(a_stack, bv)
    assert k1.BATCHED_LAUNCHES - before_b == live and STAGE_COUNTS["numeric_reuse"] == 0
    for i in range(3):
        row = ex.apply(a_stack[i], bv)
        _f32_tol_check(batched[i], row, ex.apply(a_stack[i].abs(), bv.abs()))
    # f64 operands take the plain replay (the dtype guard), launching nothing
    before = k1.LAUNCHES
    got64 = ex.merge_values(ex.apply(av.double(), bv.double()))
    assert k1.LAUNCHES == before and got64.dtype == torch.float64
    assert ttelemetry.FALLBACK_COUNTS["dtype:dist->xla"] == 1

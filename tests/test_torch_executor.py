"""repro_torch.core.executor against the JAX package's ReuseExecutor.

Plans and operands come from the same numpy-seeded generators. On the CPU
the three backends run their plain versions ("pallas" and "pallas_lp" name
CUDA kernels that need a card), so every backend is held against the
reference's "xla" replay at rtol/atol 1e-5. The telemetry contracts (one
structure hash per pin, one dispatch per structure group) must give the
reference's counts.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as jexec
from repro.core import plan_cache as jcache
from repro.core import telemetry as jtelemetry
from repro.sparse import CSR as JCSR
from repro.sparse import generators as jgen
from repro_torch.core import executor as texec
from repro_torch.core import plan_cache as tcache
from repro_torch.core import telemetry as ttelemetry
from repro_torch.kernels import BACKEND_NAMES
from repro_torch.runtime.validate import PlanMismatchError, SpgemmConfigError
from repro_torch.sparse import CSR as TCSR
from repro_torch.sparse import generators as tgen

jsp = importlib.import_module("repro.core.spgemm")
tsp = importlib.import_module("repro_torch.core.spgemm")

RTOL = ATOL = 1e-5


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


def _to_torch(j: JCSR) -> TCSR:
    return TCSR(torch.from_numpy(np.asarray(j.indptr).copy()),
                torch.from_numpy(np.asarray(j.indices).copy()),
                torch.from_numpy(np.asarray(j.values).copy()), tuple(j.shape))


def _values(n, seed, batch=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if batch is None else (batch, n)).astype(np.float32)


def _galerkin():
    r, a, p = jgen.galerkin_triple(10, 10, 4)
    return a, p


PROBLEMS = {
    "random": lambda: (jgen.random_csr(40, 50, 3.0, 1), jgen.random_csr(50, 30, 2.5, 2)),
    "galerkin_ap": _galerkin,
    "rmat8": lambda: (jgen.rmat_csr(8, 8, 0), jgen.rmat_csr(8, 8, 1)),
}


def _pinned(problem):
    ja, jb = PROBLEMS[problem]()
    ta, tb = _to_torch(ja), _to_torch(jb)
    jex = jexec.ReuseExecutor.from_matrices(ja, jb, backend="xla",
                                            plan_cache=jcache.PlanCache())
    return ja, jb, ta, tb, jex


def test_backend_table_names_every_backend():
    assert texec.BACKENDS == jexec.BACKENDS
    assert set(BACKEND_NAMES) == set(texec.BACKENDS) - {"auto"}


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "pallas_lp"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_apply_matches_reference(problem, backend):
    ja, jb, ta, tb, jex = _pinned(problem)
    before = tcache.HASH_COUNTS["structure_key"]
    tex = texec.ReuseExecutor.from_matrices(ta, tb, backend=backend,
                                            plan_cache=tcache.PlanCache())
    assert tcache.HASH_COUNTS["structure_key"] == before + 1  # the one pin hash
    assert tex.backend == ("xla" if backend == "auto" else backend)
    assert (tex.shape, tex.nnz_cap, tex.fm_cap) == (jex.shape, jex.nnz_cap, jex.fm_cap)
    assert tex._skey == jex._skey
    for step in range(3):
        av = _values(ja.nnz_cap, 100 + step)
        bv = _values(jb.nnz_cap, 200 + step)
        want = np.asarray(jex.apply(jnp.asarray(av), jnp.asarray(bv)))
        got = tex.apply(torch.from_numpy(av), torch.from_numpy(bv))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(want, got.numpy(), rtol=RTOL, atol=ATOL)
    # replays hash nothing and count one dispatch each
    assert tcache.HASH_COUNTS["structure_key"] == before + 1
    assert texec.DISPATCH_COUNTS["apply"] == 3
    csr = tex.to_csr(got)
    assert csr.shape == tex.shape and csr.indices is tex.plan.indices


@pytest.mark.parametrize("backend", ["pallas", "pallas_lp"])
def test_f64_operands_take_the_plain_path_against_numpy(backend):
    a = tgen.random_csr(30, 40, 3.0, 1, dtype=np.float64, device="cpu")
    b = tgen.random_csr(40, 20, 3.0, 2, dtype=np.float64, device="cpu")
    ex = texec.ReuseExecutor.from_matrices(a, b, backend=backend, plan_cache=False)
    got = ex.apply(a.values, b.values)
    assert got.dtype == torch.float64
    assert ttelemetry.FALLBACK_COUNTS["dtype:executor->xla"] == 1
    np.testing.assert_allclose(ex.to_csr(got).to_dense().numpy(),
                               a.to_dense().numpy() @ b.to_dense().numpy(),
                               rtol=1e-12, atol=1e-12)


def test_mixed_bf16_f32_replay_matches_reference():
    ja, jb, ta, tb, jex = _pinned("random")
    av = _values(ja.nnz_cap, 7)
    bv = _values(jb.nnz_cap, 8)
    want = np.asarray(jex.apply(jnp.asarray(av, jnp.bfloat16), jnp.asarray(bv)))
    for backend in ("xla", "pallas", "pallas_lp"):
        ex = texec.ReuseExecutor.from_matrices(ta, tb, backend=backend, plan_cache=False)
        got = ex.apply(torch.from_numpy(av).to(torch.bfloat16), torch.from_numpy(bv))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(want, got.numpy(), rtol=RTOL, atol=ATOL)
    assert not ttelemetry.FALLBACK_COUNTS


@pytest.mark.parametrize("stacked", ["a", "both", "b"])
def test_apply_batched_matches_reference(stacked):
    ja, jb, ta, tb, jex = _pinned("galerkin_ap")
    tex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False)
    batch = 4
    av = _values(ja.nnz_cap, 1, batch if stacked in ("a", "both") else None)
    bv = _values(jb.nnz_cap, 2, batch if stacked in ("b", "both") else None)
    want = np.asarray(jex.apply_batched(jnp.asarray(av), jnp.asarray(bv)))
    got = tex.apply_batched(torch.from_numpy(av), torch.from_numpy(bv))
    assert got.shape == (batch, tex.nnz_cap)
    np.testing.assert_allclose(want, got.numpy(), rtol=RTOL, atol=ATOL)
    # each row equals the single replay of that row
    for i in range(batch):
        single = tex.apply(torch.from_numpy(av[i] if av.ndim == 2 else av),
                           torch.from_numpy(bv[i] if bv.ndim == 2 else bv))
        torch.testing.assert_close(got[i], single, rtol=RTOL, atol=ATOL)
    assert texec.DISPATCH_COUNTS["apply_batched"] == 1
    with pytest.raises(SpgemmConfigError):
        tex.apply_batched(torch.from_numpy(av.reshape(-1)[:ja.nnz_cap]),
                          torch.from_numpy(bv.reshape(-1)[:jb.nnz_cap]))


def _with_values(j: JCSR, seed: int) -> JCSR:
    return JCSR(j.indptr, j.indices, jnp.asarray(_values(j.nnz_cap, seed)), j.shape)


def test_spgemm_grouped_matches_reference_and_its_counts():
    """Two structures, one of them three times, one pair in bf16: three
    groups in both packages, the same hashes and the same dispatches."""
    r1, r2 = PROBLEMS["random"]()
    g1, g2 = PROBLEMS["galerkin_ap"]()
    jpairs = [(_with_values(r1, 1), _with_values(r2, 2)),
              (_with_values(g1, 3), g2),
              (_with_values(r1, 4), _with_values(r2, 5)),
              (_with_values(r1, 6), _with_values(r2, 7)),
              (JCSR(r1.indptr, r1.indices, r1.values.astype(jnp.bfloat16), r1.shape),
               _with_values(r2, 8))]
    tpairs = []
    for a, b in jpairs:
        ta, tb = _to_torch(JCSR(a.indptr, a.indices, a.values.astype(jnp.float32),
                                a.shape)), _to_torch(b)
        if a.values.dtype == jnp.bfloat16:
            ta = TCSR(ta.indptr, ta.indices, ta.values.to(torch.bfloat16), ta.shape)
        tpairs.append((ta, tb))
    jtelemetry.reset_all()
    want = jexec.spgemm_grouped(jpairs, plan_cache=jcache.PlanCache())
    jcounts = (dict(jexec.DISPATCH_COUNTS), dict(jcache.HASH_COUNTS))
    got = texec.spgemm_grouped(tpairs, plan_cache=tcache.PlanCache())
    tcounts = (dict(texec.DISPATCH_COUNTS), dict(tcache.HASH_COUNTS))
    assert tcounts == jcounts == ({"apply": 2, "apply_batched": 1},
                                  {"structure_key": 5})
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w.indptr), g.indptr.numpy())
        np.testing.assert_array_equal(np.asarray(w.indices), g.indices.numpy())
        assert g.values.dtype == torch.float32
        np.testing.assert_allclose(np.asarray(w.values.astype(jnp.float32)),
                                   g.values.numpy(), rtol=RTOL, atol=ATOL)
    assert texec.spgemm_grouped(iter([])) == []


def test_pin_hits_the_plan_cache_and_check_compat():
    ja, jb = PROBLEMS["random"]()
    ta, tb = _to_torch(ja), _to_torch(jb)
    cache = tcache.PlanCache()
    first = tsp.spgemm(ta, tb, method="sparse", plan_cache=cache)
    stages = tsp.STAGE_COUNTS["expand_and_sort"]
    ex = texec.ReuseExecutor.pin(ta, tb, backend="pallas", plan_cache=cache)
    assert ex.plan is first.plan and cache.stats()["hits"] == 1
    assert tsp.STAGE_COUNTS["expand_and_sort"] == stages
    ex.check_compat(ta, tb)  # same structure, new values: fine
    other = _to_torch(jgen.random_csr(40, 50, 3.0, 9))
    with pytest.raises(PlanMismatchError):
        ex.check_compat(other, tb)
    with pytest.raises(PlanMismatchError):
        texec.ReuseExecutor(first.plan).check_compat(ta, tb)


def test_donate_is_accepted_and_changes_nothing():
    ja, jb = PROBLEMS["random"]()
    ta, tb = _to_torch(ja), _to_torch(jb)
    ex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False)
    base = ex.apply(ta.values, tb.values)
    for donate in (True, "both", "a", "b"):
        torch.testing.assert_close(ex.apply(ta.values, tb.values, donate=donate), base,
                                   rtol=0, atol=0)
    with pytest.raises(SpgemmConfigError):
        ex.apply(ta.values, tb.values, donate="c")


@pytest.mark.parametrize("kwargs", [
    {"backend": "bogus"}, {"tune": "measure"}, {"validate": "host"},
    {"nan_guard": True}, {"watchdog": object()}, {"on_kernel_failure": "fallback"},
])
def test_later_slice_options_raise_config_errors(kwargs):
    ja, jb = PROBLEMS["random"]()
    ta, tb = _to_torch(ja), _to_torch(jb)
    plan = tsp.spgemm(ta, tb, method="sparse", plan_cache=False).plan
    with pytest.raises(SpgemmConfigError):
        texec.ReuseExecutor(plan, **kwargs)
    with pytest.raises(SpgemmConfigError):
        texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False, **kwargs)


def test_executor_needs_a_plan():
    with pytest.raises(SpgemmConfigError):
        texec.ReuseExecutor(None)
    with pytest.raises(SpgemmConfigError):
        texec.spgemm_grouped([], tune="measure")


def test_telemetry_snapshot_diff_and_reset():
    ja, jb = PROBLEMS["random"]()
    ta, tb = _to_torch(ja), _to_torch(jb)
    before = ttelemetry.snapshot()
    ex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False)
    ex.apply(ta.values, tb.values)
    delta = ttelemetry.diff(before, ttelemetry.snapshot())
    assert delta["hash"] == {"structure_key": 1}
    assert delta["dispatch"] == {"apply": 1}
    assert delta["stage"]["expand_and_sort"] == 1
    assert "fallback" not in delta
    ttelemetry.reset_all()
    assert not any(ttelemetry.snapshot().values())


def _plan_operands(case):
    """(A, B) of a plan-order case, as the reference's CSRs: RMAT-9 A*A,
    multigrid 32^2 A*P, and R*(A*P) with the reference's A*P."""
    if case == "rmat9_aa":
        a = jgen.rmat_csr(9, 8, 0)
        return a, a
    r, a, p = jgen.galerkin_triple(32, 32, 4)
    if case == "mg32_ap":
        return a, p
    ap = jsp.spgemm(a, p, method="sparse", plan_cache=jcache.PlanCache()).c
    return r, ap


@pytest.mark.parametrize("path", ["executor", "spgemm_lp"])
@pytest.mark.parametrize("case", ["rmat9_aa", "mg32_ap", "mg32_rap"])
def test_plans_keep_the_order_the_replay_kernels_rely_on(case, path):
    """The CUDA replay kernels write each segment once from sorted tiles:
    live seg_ids are non-decreasing from 0 in steps of at most 1 (so every
    live slot is reached), sentinels (nnz_cap) fill only the tail, and the
    ids equal the reference plan's bitwise."""
    ja, jb = _plan_operands(case)
    ta, tb = _to_torch(ja), _to_torch(jb)
    want = np.asarray(jsp.spgemm(ja, jb, method="sparse",
                                 plan_cache=jcache.PlanCache()).plan.seg_ids)
    if path == "executor":
        plan = texec.ReuseExecutor.from_matrices(ta, tb, backend="pallas",
                                                 plan_cache=tcache.PlanCache()).plan
    else:
        plan = tsp.spgemm(ta, tb, method="lp", plan_cache=tcache.PlanCache()).plan
    seg = plan.seg_ids.numpy()
    nnz_cap, nnz = plan.indices.shape[0], int(plan.indptr[-1])
    assert seg.dtype == np.int32
    np.testing.assert_array_equal(seg, want)
    live = seg < nnz_cap
    n_live = int(live.sum())
    assert n_live > 0 and live[:n_live].all() and (seg[n_live:] == nnz_cap).all()
    steps = np.diff(seg[:n_live].astype(np.int64))
    assert seg[0] == 0 and steps.min() >= 0 and steps.max() <= 1
    assert seg[n_live - 1] == nnz - 1  # every slot of C's structure is reached

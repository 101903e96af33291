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
    {"backend": "bogus"}, {"tune": "bogus"}, {"validate": "bogus"},
    {"tune": "measure", "backend": "pallas"}, {"tune": "measure", "backend": "xla"},
    {"on_kernel_failure": "retry"},
])
def test_later_slice_options_raise_config_errors(kwargs):
    """Invalid values of the reference's options raise, as in the reference
    (every valid value is accepted now that the runtime and autotune layers
    are ported)."""
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
        texec.spgemm_grouped([], tune="bogus")
    assert texec.spgemm_grouped([], tune="measure") == []


def test_telemetry_snapshot_diff_and_reset():
    ja, jb = PROBLEMS["random"]()
    ta, tb = _to_torch(ja), _to_torch(jb)
    before = ttelemetry.snapshot()
    ex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False)
    ex.apply(ta.values, tb.values)
    delta = ttelemetry.diff(before, ttelemetry.snapshot())
    assert delta["hash"] == {"structure_key": 1}
    assert delta["dispatch"] == {"apply": 1}
    assert delta["trace"]["expand_and_sort"] == 1
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


# (A, B) value dtypes -> what "auto" replays them through under the card's
# rules, and the dtype key it leaves: the fresh multiply's routes
# (tests/test_torch_kernels.py FRESH_DTYPES), under the executor's key
AUTO_DTYPES = {
    "f32": ((torch.float32, torch.float32), "pallas", None),
    "bf16xf32": ((torch.bfloat16, torch.float32), "pallas", None),
    "bf16xf16": ((torch.bfloat16, torch.float16), "pallas", None),
    "bf16": ((torch.bfloat16, torch.bfloat16), "xla", None),
    "f16": ((torch.float16, torch.float16), "xla", None),
    "f64": ((torch.float64, torch.float64), "xla", "dtype:executor->xla"),
    "int32": ((torch.int32, torch.int32), "xla", "dtype:executor->xla"),
}
# the replays the executor can reach, spied on by card_rules
REPLAY_FNS = ("numeric_reuse", "_replay_batched", "segsum_reuse", "segsum_reuse_batched",
              "lp_replay_values", "lp_reuse_batched")


@pytest.fixture
def card_rules(monkeypatch):
    """The card's routing on CPU tensors (``ladder.kernels_only`` forced):
    counts each call of the executor's replays, plain and kernel wrappers
    (which run their plain versions on the CPU), by name."""
    from collections import Counter

    from repro_torch.runtime import ladder

    monkeypatch.setattr(ladder, "kernels_only", lambda device: True)
    calls = Counter()
    for name in REPLAY_FNS:
        real = getattr(texec, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(texec, name, spy)
    return calls


def _auto_operands(dtypes, seed=1):
    """A random A (40 x 50) and B (50 x 30) on the CPU, values of ``dtypes``."""
    a = tgen.random_csr(40, 50, 3.0, seed, device="cpu")
    b = tgen.random_csr(50, 30, 2.5, seed + 1, device="cpu")
    g = torch.Generator().manual_seed(seed)
    vals = [(torch.randn(x.nnz_cap, generator=g) * 4).to(dt) for x, dt in zip((a, b), dtypes)]
    return TCSR(a.indptr, a.indices, vals[0], a.shape), TCSR(b.indptr, b.indices, vals[1], b.shape)


@pytest.mark.parametrize("case", sorted(AUTO_DTYPES))
def test_default_apply_routes_by_dtype_under_the_card_rules(case, card_rules):
    """``ReuseExecutor(plan).apply`` under the card's rules: K1 ("pallas")
    where ``fresh_backend`` says so, never the plain ``numeric_reuse`` for
    f32-summed operands; bitwise the plain replay; the dtype key only where
    the guard refuses the kernels; the traced span names what ran."""
    from repro_torch import obs

    dtypes, route, key = AUTO_DTYPES[case]
    a, b = _auto_operands(dtypes)
    assert tsp.fresh_backend(a.values, b.values) == route
    ex = texec.ReuseExecutor(tsp.spgemm(a, b, method="sparse", plan_cache=False).plan)
    assert ex.backend == "xla" and ex.auto
    ttelemetry.FALLBACK_COUNTS.clear()
    card_rules.clear()
    obs.reset_obs()
    with obs.trace_scope("on"):
        got = ex.apply(a.values, b.values)
    kinds = [e["args"].get("kernel") for e in obs.events() if e["name"] == "numeric.dispatch"]
    obs.reset_obs()
    assert ex.last_backend == route and kinds == [route]
    assert dict(card_rules) == {"segsum_reuse" if route == "pallas" else "numeric_reuse": 1}
    assert dict(ttelemetry.FALLBACK_COUNTS) == ({key: 1} if key else {})
    assert got.dtype == torch.promote_types(*dtypes)
    assert torch.equal(got, tsp.numeric_reuse(ex.plan, a.values, b.values))


@pytest.mark.parametrize("case", sorted(AUTO_DTYPES))
def test_default_apply_batched_routes_by_dtype_under_the_card_rules(case, card_rules):
    """``apply_batched`` on a default executor under the card's rules: one
    batched K1 call for f32-summed operands (A stacked, B shared), the
    plain ``_replay_batched`` for the rest; rows bitwise the plain batched
    replay; the dtype key once where the guard refuses the kernels."""
    dtypes, route, key = AUTO_DTYPES[case]
    a, b = _auto_operands(dtypes, seed=3)
    ex = texec.ReuseExecutor(tsp.spgemm(a, b, method="sparse", plan_cache=False).plan)
    g = torch.Generator().manual_seed(4)
    a_stack = (torch.randn(3, a.nnz_cap, generator=g) * 4).to(dtypes[0])
    ttelemetry.FALLBACK_COUNTS.clear()
    card_rules.clear()
    got = ex.apply_batched(a_stack, b.values)
    assert ex.last_backend == route
    assert dict(card_rules) == {"segsum_reuse_batched" if route == "pallas"
                                else "_replay_batched": 1}
    assert dict(ttelemetry.FALLBACK_COUNTS) == ({key: 1} if key else {})
    assert got.shape == (3, ex.nnz_cap)
    for i in range(3):  # each row bitwise the plain single replay
        assert torch.equal(got[i], tsp.numeric_reuse(ex.plan, a_stack[i], b.values))


def test_default_replay_steps_k1_to_k2_under_the_card_rules(card_rules):
    """An armed ``kernel:pallas`` steps the default replay, single and
    batched, to K2 (one ``fault:pallas->pallas_lp`` each), never to the
    plain version; both armed raise ``KernelFallbackError``."""
    from repro_torch.runtime import faults
    from repro_torch.runtime.validate import KernelFallbackError

    a, b = _auto_operands((torch.float32, torch.float32), seed=5)
    ex = texec.ReuseExecutor(tsp.spgemm(a, b, method="sparse", plan_cache=False).plan)
    a_stack = torch.stack([a.values, -a.values])
    ttelemetry.FALLBACK_COUNTS.clear()
    card_rules.clear()
    try:
        with faults.failpoint("kernel:pallas"):
            got = ex.apply(a.values, b.values)
            assert (ex.last_backend, ex.last_step) == ("pallas_lp", "pallas->pallas_lp")
            batched = ex.apply_batched(a_stack, b.values)
            assert ex.last_backend == "pallas_lp"
        assert dict(ttelemetry.FALLBACK_COUNTS) == {"fault:pallas->pallas_lp": 2}
        assert dict(card_rules) == {"lp_replay_values": 1, "lp_reuse_batched": 1}
        assert torch.equal(got, tsp.numeric_reuse(ex.plan, a.values, b.values))
        assert torch.equal(batched[0], got)
        with faults.failpoint("kernel:pallas"), faults.failpoint("kernel:pallas_lp"):
            with pytest.raises(KernelFallbackError):
                ex.apply(a.values, b.values)
            with pytest.raises(KernelFallbackError):
                ex.apply_batched(a_stack, b.values)
    finally:
        faults.reset_failpoints()
    assert card_rules["numeric_reuse"] == card_rules["_replay_batched"] == 0


def test_default_grouped_replays_through_k1_under_the_card_rules(card_rules):
    """``spgemm_grouped(pairs)`` under the card's rules: a group of two
    shares one batched K1 call, a singleton one K1 call, and nothing
    reaches the plain replays; each result bitwise the plain replay."""
    a, b = _auto_operands((torch.float32, torch.float32), seed=7)
    a2 = TCSR(a.indptr, a.indices, -2.0 * a.values, a.shape)
    c, d = _auto_operands((torch.float32, torch.float32), seed=9)
    card_rules.clear()
    got = texec.spgemm_grouped([(a, b), (c, d), (a2, b)], plan_cache=False)
    assert dict(card_rules) == {"segsum_reuse_batched": 1, "segsum_reuse": 1}
    assert not ttelemetry.FALLBACK_COUNTS
    for (x, y), res in zip([(a, b), (c, d), (a2, b)], got):
        plan = tsp.spgemm(x, y, method="sparse", plan_cache=False).plan
        assert torch.equal(res.values, tsp.numeric_reuse(plan, x.values, y.values))


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_default_replay_on_the_cpu_is_the_plain_replay(problem):
    """Without the card's rules "auto" is the plain replay, as the
    reference's: bitwise an explicit "xla" executor, single and batched,
    and within RTOL of the reference's replay."""
    ja, jb, ta, tb, jex = _pinned(problem)
    tex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False)
    xla = texec.ReuseExecutor(tex.plan, backend="xla")
    av, bv = _values(ja.nnz_cap, 11), _values(jb.nnz_cap, 12)
    got = tex.apply(torch.from_numpy(av), torch.from_numpy(bv))
    assert tex.last_backend == "xla"
    assert torch.equal(got, xla.apply(torch.from_numpy(av), torch.from_numpy(bv)))
    stack = torch.from_numpy(_values(ja.nnz_cap, 13, batch=2))
    assert torch.equal(tex.apply_batched(stack, torch.from_numpy(bv)),
                       xla.apply_batched(stack, torch.from_numpy(bv)))
    np.testing.assert_allclose(np.asarray(jex.apply(jnp.asarray(av), jnp.asarray(bv))),
                               got.numpy(), rtol=RTOL, atol=ATOL)

"""repro_torch.core.spgemm (sparse and LP methods), meta and plan cache
against the JAX package.

The same numpy-seeded operands go through both packages. Integer outputs
(the five plan arrays, C's structure, row sizes, flops_stats, the structure
key, every capacity and selection decision) must match bitwise; f32 values
within rtol/atol 1e-5, the tolerance of the reference's own replay tests.
The reference's method="lp" reaches a Pallas kernel whose interpret mode
does not run on this jax, so the port's "lp" is held against the
reference's "sparse" (the same function). f64 goes against numpy float64,
since the reference runs with x64 off.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meta as jmeta
from repro.core.compression import flops_stats as j_flops_stats
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.core.plan_cache import structure_key as j_structure_key
from repro.sparse import CSR as JCSR
from repro.sparse import generators as jgen
from repro_torch.core import meta as tmeta
from repro_torch.core import telemetry as ttelemetry
from repro_torch.core.compression import flops_stats as t_flops_stats
from repro_torch.core.plan_cache import PlanCache as TPlanCache
from repro_torch.core.plan_cache import structure_key as t_structure_key
from repro_torch.runtime.validate import CapacityOverflowError, SpgemmConfigError
from repro_torch.sparse import CSR as TCSR
from repro_torch.sparse import generators as tgen

jsp = importlib.import_module("repro.core.spgemm")
tsp = importlib.import_module("repro_torch.core.spgemm")

PLAN_FIELDS = ("indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s")


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


def _pair(jm, dtype=None):
    """A reference CSR and the port's copy of the same arrays (CPU)."""
    vals = np.asarray(jm.values)
    jvals = jm.values
    tvals = torch.from_numpy(vals.copy())
    if dtype is not None:
        jvals = jnp.asarray(vals, dtype["jax"])
        tvals = tvals.to(dtype["torch"])
    j = JCSR(jm.indptr, jm.indices, jvals, jm.shape)
    t = TCSR(torch.from_numpy(np.asarray(jm.indptr).copy()),
             torch.from_numpy(np.asarray(jm.indices).copy()), tvals, tuple(jm.shape))
    return j, t


def _empty_rows():
    dense = np.zeros((12, 9), np.float32)
    rng = np.random.default_rng(11)
    for r in (0, 3, 4, 10):
        dense[r, rng.choice(9, 3, replace=False)] = rng.standard_normal(3)
    return JCSR.from_dense(dense, nnz_cap=20)


def _galerkin_ap():
    r, a, p = jgen.galerkin_triple(12, 12, 4)
    return a, p


def _galerkin_rap():
    r, a, p = jgen.galerkin_triple(12, 12, 4)
    ap = jsp.spgemm(a, p, method="sparse", plan_cache=False).c
    return r, ap


CASES = {
    "random": lambda: (jgen.random_csr(40, 50, 3.0, 1), jgen.random_csr(50, 30, 2.5, 2)),
    "banded": lambda: (jgen.banded_csr(64, 3, 1), jgen.banded_csr(64, 2, 2)),
    "galerkin_ap": _galerkin_ap,
    "galerkin_rap": _galerkin_rap,
    "rmat8": lambda: (jgen.rmat_csr(8, 8, 0), jgen.rmat_csr(8, 8, 0)),
    "empty_rows": lambda: (_empty_rows(), jgen.random_csr(9, 14, 2.0, 4)),
    "zero_operand": lambda: (jgen.random_csr(10, 8, 2.0, 5),
                             JCSR.from_dense(np.zeros((8, 6), np.float32))),
    # (m+1)*k > 2^31: the reference's fused two-key sort, the port's int64 key
    "wide_key": lambda: (jgen.random_csr(70_000, 70_000, 0.02, 5),
                         jgen.random_csr(70_000, 70_000, 0.02, 6)),
}


def _both_spgemm(ja, jb, ta, tb, method="sparse", pad_policy=None):
    jr = jsp.spgemm(ja, jb, method="sparse", pad_policy=pad_policy, plan_cache=JPlanCache())
    tr = tsp.spgemm(ta, tb, method=method, pad_policy=pad_policy, plan_cache=TPlanCache())
    return jr, tr


def _assert_plan_equal(jplan, tplan):
    for f in PLAN_FIELDS:
        got = getattr(tplan, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(np.asarray(getattr(jplan, f)), got.numpy(), err_msg=f)
    assert tuple(jplan.shape) == tuple(tplan.shape)


@pytest.mark.parametrize("policy", ["pow2", "exact8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_spgemm_matches_reference(case, policy):
    ja, jb = CASES[case]()
    (ja, ta), (jb, tb) = _pair(ja), _pair(jb)
    jr, tr = _both_spgemm(ja, jb, ta, tb, pad_policy=policy)
    _assert_plan_equal(jr.plan, tr.plan)
    np.testing.assert_array_equal(np.asarray(jr.c.indptr), tr.c.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(jr.c.indices), tr.c.indices.numpy())
    np.testing.assert_allclose(np.asarray(jr.c.values), tr.c.values.numpy(),
                               rtol=1e-5, atol=1e-5)
    for key in ("fm", "maxrf", "fm_cap", "nnz_c", "nnz_cap", "kernel", "method",
                "avg_row_flops", "pad_policy", "structure_key", "cache"):
        assert jr.stats[key] == tr.stats[key], key


@pytest.mark.parametrize("case", ["random", "galerkin_ap", "rmat8", "empty_rows", "wide_key"])
def test_expansion_and_row_sizes_match_reference(case):
    ja, jb = CASES[case]()
    (ja, ta), (jb, tb) = _pair(ja), _pair(jb)
    fm_cap = jsp.host_fm_cap(ja, jb)
    assert tsp.host_fm_cap(ta, tb) == fm_cap
    jx, tx = jsp.expand_products(ja, jb, fm_cap), tsp.expand_products(ta, tb, fm_cap)
    for f in ("row", "col", "a_slot", "b_slot", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jx, f)),
                                      getattr(tx, f).numpy(), err_msg=f)
    js, ts = jsp.expand_and_sort(ja, jb, fm_cap), tsp.expand_and_sort(ta, tb, fm_cap)
    for f in ("order", "seg_ids", "heads", "row_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)


@pytest.mark.parametrize("case", ["random", "banded", "rmat8", "empty_rows", "zero_operand"])
def test_flops_stats_match_reference(case):
    ja, jb = CASES[case]()
    (ja, ta), (jb, tb) = _pair(ja), _pair(jb)
    want = j_flops_stats(ja, jb.row_nnz())
    got = t_flops_stats(ta, tb.row_nnz())
    assert int(want[0]) == int(got[0]) and int(want[2]) == int(got[2])
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())


@pytest.mark.parametrize("case", ["random", "galerkin_rap", "zero_operand"])
@pytest.mark.parametrize("policy", ["pow2", "exact8"])
def test_structure_key_has_the_reference_digest(case, policy):
    ja, jb = CASES[case]()
    (ja, ta), (jb, tb) = _pair(ja), _pair(jb)
    ja2, jb2, _, _, fm_cap = jsp.prepare_sparse_inputs(ja, jb, policy)
    ta2, tb2, _, _, t_fm_cap = tsp.prepare_sparse_inputs(ta, tb, policy)
    assert t_fm_cap == fm_cap
    assert t_structure_key(ta2, tb2, fm_cap, policy) == j_structure_key(ja2, jb2, fm_cap, policy)


def test_plan_cache_hit_skips_the_expansion():
    ja, jb = CASES["random"]()
    (_, ta), (_, tb) = _pair(ja), _pair(jb)
    cache = TPlanCache()
    first = tsp.spgemm(ta, tb, method="sparse", plan_cache=cache)
    stages = dict(tsp.STAGE_COUNTS)
    again = tsp.spgemm(ta, tb, method="sparse", plan_cache=cache)
    assert (first.stats["cache"], again.stats["cache"]) == ("miss", "hit")
    assert tsp.STAGE_COUNTS["expand_and_sort"] == stages["expand_and_sort"] == 1
    assert again.plan is first.plan
    assert cache.stats()["hits"] == 1
    bypass = tsp.spgemm(ta, tb, method="sparse", plan_cache=False)
    assert bypass.stats["cache"] == "bypass"
    torch.testing.assert_close(bypass.c.values, first.c.values, rtol=0, atol=0)


def test_plan_cache_lru_and_bytes_bound_match_reference():
    """Same insert sequence, same evictions and byte accounting."""
    caps = {}
    for pkg, cache_cls, sp, gen, kw in (("jax", JPlanCache, jsp, jgen, {}),
                                        ("torch", TPlanCache, tsp, tgen, {"device": "cpu"})):
        plans = [sp.spgemm(gen.random_csr(20 + i, 20 + i, 2.0, i, **kw),
                           gen.random_csr(20 + i, 20 + i, 2.0, i + 10, **kw),
                           method="sparse", plan_cache=False).plan for i in range(4)]
        small = cache_cls(capacity=2, name="small")
        for i, plan in enumerate(plans):
            small.put(f"k{i}", plan)
        small.get("k2")
        small.set_meta("k2", "x", 1)
        tight = cache_cls(capacity=16, max_bytes=1, name="tight")
        for i, plan in enumerate(plans):
            tight.put(f"k{i}", plan)
        stats = [small.stats(), tight.stats()]
        if pkg == "jax":
            # the reference's plan shape leaves are two 4-byte arrays after
            # jit; the port's shape is a plain tuple and pins no device bytes
            for st in stats:
                st["bytes"] -= 8 * st["size"]
        caps[pkg] = (sorted(small._entries), small.get_meta("k2", "x"),
                     small.set_meta("k0", "x", 1), sorted(tight._entries), stats)
    assert caps["jax"] == caps["torch"]


@pytest.mark.parametrize("case", ["random", "galerkin_ap", "rmat8", "empty_rows"])
def test_lp_method_matches_reference_sparse(case):
    ja, jb = CASES[case]()
    (ja, ta), (jb, tb) = _pair(ja), _pair(jb)
    jr, tr = _both_spgemm(ja, jb, ta, tb, method="lp")
    _assert_plan_equal(jr.plan, tr.plan)
    assert tr.stats["method"] == "lp"
    assert tr.stats["lp_backend"] == tr.stats["replay_backend"] == "pallas"
    np.testing.assert_allclose(np.asarray(jr.c.values), tr.c.values.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not ttelemetry.FALLBACK_COUNTS


def test_lp_method_f64_takes_the_plain_path_against_numpy():
    a = tgen.random_csr(30, 40, 3.0, 1, dtype=np.float64, device="cpu")
    b = tgen.random_csr(40, 20, 3.0, 2, dtype=np.float64, device="cpu")
    res = tsp.spgemm(a, b, method="lp", plan_cache=False)
    assert res.stats["lp_backend"] == "xla"
    assert ttelemetry.FALLBACK_COUNTS == {"dtype:lp->xla": 1}
    assert res.c.values.dtype == torch.float64
    np.testing.assert_allclose(res.c.to_dense().numpy(),
                               a.to_dense().numpy() @ b.to_dense().numpy(),
                               rtol=1e-12, atol=1e-12)


BF16 = {"jax": jnp.bfloat16, "torch": torch.bfloat16}
F32 = {"jax": jnp.float32, "torch": torch.float32}


@pytest.mark.parametrize("dtypes", [(BF16, BF16), (BF16, F32)], ids=["bf16", "bf16xf32"])
def test_bf16_values_match_reference(dtypes):
    """bf16 x bf16 accumulates in bf16 in both packages; bf16 x f32 in f32."""
    ja, jb = CASES["random"]()
    (ja, ta), (jb, tb) = _pair(ja, dtypes[0]), _pair(jb, dtypes[1])
    assert np.asarray(ja.values).tobytes() == ta.values.view(torch.int16).numpy().tobytes()
    jr, tr = _both_spgemm(ja, jb, ta, tb)
    want = np.asarray(jr.c.values.astype(jnp.float32))
    assert tr.c.values.dtype == torch.promote_types(*(d["torch"] for d in dtypes))
    np.testing.assert_allclose(want, tr.c.values.float().numpy(), rtol=1e-5, atol=1e-5)


def test_f64_sparse_values_against_numpy():
    a = tgen.banded_csr(50, 2, 1, dtype=np.float64, device="cpu")
    b = tgen.banded_csr(50, 3, 2, dtype=np.float64, device="cpu")
    res = tsp.spgemm(a, b, method="sparse", plan_cache=False)
    assert res.c.values.dtype == torch.float64
    np.testing.assert_allclose(res.c.to_dense().numpy(),
                               a.to_dense().numpy() @ b.to_dense().numpy(),
                               rtol=1e-12, atol=1e-12)


def test_auto_method_and_later_slice_options_raise_config_errors():
    """The dense method (chosen by "auto" at small k) against the reference's
    spgemm(method="dense"): structure bitwise, f32 values within 1e-5, f64
    against numpy float64 (x64 is off in the reference). The options of later
    slices still raise."""
    ja = jgen.random_csr(10, 10, 2.0, 0)
    jb = jgen.random_csr(10, 12, 3.0, 1)
    ja, a = _pair(ja)
    jb, b = _pair(jb)
    stats = {}
    assert tmeta.choose_method(a, a, stats) == "dense"
    for method in ("auto", "dense"):
        want = jsp.spgemm(ja, jb, method=method)
        got = tsp.spgemm(a, b, method=method)
        assert got.stats["method"] == want.stats["method"] == "dense"
        assert got.plan is None and want.plan is None
        assert got.stats == want.stats
        np.testing.assert_array_equal(got.c.indptr.numpy(), np.asarray(want.c.indptr))
        np.testing.assert_array_equal(got.c.indices.numpy(), np.asarray(want.c.indices))
        np.testing.assert_allclose(got.c.values.numpy(), np.asarray(want.c.values),
                                   rtol=1e-5, atol=1e-5)
    a64 = tgen.random_csr(10, 10, 2.0, 0, dtype=np.float64, device="cpu")
    b64 = tgen.random_csr(10, 12, 3.0, 1, dtype=np.float64, device="cpu")
    got = tsp.spgemm(a64, b64, method="dense")
    assert got.c.values.dtype == torch.float64
    np.testing.assert_allclose(got.c.to_dense().numpy(),
                               a64.to_dense().numpy() @ b64.to_dense().numpy(),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(SpgemmConfigError):
        tsp.spgemm(a, a, method="bogus")
    # only mesh= still raises; invalid values of the other options raise as
    # in the reference, and tune="measure" does not compose with method="lp"
    for method, kw in (("sparse", {"mesh": object()}), ("sparse", {"tune": "bogus"}),
                       ("sparse", {"validate": "bogus"}), ("sparse", {"trace": "bogus"}),
                       ("lp", {"tune": "measure"})):
        with pytest.raises(SpgemmConfigError):
            tsp.spgemm(a, a, method=method, **kw)


@pytest.mark.parametrize("case", ["random", "galerkin_ap", "rmat8", "empty_rows", "zero_operand"])
def test_numeric_fresh_and_lp_match_the_reference(case):
    """numeric_fresh: C, plan and values against the reference's. numeric_lp
    (values through the LP replay) against the reference's numeric_fresh: the
    reference's numeric_lp reaches a Pallas kernel that does not run
    interpreted on this jax."""
    (ja, ta), (jb, tb) = (_pair(x) for x in CASES[case]())
    fm = int(j_flops_stats(ja, jb.row_nnz())[0])
    fm_cap = tmeta.round_capacity(fm)
    nnz = int(jsp.symbolic(ja, jb)[0].sum())
    for nnz_cap in (tmeta.round_capacity(nnz), max(-(-nnz // 8) * 8, 8)):
        jc, jplan = jsp.numeric_fresh(ja, jb, fm_cap, nnz_cap)
        for fn in (tsp.numeric_fresh, tsp.numeric_lp):
            tc, tplan = fn(ta, tb, fm_cap, nnz_cap)
            _assert_plan_equal(jplan, tplan)
            np.testing.assert_array_equal(tc.indptr.numpy(), np.asarray(jc.indptr))
            np.testing.assert_array_equal(tc.indices.numpy(), np.asarray(jc.indices))
            np.testing.assert_allclose(tc.values.numpy(), np.asarray(jc.values),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "banded", "rmat8", "empty_rows", "zero_operand"])
def test_numeric_dense_acc_matches_the_reference(case):
    """The dense accumulator's C, with nnz_cap above, at and below nnz(C):
    structure bitwise (cut or padded as the reference's fixed-size
    nonzero), values within 1e-5."""
    (ja, ta), (jb, tb) = (_pair(x) for x in CASES[case]())
    fm_cap = tmeta.round_capacity(int(j_flops_stats(ja, jb.row_nnz())[0]))
    nnz = int(jsp.symbolic(ja, jb)[0].sum())
    for nnz_cap in sorted({max(nnz - 3, 1), max(nnz, 1), nnz + 9}):
        jc = jsp.numeric_dense_acc(ja, jb, fm_cap, nnz_cap)
        tc = tsp.numeric_dense_acc(ta, tb, fm_cap, nnz_cap)
        np.testing.assert_array_equal(tc.indptr.numpy(), np.asarray(jc.indptr))
        np.testing.assert_array_equal(tc.indices.numpy(), np.asarray(jc.indices))
        np.testing.assert_allclose(tc.values.numpy(), np.asarray(jc.values),
                                   rtol=1e-5, atol=1e-5)
        assert tc.values.dtype == ta.values.dtype


def test_more_than_int32_products_raise_capacity_overflow():
    """50 000 A entries, each meeting a 50 000-entry row of B: 2.5e9 products,
    past the int32 plan arrays (the reference's int32 sum would wrap)."""
    n = 50_000
    a = TCSR(torch.tensor([0, n], dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
             torch.ones(n), (1, 1))
    b = TCSR(torch.tensor([0, n], dtype=torch.int32), torch.arange(n, dtype=torch.int32),
             torch.ones(n), (1, n))
    with pytest.raises(CapacityOverflowError):
        tsp.spgemm(a, b, method="sparse", plan_cache=False)


def test_repad_keeps_the_live_prefix_and_refuses_to_truncate():
    ja = jgen.random_csr(20, 20, 2.0, 3)
    ja, ta = _pair(ja)
    nnz = int(ta.indptr[-1])
    for cap in (nnz, 64):
        jr, tr = jsp._repad_csr(ja, cap), tsp._repad_csr(ta, cap)
        np.testing.assert_array_equal(np.asarray(jr.indices), tr.indices.numpy())
        np.testing.assert_array_equal(np.asarray(jr.values), tr.values.numpy())
    assert tsp._repad_csr(ta, ta.nnz_cap) is ta
    with pytest.raises(CapacityOverflowError):
        tsp._repad_csr(ta, nnz - 1)


@pytest.mark.parametrize("policy", ["pow2", "exact8"])
def test_round_capacity_matches_reference(policy):
    for x in [0, 1, 7, 8, 9, 15, 16, 17, 1000, 2**20 - 1, 2**20, 2**20 + 1, 2**31 - 1]:
        assert tmeta.round_capacity(x, policy) == jmeta.round_capacity(x, policy)
    with pytest.raises(SpgemmConfigError):
        tmeta.round_capacity(5, "bogus")


def test_selection_constants_and_ties_match_reference():
    for name in ("DENSE_K_CUTOFF", "AVG_ROW_FLOPS_CUTOFF", "DENSE_BYTES_BUDGET", "PAD_POLICIES", "DEFAULT_PAD_POLICY",
                 "CAPACITY_FLOOR"):
        assert getattr(tmeta, name) == getattr(jmeta, name), name

    class Shape:  # choose_* read only shapes and value dtypes
        def __init__(self, m, k, dtype):
            self.m, self.k, self.shape = m, k, (m, k)
            self.values = type("V", (), {"dtype": dtype})()

    m = 100
    for fm in (255 * m, 256 * m, 256 * m - 1, 0):  # the tie at 256 -> flat_lp
        js, ts = {"fm": fm}, {"fm": fm}
        a_j, a_t = Shape(m, 10, np.float32), Shape(m, 10, torch.float32)
        assert tmeta.choose_kernel(a_t, a_t, ts) == jmeta.choose_kernel(a_j, a_j, js)
        assert ts["avg_row_flops"] == js["avg_row_flops"]
        assert ts["kernel_source"] == js["kernel_source"] == "static"
    with pytest.raises(KeyError):
        tmeta.choose_kernel(a_t, a_t, {})
    # (m, k) placing dense_bytes just at, below and above the 1 GiB budget
    budget_k = jmeta.DENSE_BYTES_BUDGET // (8 * 1024)
    for (m, k), (jd, td) in [
        ((1024, budget_k), (np.float32, torch.float32)),       # == budget -> dense
        ((1024, budget_k + 1), (np.float32, torch.float32)),   # over -> sparse
        ((1024, budget_k), (np.float64, torch.float64)),       # f64 counts 8 bytes
        ((10, 300_000), (np.float32, torch.float32)),          # k past the cutoff
        ((10, 10), (np.float16, torch.float16)),
    ]:
        js, ts = {}, {}
        want = jmeta.choose_method(Shape(m, 1, jd), Shape(1, k, jd), js)
        got = tmeta.choose_method(Shape(m, 1, td), Shape(1, k, td), ts)
        assert got == want and ts == js


@pytest.mark.parametrize("pair", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float16", "float32"),
    ("bfloat16", "float32"), ("float64", "float32"),
    ("int32", "float32"), ("int16", "float32"), ("int8", "bfloat16"),
    ("bool", "float16"), ("int32", "int32"), ("float64", "float64"),
])
def test_f32_accumulation_ok_matches_reference(pair):
    jd = [jnp.dtype(x) for x in pair]
    td = [getattr(torch, x) for x in pair]
    assert tmeta.f32_accumulation_ok(*td) == jmeta.f32_accumulation_ok(*jd)


def test_f32_accumulation_ok_accepts_bf16_with_f16():
    """numpy cannot promote bf16 with f16, so the reference raises on this
    pair; the port accepts it, since both fit the kernels' f32 accumulator."""
    assert tmeta.f32_accumulation_ok(torch.bfloat16, torch.float16)

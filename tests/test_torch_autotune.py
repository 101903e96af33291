"""repro_torch.core.autotune and the fitted choosers against the JAX package.

Tolerances: bitwise for keys, counters and JSON (``to_json`` of the same
row sets, ``bucket_key`` tuples, ``TUNE_COUNTS``); values of a measured
replay or numeric phase against the reference's plain ("xla") output at
rtol/atol 1e-5, the tolerance of the reference's own tests.

Measure mode is held to its counter contract with the port's candidates on
the CPU (each kernel name runs its plain version there): one
``micro_bench``, then ``plan_meta_hit`` or ``bucket_hit`` and zero re-tuning
across ``spgemm``, ``ReuseExecutor`` and ``spgemm_grouped``. The
reference's own measure mode cannot be the yardstick here: on this jax its
Pallas replay candidates do not run interpreted.
"""
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jtune
from repro.core import meta as jmeta
from repro.core.spgemm import spgemm as jspgemm
from repro.kernels import ops as jops
from repro.sparse import CSR as JCSR
from repro.sparse import generators as jgen
from repro_torch import obs as tobs
from repro_torch.core import autotune as ttune
from repro_torch.core import executor as texec
from repro_torch.core import meta as tmeta
from repro_torch.core import telemetry as ttelemetry
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.spgemm import spgemm
from repro_torch.kernels import ops as tops
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.sparse import generators as tgen
from repro_torch.sparse.oracle import gustavson_ell_structure

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_port_state():
    """The port's own registries are process-global too: counters, tuner,
    failpoints and obs state start clean and never leak forward."""
    ttelemetry.reset_all()
    ttune.reset_tuner()
    tfaults.reset_failpoints()
    tobs.reset_obs()
    yield
    ttune.reset_tuner()
    tfaults.reset_failpoints()
    tobs.reset_obs()


def _pair(m, k, n, seed):
    """The same operands in both packages (byte-identical generators)."""
    ja = jgen.random_csr(m, k, 3.0, seed)
    jb = jgen.random_csr(k, n, 3.0, seed + 1)
    ta = tgen.random_csr(m, k, 3.0, seed, device="cpu")
    tb = tgen.random_csr(k, n, 3.0, seed + 1, device="cpu")
    return ja, jb, ta, tb


# ------------------------------------------------------------------- fitting


def _rows(points, backend="cpu", platform="cpu"):
    """Accumulator timing rows in the reference's schema:
    ``accumulators/<regime>/<arm>`` with ``derived.avg_row_flops``."""
    rows = []
    for i, (arf, t_dense, t_lp) in enumerate(points):
        for arm, us in (("dense_acc", t_dense), ("segsum", 999.0), ("lp_hash", t_lp)):
            rows.append({"name": f"accumulators/r{i}/{arm}", "us_per_call": us,
                         "backend": backend, "platform": platform,
                         "derived": {"avg_row_flops": arf}})
    return rows


ROW_SETS = {
    "crossover": _rows([(8.0, 10.0, 30.0), (64.0, 25.0, 12.0), (512.0, 80.0, 9.0)]),
    "dense_always": _rows([(5.0, 1.0, 2.0), (1874.0, 5.6, 7.6)]),
    "lp_always": _rows([(5.0, 3.0, 2.0), (300.0, 9.0, 1.0)]),
    "two_backends": (_rows([(5.0, 0.277, 0.347), (1874.0, 5.625, 7.615)], "cuda",
                           "NVIDIA H100 80GB HBM3")
                     + _rows([(4.0, 1.0, 3.0), (600.0, 9.0, 2.0)])),
    "payload": {"rows": _rows([(16.0, 4.0, 5.0), (256.0, 6.0, 2.0)], None, None),
                "backend": "cpu", "platform": "cpu", "jax_version": "0.9.0"},
    "ties_and_junk": _rows([(256.0, 5.0, 5.0), (256.0, 6.0, 4.0)])
                     + [{"name": "accumulators/x/bogus_arm", "us_per_call": 1.0,
                         "derived": {"avg_row_flops": 3.0}},
                        {"name": "other/x/dense_acc", "us_per_call": 1.0},
                        {"name": "accumulators/y/dense_acc", "us_per_call": 1.0,
                         "derived": {}}],
}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_fit_thresholds_json_matches_the_reference(name, tmp_path):
    """The same rows fit to the same table: ``to_json()`` bitwise, and a
    saved port table loads back equal in both packages."""
    rows = ROW_SETS[name]
    want = jtune.fit_thresholds(rows, source="rows")
    got = ttune.fit_thresholds(rows, source="rows")
    dump = json.dumps(got.to_json(), sort_keys=True)
    assert dump == json.dumps(want.to_json(), sort_keys=True)
    path = tmp_path / "fit.json"
    got.save(str(path))
    assert json.dumps(ttune.TunedThresholds.load(str(path)).to_json(), sort_keys=True) == dump
    assert json.dumps(jtune.TunedThresholds.load(str(path)).to_json(), sort_keys=True) == dump
    for fit in got.fits.values():
        assert fit.avg_row_flops_cutoff == 0.0 or fit.avg_row_flops_cutoff == math.inf or (
            0 < fit.avg_row_flops_cutoff < math.inf)


def test_fit_cutoff_never_loses_to_static_and_matches_the_reference():
    pts = [(5.0, 0.277, 0.347), (1874.0, 5.625, 7.615), (40.0, 2.0, 1.0), (90.0, 1.0, 3.0)]
    for static in (1.0, 256.0, 1e6):
        cut = ttune._fit_cutoff(pts, static)
        assert cut == jtune._fit_cutoff(pts, static)
        total = sum(td if arf < cut else tl for arf, td, tl in pts)
        assert total <= sum(td if arf < static else tl for arf, td, tl in pts)


def test_from_json_rejects_other_payloads():
    with pytest.raises(SpgemmConfigError):
        ttune.TunedThresholds.from_json({"kind": "something_else"})
    with pytest.raises(TypeError):
        ttune.set_tuned_thresholds({"fits": {}})


# ---------------------------------------------------------------- bucket keys


@pytest.mark.parametrize("dtypes", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.float16, jnp.float16), (torch.int32, jnp.int32)])
@pytest.mark.parametrize("shape", [(1, 1, 0), (100, 37, 999), (4096, 4096, 1 << 20)])
def test_bucket_key_equals_the_reference(dtypes, shape):
    td, jd = dtypes
    m, k, fm = shape
    for table in ("replay", "numeric"):
        got = ttune.bucket_key(m, k, fm, td, torch.float32, table=table, device="cpu")
        want = jtune.bucket_key(m, k, fm, jnp.dtype(jd), jnp.dtype(jnp.float32), table=table)
        assert got == want
    assert ttune.backend_key("cpu") == jtune.backend_key() == "cpu|cpu"


# ----------------------------------------------------------------- precedence


def test_precedence_static_fitted_measured_with_the_ties():
    """static (tie at 256 -> flat_lp, tie at the 1 GiB budget -> dense) <
    fitted (a row for this backend; its tie goes the same way) < measured
    (a recorded bucket winner beats both)."""
    ja, jb, ta, tb = _pair(8, 16, 16, 1)
    for fm, pick in ((256 * ta.m, "flat_lp"), (256 * ta.m - 1, "dense_acc")):
        js, ts = {"fm": fm}, {"fm": fm}
        assert tmeta.choose_kernel(ta, tb, ts) == jmeta.choose_kernel(ja, jb, js) == pick
        assert ts == js and ts["kernel_source"] == "static"
    m, k = 4096, 32768  # f32: m * k * 8 == the budget exactly -> dense
    a = type(ta)(ta.indptr, ta.indices, ta.values, (m, 64))
    b = type(tb)(tb.indptr, tb.indices, tb.values, (64, k))
    stats = {}
    assert tmeta.choose_method(a, b, stats) == "dense"
    assert stats["dense_bytes"] == tmeta.DENSE_BYTES_BUDGET
    a2 = type(ta)(ta.indptr, ta.indices, ta.values, (m + 1, 64))
    assert tmeta.choose_method(a2, b, {}) == "sparse"

    table = ttune.TunedThresholds({"cpu|cpu": ttune.BackendFit(
        avg_row_flops_cutoff=10.0, dense_k_cutoff=30_000)})
    jtable = jtune.TunedThresholds.from_json(table.to_json())
    ttune.set_tuned_thresholds(table)
    jtune.set_tuned_thresholds(jtable)
    assert ttune.avg_row_flops_cutoff("cpu") == jtune.avg_row_flops_cutoff() == (10.0, "fitted")
    assert ttune.dense_k_cutoff("cpu") == jtune.dense_k_cutoff() == (30_000, "fitted")
    for fm, pick in ((10 * ta.m, "flat_lp"), (10 * ta.m - 1, "dense_acc")):
        js, ts = {"fm": fm}, {"fm": fm}
        assert tmeta.choose_kernel(ta, tb, ts) == jmeta.choose_kernel(ja, jb, js) == pick
        assert ts == js and ts["kernel_source"] == "fitted"
    # k 32,768 is under the paper's 250,000 but not under the fitted 30,000
    stats, jstats = {}, {}
    ja2 = JCSR(ja.indptr, ja.indices, ja.values, (m, 64))
    jb2 = JCSR(jb.indptr, jb.indices, jb.values, (64, k))
    assert tmeta.choose_method(a, b, stats) == jmeta.choose_method(ja2, jb2, jstats) == "sparse"
    assert stats == jstats and stats["method_source"] == "fitted"
    # a table with no row for this backend leaves the static rule in charge
    ttune.set_tuned_thresholds(ttune.TunedThresholds(
        {"cuda|NVIDIA H100 80GB HBM3": ttune.BackendFit(0.0)}))
    assert ttune.avg_row_flops_cutoff("cpu") == (256.0, "static")

    # measured beats fitted: a numeric_values sweep records the bucket winner
    ttune.set_tuned_thresholds(table)
    c_idx, c_nnz = (torch.from_numpy(x) for x in gustavson_ell_structure(ta, tb))
    fm = int(tops.flops_stats(ta, tb.row_nnz())[0])
    got = tops.numeric_values(ta, tb, c_idx, c_nnz, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1}
    winner = ttune.lookup_measured(ttune.bucket_key(
        ta.m, tb.k, fm, ta.values.dtype, tb.values.dtype, table="numeric", device="cpu"))
    assert winner in ("xla", "dense_acc", "flat_lp")
    assert tops.resolve_numeric_kernel(ta, tb, fm=fm) == winner
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1, "bucket_hit": 2}
    want = jops.numeric_values(ja, jb, jnp.asarray(c_idx.numpy()), jnp.asarray(c_nnz.numpy()),
                               kernel="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    jtune.reset_tuner()


# -------------------------------------------------------------- measure mode


def test_measure_counter_contract_across_entry_points():
    """One micro-bench for the structure, then plan_meta_hit / bucket_hit:
    zero re-tuning across spgemm, ReuseExecutor and spgemm_grouped."""
    ja, jb, ta, tb = _pair(40, 50, 45, 3)
    cache = PlanCache()
    res = spgemm(ta, tb, method="sparse", plan_cache=cache, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1}
    assert res.stats["kernel_source"] == "measured"
    winner = res.stats["replay_backend"]
    assert winner in ("xla", "pallas", "pallas_lp")
    want = jspgemm(ja, jb, method="sparse", plan_cache=False)
    np.testing.assert_allclose(res.c.values.numpy(), np.asarray(want.c.values),
                               rtol=RTOL, atol=ATOL)

    again = spgemm(ta, tb, method="sparse", plan_cache=cache, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1, "plan_meta_hit": 1}
    assert again.stats["replay_backend"] == winner

    # no cache: the bucket table answers
    spgemm(ta, tb, method="sparse", plan_cache=False, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1, "plan_meta_hit": 1, "bucket_hit": 1}

    ex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=cache, tune="measure")
    assert ex.kernel_source == "static"
    out = ex.apply(ta.values, tb.values)
    ex.apply(ta.values, tb.values)
    assert ex.kernel_source == "measured" and ex.backend == winner
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1, "plan_meta_hit": 1, "bucket_hit": 2}
    np.testing.assert_allclose(out.numpy(), np.asarray(want.c.values), rtol=RTOL, atol=ATOL)

    grouped = texec.spgemm_grouped([(ta, tb)], plan_cache=cache, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1, "plan_meta_hit": 2, "bucket_hit": 2}
    np.testing.assert_allclose(grouped[0].values.numpy(), np.asarray(want.c.values),
                               rtol=RTOL, atol=ATOL)


def test_grouped_measure_writes_the_plan_meta():
    _, _, ta, tb = _pair(30, 20, 25, 7)
    cache = PlanCache()
    texec.spgemm_grouped([(ta, tb)], plan_cache=cache, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1}
    texec.spgemm_grouped([(ta, tb)], plan_cache=cache, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1, "plan_meta_hit": 1}
    # a batched group stays on the plain batched replay: nothing measured
    texec.spgemm_grouped([(ta, tb), (ta, tb)], plan_cache=cache, tune="measure")
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1, "plan_meta_hit": 1}


def test_measure_respects_the_dtype_guard():
    """int operands: only the plain candidate is timed, and it wins."""
    _, _, ta, tb = _pair(20, 20, 20, 9)
    ai = type(ta)(ta.indptr, ta.indices, ta.values.to(torch.int32), ta.shape)
    bi = type(tb)(tb.indptr, tb.indices, tb.values.to(torch.int32), tb.shape)
    res = spgemm(ai, bi, method="sparse", plan_cache=False, tune="measure")
    assert res.stats["replay_backend"] == "xla"
    c_idx, c_nnz = (torch.from_numpy(x) for x in gustavson_ell_structure(ai, bi))
    tops.numeric_values(ai, bi, c_idx, c_nnz, tune="measure")
    assert dict(tops.KERNEL_COUNTS) == {"xla": 1}
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 2}


@pytest.mark.parametrize("call", ["spgemm_lp", "executor_pin", "grouped_pin", "numeric_pin"])
def test_measure_with_an_explicit_pin_raises(call):
    ja, jb, ta, tb = _pair(10, 12, 14, 4)
    with pytest.raises(SpgemmConfigError):
        if call == "spgemm_lp":
            spgemm(ta, tb, method="lp", tune="measure")
        elif call == "executor_pin":
            texec.ReuseExecutor.from_matrices(ta, tb, backend="pallas", tune="measure")
        elif call == "grouped_pin":
            texec.spgemm_grouped([(ta, tb)], backend="pallas_lp", tune="measure")
        else:
            c_idx, c_nnz = (torch.from_numpy(x) for x in gustavson_ell_structure(ta, tb))
            tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="dense_acc", tune="measure")
    assert not ttelemetry.TUNE_COUNTS


def test_measure_candidates_protocol():
    calls = []
    winner, times = ttune.measure_candidates(
        {"slow": lambda: calls.append("slow") or time.sleep(0.005),
         "fast": lambda: calls.append("fast")}, reps=3)
    assert winner == "fast" and set(times) == {"slow", "fast"}
    assert calls == ["slow"] * 4 + ["fast"] * 4  # one warm-up and 3 timed runs each
    assert ttelemetry.TUNE_COUNTS == {"micro_bench": 1}
    with pytest.raises(SpgemmConfigError):
        ttune.measure_candidates({})
    with pytest.raises(SpgemmConfigError):
        ttune.validate_tune("fast")

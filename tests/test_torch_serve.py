"""repro_torch.serve (SparseService, CircuitBreaker, TrafficLog) against the
JAX package's ``repro.serve``.

Every scenario of ``tests/test_serve_service.py`` runs here case for case,
and so do the two service chaos runs of ``tests/test_faults.py`` and
``tests/test_obs.py``: the same numpy operands (``sparse.generators``, one
seed) go through both services, each with its own fake clock and a no-op
``sleep``, and the two must agree exactly on the verdict sequence (ok, or
the error's class name), each response's backend, group size and
``degraded`` flag, the ``counters`` dict, ``BREAKER_COUNTS``,
``FALLBACK_COUNTS``, ``RETRY_COUNTS`` under ``serve.dispatch``, the warm
stats and ``EVICT_COUNTS`` deltas, the ``TrafficLog.top()`` order and the
structure keys (the same hex). Values agree within rtol/atol 1e-5 (the
reference's replay tolerance).

The reference is compared only through "xla" or armed failpoints: on this
jax its Pallas replay kernels do not run interpreted, so its unarmed
"pallas" falls back. Where a reference scenario serves unarmed "pallas"
traffic, the two packages are compared over the armed part (or over the
same schedule with the failpoint armed throughout), and the port alone runs
the whole schedule under the reference test's own assertions.

Then the card's rules, tested on the CPU with ``runtime.ladder.kernels_only``
forced true: an open breaker routes to the other replay kernel and never to
"xla", batched groups run the batched kernel under the breaker, the span's
``fallback`` names the real step, and the batched entry points equal a
stack of single replays. Their launches on the card: ``cuda``-marked tests
in ``tests/test_torch_kernels.py``.
"""
import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import executor as jexec
from repro.core import plan_cache as jplan_cache
from repro.core import telemetry as jtelemetry
from repro.core.spgemm import spgemm as jspgemm
from repro.runtime import faults as jfaults
from repro.runtime import retry as jretry
from repro.runtime import validate as jvalidate
from repro.sparse import generators as jgen
from repro import serve as jserve
from repro.serve import breaker as jbreaker
from repro_torch import obs as tobs
from repro_torch import serve as tserve
from repro_torch.core import autotune as ttune
from repro_torch.core import executor as texec
from repro_torch.core import plan_cache as tplan_cache
from repro_torch.core import telemetry as ttelemetry
from repro_torch.kernels import _build
from repro_torch.kernels import segsum_reuse as k1
from repro_torch.kernels import spgemm_lp as k2
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import ladder as tladder
from repro_torch.runtime import retry as tretry
from repro_torch.runtime import validate as tvalidate
from repro_torch.serve import breaker as tbreaker
from repro_torch.serve import spgemm_service as tservice
from repro_torch.sparse import generators as tgen

RTOL = ATOL = 1e-5
SERVE_DIR = Path(tserve.__file__).resolve().parent
# the module (the package exports a function of the same name)
tspgemm_mod = importlib.import_module("repro_torch.core.spgemm")


@pytest.fixture(autouse=True)
def _reset_port_state():
    ttelemetry.reset_all()
    ttune.reset_tuner()
    tfaults.reset_failpoints()
    tobs.reset_obs()
    yield
    tfaults.reset_failpoints()
    tobs.reset_obs()


class FakeClock:
    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


class Side:
    """One package's serving tier, and how a scenario reads it."""

    def __init__(self, name: str):
        self.name = name
        ref = name == "ref"
        self.serve = jserve if ref else tserve
        self.breaker_mod = jbreaker if ref else tbreaker
        self.telemetry = jtelemetry if ref else ttelemetry
        self.faults = jfaults if ref else tfaults
        self.validate = jvalidate if ref else tvalidate
        self.retry = jretry if ref else tretry
        self.executor = jexec if ref else texec
        self.plan_cache = jplan_cache if ref else tplan_cache
        self.obs = jobs if ref else tobs
        self.spgemm = jspgemm if ref else tspgemm_mod.spgemm

    def csr(self, m, k, density, seed):
        if self.name == "ref":
            return jgen.random_csr(m, k, density, seed=seed)
        return tgen.random_csr(m, k, density, seed, device="cpu")

    def service(self, **kw):
        kw.setdefault("sleep", lambda _: None)
        return self.serve.SparseService(**kw)


def both(scenario):
    """Run ``scenario(side)`` for the reference and the port; returns the two
    results."""
    return scenario(Side("ref")), scenario(Side("port"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def verdict(r) -> str:
    if not r.done:
        return "pending"
    return "ok" if r.error is None else type(r.error).__name__


def observe(side, svc=None, resps=()) -> dict:
    """What the two packages must agree on after a scenario."""
    tel = side.telemetry
    out = {
        "verdicts": [verdict(r) for r in resps],
        "routes": [(r.backend, r.group_size, r.degraded) for r in resps],
        "breaker": {k: v for k, v in tel.BREAKER_COUNTS.items() if v},
        "fallback": {k: v for k, v in tel.FALLBACK_COUNTS.items() if v},
        "retry": {k: v for k, v in tel.RETRY_COUNTS.items()
                  if k.startswith("serve.dispatch:") and v},
        "values": [None if not r.ok else
                   (_np(r.value.indptr), _np(r.value.indices), _np(r.value.values))
                   for r in resps],
    }
    if svc is not None:
        out.update(counters=dict(svc.counters), queue_depth=svc.queue_depth,
                   top=[(e.skey, e.count) for e in svc.traffic_log.top()])
    return out


def assert_same(ref: dict, port: dict) -> None:
    """Exact agreement on everything but values, which agree within
    rtol/atol 1e-5 on the same structure."""
    for key in ref.keys() - {"values"}:
        assert port[key] == ref[key], key
    assert len(port["values"]) == len(ref["values"])
    for got, want in zip(port["values"], ref["values"]):
        assert (got is None) == (want is None)
        if want is None:
            continue
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)


def ab(side):
    return side.csr(32, 24, 4.0, 1), side.csr(24, 40, 4.0, 2)


def ab2(side):
    return side.csr(16, 24, 3.0, 7), side.csr(24, 8, 3.0, 8)


def oracle_values(side, a, b):
    return _np(side.spgemm(a, b, method="sparse").c.values)


# --------------------------------------------------------------------------
# Admission: backpressure, validation at the door, deadline feasibility
# --------------------------------------------------------------------------


def test_queue_full_rejects_typed():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(max_queue=2)
        rs = [svc.submit(a, b) for _ in range(3)]
        assert not rs[0].done and not rs[1].done
        assert rs[2].done and isinstance(rs[2].error, s.validate.AdmissionRejected)
        assert isinstance(rs[2].error, s.validate.SpgemmError)
        assert svc.counters["shed_queue_full"] == 1 and svc.queue_depth == 2
        return observe(s, svc, rs)

    assert_same(*both(scenario))


def test_corrupt_operand_rejected_at_door():
    def scenario(s):
        a, b = ab(s)
        bad = s.faults.inject_csr("nan_values", a)
        svc = s.service()
        r = svc.submit(bad, b)
        assert r.done and isinstance(r.error, s.validate.SpgemmInputError)
        assert svc.counters["rejected_validation"] == 1 and svc.queue_depth == 0
        healthy = svc.submit(a, b)
        assert not healthy.done
        return observe(s, svc, [r, healthy])

    assert_same(*both(scenario))


def test_validate_off_admits_anything():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(validate="off")
        r = svc.submit(s.faults.inject_csr("nan_values", a), b)
        assert not r.done
        return observe(s, svc, [r])

    assert_same(*both(scenario))


def test_infeasible_deadline_shed_at_admission():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(clock=FakeClock())
        svc.step_hint_s = 1.0
        r = svc.submit(a, b, deadline_s=0.5)
        assert r.done and isinstance(r.error, s.validate.AdmissionRejected)
        assert "infeasible" in str(r.error)
        assert svc.counters["shed_deadline_infeasible"] == 1
        ok = svc.submit(a, b, deadline_s=5.0)
        assert not ok.done
        return observe(s, svc, [r, ok]), str(r.error)

    (ref, ref_msg), (port, port_msg) = both(scenario)
    assert_same(ref, port)
    assert port_msg == ref_msg


def test_idle_service_admits_any_deadline():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(clock=FakeClock())
        r = svc.submit(a, b, deadline_s=1e-9)
        assert not r.done
        return observe(s, svc, [r])

    assert_same(*both(scenario))


def test_expired_deadline_shed_in_queue():
    def scenario(s):
        a, b = ab(s)
        clk = FakeClock()
        svc = s.service(clock=clk)
        r_dead = svc.submit(a, b, deadline_s=1.0)
        r_live = svc.submit(a, b)
        clk.advance(2.0)
        assert svc.step() == 2
        assert isinstance(r_dead.error, s.validate.DeadlineExceeded)
        assert isinstance(r_dead.error, TimeoutError)
        assert r_live.ok
        assert svc.counters["shed_deadline_expired"] == 1
        assert svc.counters["completed"] == 1 and svc.counters["failed"] == 0
        assert svc.stats()["shed_rate"] == 0.5
        return observe(s, svc, [r_dead, r_live])

    assert_same(*both(scenario))


# --------------------------------------------------------------------------
# Batch loop: grouping, dispatch counts, priorities, the empty tick
# --------------------------------------------------------------------------


def test_grouped_batch_one_dispatch_per_group():
    def scenario(s):
        (a, b), (a2, b2) = ab(s), ab2(s)
        svc = s.service(max_batch=8)
        same = [svc.submit(a, b) for _ in range(3)]
        other = svc.submit(a2, b2)
        s.executor.DISPATCH_COUNTS.clear()
        svc.step()
        assert s.executor.DISPATCH_COUNTS["apply_batched"] == 1
        assert s.executor.DISPATCH_COUNTS["apply"] == 1
        ref, ref2 = oracle_values(s, a, b), oracle_values(s, a2, b2)
        for r in same:
            assert r.ok and r.group_size == 3
            np.testing.assert_array_equal(_np(r.value.values), ref)  # bitwise
        assert other.ok and other.group_size == 1
        np.testing.assert_array_equal(_np(other.value.values), ref2)
        return observe(s, svc, same + [other])

    assert_same(*both(scenario))


def test_max_batch_spills_to_next_step():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(max_batch=2)
        rs = [svc.submit(a, b) for _ in range(5)]
        assert svc.step() == 2 and svc.queue_depth == 3
        assert svc.drain() == 3
        assert all(r.ok for r in rs) and svc.counters["steps"] == 3
        return observe(s, svc, rs)

    assert_same(*both(scenario))


def test_priority_order_under_scarce_batch():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(max_batch=1)
        r_low = svc.submit(a, b, priority=0)
        r_high = svc.submit(a, b, priority=5)
        svc.step()
        assert r_high.done and not r_low.done
        first = observe(s, svc, [r_low, r_high])
        svc.step()
        assert r_low.done
        return first, observe(s, svc, [r_low, r_high])

    (ref1, ref2), (port1, port2) = both(scenario)
    assert_same(ref1, port1)
    assert_same(ref2, port2)


def test_empty_step_is_a_noop():
    def scenario(s):
        svc = s.service()
        s.executor.DISPATCH_COUNTS.clear()
        assert svc.step() == 0
        assert s.executor.DISPATCH_COUNTS["apply"] == 0
        assert s.executor.DISPATCH_COUNTS["apply_batched"] == 0
        return observe(s, svc)

    assert_same(*both(scenario))


def test_plan_cache_eviction_mid_stream_is_invisible():
    def scenario(s):
        a, b = ab(s)
        svc = s.service()
        r1 = svc.submit(a, b)
        svc.step()
        svc.plan_cache.clear()
        r2 = svc.submit(a, b)
        svc.step()
        assert r1.ok and r2.ok
        np.testing.assert_array_equal(_np(r2.value.values), oracle_values(s, a, b))
        return observe(s, svc, [r1, r2])

    assert_same(*both(scenario))


# --------------------------------------------------------------------------
# Circuit breaker: unit walk + integrated routing
# --------------------------------------------------------------------------


def test_breaker_state_walk_with_fake_clock():
    def scenario(s):
        bm = s.breaker_mod
        clk = FakeClock()
        br = s.serve.CircuitBreaker("k", failure_threshold=2, window_s=10.0,
                                    cooldown_s=5.0, clock=clk)
        walk = [br.allow(), br.state]
        br.record_failure()
        walk.append(br.state)
        br.record_failure()
        walk += [br.state, br.allow(), br.snapshot()["cooldown_remaining_s"]]
        clk.advance(5.0)
        walk += [br.allow(), br.state, br.allow()]
        br.record_failure()
        walk.append(br.state)
        clk.advance(5.0)
        walk.append(br.allow())
        br.record_success()
        walk += [br.state, br.snapshot()]
        assert walk[:2] == [True, bm.CLOSED] and walk[3] == bm.OPEN
        assert walk[-2] == bm.CLOSED and walk[-1]["recent_failures"] == 0
        return walk, observe(s)

    (ref_walk, ref), (port_walk, port) = both(scenario)
    assert port_walk == ref_walk
    assert_same(ref, port)
    assert port["breaker"] == {"k:open": 1, "k:short_circuit": 2, "k:half_open": 2,
                               "k:reopen": 1, "k:close": 1}
    assert (tbreaker.CLOSED, tbreaker.OPEN, tbreaker.HALF_OPEN) == (
        jbreaker.CLOSED, jbreaker.OPEN, jbreaker.HALF_OPEN)


def test_breaker_window_forgets_stale_failures():
    def scenario(s):
        clk = FakeClock()
        br = s.serve.CircuitBreaker("k", failure_threshold=2, window_s=1.0, clock=clk)
        br.record_failure()
        clk.advance(2.0)
        br.record_failure()
        assert br.state == s.breaker_mod.CLOSED
        return br.snapshot(), observe(s)

    (ref_snap, ref), (port_snap, port) = both(scenario)
    assert port_snap == ref_snap
    assert_same(ref, port)


def _breaker_routes(s, armed_only: bool):
    """The reference test's schedule: two degraded dispatches open the
    breaker, an open breaker short-circuits, a probe under the failure
    reopens it; then (``armed_only`` False) the kernel is fixed and a probe
    closes it."""
    a, b = ab(s)
    clk = FakeClock()
    svc = s.service(backend="pallas", max_batch=1, clock=clk, breaker_threshold=2,
                    breaker_cooldown_s=5.0)
    ref = oracle_values(s, a, b)
    resps = []

    def serve_one():
        r = svc.submit(a, b)
        svc.step()
        assert r.ok
        np.testing.assert_array_equal(_np(r.value.values), ref)
        resps.append(r)
        return r

    with s.faults.failpoint("kernel:pallas"):
        for _ in range(2):
            assert serve_one().degraded
        assert svc._breakers["pallas"].state == s.breaker_mod.OPEN
        fallbacks0 = s.telemetry.FALLBACK_COUNTS["fault:pallas->xla"]
        r = serve_one()
        assert r.backend == "xla" and not r.degraded
        assert s.telemetry.FALLBACK_COUNTS["fault:pallas->xla"] == fallbacks0
        clk.advance(5.0)
        assert serve_one().degraded
        assert svc._breakers["pallas"].state == s.breaker_mod.OPEN
        assert s.telemetry.BREAKER_COUNTS["pallas:reopen"] == 1
    armed = observe(s, svc, resps)
    if armed_only:
        return armed
    clk.advance(5.0)
    r = serve_one()
    assert r.backend == "pallas" and not r.degraded
    assert svc._breakers["pallas"].state == s.breaker_mod.CLOSED
    assert s.telemetry.BREAKER_COUNTS["pallas:close"] == 1
    assert serve_one().backend == "pallas"
    assert svc.counters["degraded_dispatches"] == 3
    return armed


def test_service_breaker_routes_around_broken_kernel():
    ref = _breaker_routes(Side("ref"), armed_only=True)
    port = _breaker_routes(Side("port"), armed_only=False)
    assert_same(ref, port)
    assert ref["breaker"] == {"pallas:open": 1, "pallas:short_circuit": 1,
                              "pallas:half_open": 1, "pallas:reopen": 1}


def test_batched_groups_never_consult_breaker():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(backend="pallas", max_batch=4)
        rs = [svc.submit(a, b) for _ in range(3)]
        with s.faults.failpoint("kernel:pallas"):
            svc.step()
        assert all(r.ok and r.backend == "xla" for r in rs)
        assert svc._breakers["pallas"].state == s.breaker_mod.CLOSED
        assert svc._breakers["pallas"].snapshot()["recent_failures"] == 0
        return observe(s, svc, rs)

    assert_same(*both(scenario))


# --------------------------------------------------------------------------
# Retry integration + telemetry satellites
# --------------------------------------------------------------------------


def test_retry_counts_tick_and_reset():
    def scenario(s):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"

        assert s.retry.retry_call(flaky, retries=3, label="t", sleep=lambda _: None) == "ok"
        counts = dict(s.telemetry.RETRY_COUNTS)
        assert s.telemetry.ALL_COUNTERS["retry"] is s.telemetry.RETRY_COUNTS
        s.telemetry.reset_all()
        assert not s.telemetry.RETRY_COUNTS and not s.telemetry.BREAKER_COUNTS
        assert not s.plan_cache.EVICT_COUNTS
        return counts

    ref, port = both(scenario)
    assert port == ref == {"t:attempt": 3, "t:retry": 2}


def test_retry_label_defaults_to_fn_name():
    def scenario(s):
        def transient_once():
            raise OSError("nope")

        with pytest.raises(s.retry.RetryExhaustedError):
            s.retry.retry_call(transient_once, retries=1, sleep=lambda _: None)
        return dict(s.telemetry.RETRY_COUNTS)

    ref, port = both(scenario)
    assert port == ref
    assert port["transient_once:attempt"] == 2 and port["transient_once:giveup"] == 1


def test_service_dispatch_retries_transient_straggler():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(max_batch=1, retries=2)
        r = svc.submit(a, b)
        s.faults.arm("kernel:xla")
        svc._sleep = lambda dt: s.faults.disarm("kernel:xla")
        svc.step()
        assert r.ok and svc.stats()["retry"]["retries"] == 1
        return observe(s, svc, [r]), svc.stats()["retry"]

    (ref, ref_retry), (port, port_retry) = both(scenario)
    assert_same(ref, port)
    assert port_retry == ref_retry == {"attempts": 2, "retries": 1, "giveups": 0}


def test_service_dispatch_gives_up_typed():
    def scenario(s):
        a, b = ab(s)
        svc = s.service(max_batch=1, retries=1)
        r = svc.submit(a, b)
        with s.faults.failpoint("kernel:xla"):
            svc.step()
        assert r.done and not r.ok and isinstance(r.error, s.validate.SpgemmError)
        assert svc.counters["failed"] == 1
        return observe(s, svc, [r])

    ref, port = both(scenario)
    assert_same(ref, port)
    assert port["verdicts"] == ["RetryExhaustedError"]
    assert port["retry"] == {"serve.dispatch:attempt": 2, "serve.dispatch:retry": 1,
                             "serve.dispatch:giveup": 1}


# --------------------------------------------------------------------------
# Warmer: traffic log, prefetch, eviction tolerance
# --------------------------------------------------------------------------


def test_traffic_log_counts_structures():
    def scenario(s):
        (a, b), (a2, b2) = ab(s), ab2(s)
        log = s.serve.TrafficLog()
        keys = [log.record(a, b) for _ in range(3)] + [log.record(a2, b2)]
        assert len(log) == 2
        top = log.top()
        assert top[0].count == 3 and top[1].count == 1 and log.top(1) == [top[0]]
        return keys, [(e.skey, e.count, e.fm_cap) for e in top]

    ref, port = both(scenario)
    assert port == ref


def test_warm_plan_cache_prefetches():
    def scenario(s):
        a, b = ab(s)
        log = s.serve.TrafficLog()
        log.record(a, b)
        cache = s.plan_cache.PlanCache(capacity=8, name="warmtest")
        stats = [s.serve.warm_plan_cache(log, cache), s.serve.warm_plan_cache(log, cache)]
        svc = s.service(plan_cache=cache)
        misses0 = cache.stats()["misses"]
        r = svc.submit(a, b)
        svc.step()
        assert r.ok and cache.stats()["misses"] == misses0
        return stats, observe(s, svc, [r])

    (ref_stats, ref), (port_stats, port) = both(scenario)
    assert port_stats == ref_stats
    assert port_stats[0] == {"built": 1, "hits": 0, "failed": 0, "evictions": 0}
    assert port_stats[1]["hits"] == 1
    assert_same(ref, port)


def test_warm_detects_cache_thrash():
    def scenario(s):
        log = s.serve.TrafficLog()
        for i in range(4):
            log.record(s.csr(8 + 4 * i, 16, 2.0, 10 + i), s.csr(16, 8, 2.0, 50 + i))
        cache = s.plan_cache.PlanCache(capacity=2, name="thrash")
        stats = s.serve.warm_plan_cache(log, cache)
        return stats, dict(s.plan_cache.EVICT_COUNTS), [e.skey for e in log.top()]

    ref, port = both(scenario)
    assert port == ref
    assert port[0]["built"] == 4 and port[0]["evictions"] == 2 and port[1]["thrash"] == 2


def test_service_warms_from_its_own_traffic():
    def scenario(s):
        a, b = ab(s)
        svc = s.service()
        r = svc.submit(a, b)
        svc.step()
        assert r.ok
        svc.plan_cache.clear()
        stats = svc.warm()
        misses0 = svc.plan_cache.stats()["misses"]
        r2 = svc.submit(a, b)
        svc.step()
        assert svc.plan_cache.stats()["misses"] == misses0
        return stats, observe(s, svc, [r, r2])

    (ref_stats, ref), (port_stats, port) = both(scenario)
    assert port_stats == ref_stats and port_stats["built"] == 1
    assert_same(ref, port)


def test_admission_records_traffic_without_extra_hash():
    def scenario(s):
        a, b = ab(s)
        svc = s.service()
        svc.submit(a, b)
        before = s.telemetry.snapshot()
        svc.submit(a, b)
        delta = s.telemetry.diff(before, s.telemetry.snapshot())
        assert delta.get("hash") == {"structure_key": 1}, delta
        assert svc.traffic_log.top()[0].count == 2
        return delta, observe(s, svc)

    (ref_delta, ref), (port_delta, port) = both(scenario)
    assert port_delta == ref_delta
    assert_same(ref, port)


# --------------------------------------------------------------------------
# Config validation
# --------------------------------------------------------------------------


def test_bad_config_raises():
    def scenario(s):
        msgs = []
        for call, match in ((lambda: s.service(backend="cuda"), "backend"),
                            (lambda: s.service(max_queue=0), "max_queue"),
                            (lambda: s.serve.CircuitBreaker("k", failure_threshold=0),
                             "failure_threshold")):
            with pytest.raises(ValueError, match=match) as e:
                call()
            assert isinstance(e.value, s.validate.SpgemmConfigError)
            msgs.append(str(e.value))
        return msgs

    ref, port = both(scenario)
    assert port == ref


# --------------------------------------------------------------------------
# The service chaos runs (tests/test_faults.py, tests/test_obs.py)
# --------------------------------------------------------------------------


def _chaos_under_traffic(s, armed_throughout: bool):
    """Live traffic while everything misbehaves at once: the fast kernel
    failing, one corrupt request, a forced plan-cache eviction mid-stream.
    Every completed response equals the plain product bitwise; every
    non-completion is typed."""
    structures = [(s.csr(32, 24, 4.0, 1), s.csr(24, 40, 4.0, 2)),
                  (s.csr(16, 24, 3.0, 7), s.csr(24, 8, 3.0, 8)),
                  (s.csr(48, 16, 2.0, 9), s.csr(16, 48, 3.0, 10))]
    refs = [oracle_values(s, a, b) for a, b in structures]
    svc = s.service(backend="pallas", max_batch=2, breaker_threshold=2, retries=1)
    ledger = []

    def pump(i, corrupt=False):
        a, b = structures[i % len(structures)]
        if corrupt:
            a = s.faults.inject_csr("nan_values", a)
        ledger.append((svc.submit(a, b), None if corrupt else refs[i % 3]))

    if armed_throughout:
        s.faults.arm("kernel:pallas")
    try:
        for i in range(4):
            pump(i)
        svc.drain()
        with s.faults.failpoint("kernel:pallas"):
            for i in range(4):
                pump(i)
            svc.drain()
            pump(0, corrupt=True)
            svc.plan_cache.clear()
            for i in range(3):
                pump(i)
            svc.drain()
        if armed_throughout:
            s.faults.arm("kernel:pallas")  # leaving the block disarmed it
        for i in range(3):
            pump(i)
        svc.drain()
    finally:
        s.faults.reset_failpoints()

    assert len(ledger) == 15
    for resp, ref in ledger:
        assert resp.done
        if ref is None:
            assert isinstance(resp.error, s.validate.SpgemmInputError)
        else:
            assert resp.ok, f"unexpected failure: {resp.error!r}"
            np.testing.assert_array_equal(_np(resp.value.values), ref)
    assert s.telemetry.FALLBACK_COUNTS["fault:pallas->xla"] >= 1
    assert s.telemetry.BREAKER_COUNTS["pallas:open"] >= 1
    stats = svc.stats()
    assert (stats["rejected_validation"], stats["completed"], stats["failed"]) == (1, 14, 0)
    return observe(s, svc, [r for r, _ in ledger])


def test_service_chaos_under_traffic():
    """The same schedule with the kernel failing throughout in both packages
    (exact parity); then the port alone on the reference test's schedule,
    whose warm-up and recovery traffic runs the kernel unarmed."""
    assert_same(_chaos_under_traffic(Side("ref"), armed_throughout=True),
                _chaos_under_traffic(Side("port"), armed_throughout=True))
    ttelemetry.reset_all()
    port = _chaos_under_traffic(Side("port"), armed_throughout=False)
    assert port["verdicts"].count("ok") == 14


def _chaos_traced(s, tmp_path, armed_throughout: bool):
    """SparseService under an injected kernel failure with tracing on: the
    Chrome trace carries request ids end to end, the per-phase histograms
    hold real latencies, and the flight recorder names the failing kernel
    and its hop."""
    structures = [(s.csr(32, 24, 4.0, 1), s.csr(24, 40, 4.0, 2)),
                  (s.csr(16, 24, 3.0, 7), s.csr(24, 8, 3.0, 8))]
    refs = [oracle_values(s, a, b) for a, b in structures]
    s.obs.set_tracing("on")
    svc = s.service(backend="pallas", max_batch=2, breaker_threshold=3, retries=1)
    resps = []
    with s.faults.failpoint("kernel:pallas"):
        resps.append(svc.submit(*structures[0]))
        svc.drain()
        if armed_throughout:
            for i in range(1, 4):
                resps.append(svc.submit(*structures[i % 2]))
            svc.drain()
    if not armed_throughout:
        for i in range(1, 4):
            resps.append(svc.submit(*structures[i % 2]))
        svc.drain()
    for i, r in enumerate(resps):
        assert r.ok
        np.testing.assert_array_equal(_np(r.value.values), refs[i % 2])
    assert [r.trace_id for r in resps] == ["req-0", "req-1", "req-2", "req-3"]
    path = tmp_path / f"chaos_{s.name}_{armed_throughout}.json"
    payload = s.obs.export_chrome_trace(str(path))
    assert json.loads(path.read_text())["traceEvents"] == payload["traceEvents"]
    by_tid = {}
    for ev in payload["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        by_tid.setdefault(ev["args"].get("trace_id"), set()).add(ev["name"])
    for tid in ("req-0", "req-1", "req-2", "req-3"):
        assert {"serve.admit", "numeric.dispatch"} <= by_tid[tid], tid
    names = set().union(*by_tid.values())
    assert "plan.build" in names
    reg = s.obs.default_registry()
    for phase in ("plan.build", "numeric.dispatch"):
        h = reg.histogram(phase)
        assert h.count > 0 and h.percentile(99.0) >= h.percentile(50.0) > 0.0, phase
    ring = s.obs.default_recorder().events()
    hops = [e for e in ring if e.get("fallback")]
    assert hops and hops[0]["kernel"] == "pallas" and hops[0]["fallback"] == "pallas->xla"
    assert any(e.get("trace_id") == "req-0" for e in ring)
    dbg = svc.stats(debug=True)
    assert dbg["flight_recorder"]["events"] == ring
    assert dbg["metrics"]["histograms"]["serve.request"]["count"] == 4
    assert "flight_recorder" not in svc.stats()
    spans = sorted((ev["name"], ev["args"].get("trace_id"), ev["args"].get("fallback"),
                    ev["args"].get("kernel")) for ev in payload["traceEvents"])
    hops = [(e["kernel"], e["fallback"], e.get("trace_id")) for e in ring
            if e.get("fallback")]
    return observe(s, svc, resps), spans, hops


def test_service_chaos_traced_end_to_end(tmp_path):
    """Exact parity of verdicts, counters, the spans' names, trace ids,
    kernels and fallback steps, and the recorder's hops, with the kernel
    failing throughout in both packages; the port alone on the reference
    test's schedule (recovery traffic unarmed)."""
    ref = _chaos_traced(Side("ref"), tmp_path, armed_throughout=True)
    jobs.set_tracing("off")
    port = _chaos_traced(Side("port"), tmp_path, armed_throughout=True)
    assert_same(ref[0], port[0])
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    tobs.reset_obs()
    ttelemetry.reset_all()
    _chaos_traced(Side("port"), tmp_path, armed_throughout=False)


# --------------------------------------------------------------------------
# The card's rules, on the CPU (kernels_only forced true)
# --------------------------------------------------------------------------


@pytest.fixture
def card_rules(monkeypatch):
    """The card's routing on CPU tensors: every ladder's rungs are kernels,
    and the batched kernel launches are spied on (on the CPU each runs its
    plain version, which counts no launch)."""
    monkeypatch.setattr(tladder, "kernels_only", lambda device: True)
    calls = []
    real = texec._replay_batched_kernel

    def spy(plan, a_values, b_values, backend):
        calls.append((backend, a_values.shape[0] if a_values.ndim == 2 else None,
                      b_values.shape[0] if b_values.ndim == 2 else None))
        return real(plan, a_values, b_values, backend)

    monkeypatch.setattr(texec, "_replay_batched_kernel", spy)
    return calls


def _port_pair(seed=1):
    return (tgen.random_csr(32, 24, 4.0, seed, device="cpu"),
            tgen.random_csr(24, 40, 4.0, seed + 1, device="cpu"))


def _other_kernel_values(a, b, backend):
    ex = texec.ReuseExecutor.from_matrices(a, b, backend=backend, plan_cache=False)
    return ex.apply(a.values, b.values)


def test_card_open_breaker_routes_to_the_other_kernel(card_rules):
    """The reference test's breaker walk under the card's rules: degraded
    dispatches step pallas -> pallas_lp, an open breaker short-circuits to
    pallas_lp (not degraded, no new fault key), the probe under the failure
    reopens it, the fixed kernel's probe closes it; "xla" appears nowhere."""
    a, b = _port_pair()
    want = _other_kernel_values(a, b, "pallas_lp")
    ttelemetry.reset_all()
    clk = FakeClock()
    svc = tserve.SparseService(backend="pallas", max_batch=1, clock=clk, breaker_threshold=2,
                               breaker_cooldown_s=5.0, sleep=lambda _: None)
    resps = []

    def serve_one():
        r = svc.submit(a, b)
        svc.step()
        assert r.ok
        torch.testing.assert_close(r.value.values, want, rtol=RTOL, atol=ATOL)
        resps.append(r)
        return r

    with tfaults.failpoint("kernel:pallas"):
        for _ in range(2):
            r = serve_one()
            assert r.degraded and r.backend == "pallas"
        assert ttelemetry.FALLBACK_COUNTS == {"fault:pallas->pallas_lp": 2}
        r = serve_one()
        assert r.backend == "pallas_lp" and not r.degraded
        assert ttelemetry.FALLBACK_COUNTS == {"fault:pallas->pallas_lp": 2}
        clk.advance(5.0)
        assert serve_one().degraded
        assert svc._breakers["pallas"].state == tbreaker.OPEN
    clk.advance(5.0)
    r = serve_one()
    assert r.backend == "pallas" and not r.degraded
    assert svc._breakers["pallas"].state == tbreaker.CLOSED
    assert dict(ttelemetry.BREAKER_COUNTS) == {
        "pallas:open": 1, "pallas:short_circuit": 1, "pallas:half_open": 2,
        "pallas:reopen": 1, "pallas:close": 1}
    assert ttelemetry.FALLBACK_COUNTS == {"fault:pallas->pallas_lp": 3}
    assert all("xla" not in str(r.backend) for r in resps)
    assert svc.counters["degraded_dispatches"] == 3
    assert card_rules == []  # singletons only: no batched launch


@pytest.mark.parametrize("fast", ["pallas", "pallas_lp"])
def test_card_batched_groups_take_the_batched_kernel_under_the_breaker(card_rules, fast):
    """A batched group runs one batched launch of the fast kernel; under its
    failpoint the ladder steps to the other kernel's batched launch, one
    ``allow()`` and one verdict a group; an open breaker sends the next
    group straight to the other kernel. The plain batched replay never
    runs."""
    other = texec.OTHER_KERNEL[fast]
    a, b = _port_pair()
    a2, b2 = (tgen.random_csr(32, 24, 4.0, 1, device="cpu"),
              tgen.random_csr(24, 40, 4.0, 2, device="cpu"))
    a2.values.mul_(-2.0)
    svc = tserve.SparseService(backend=fast, max_batch=4, clock=FakeClock(),
                               breaker_threshold=1, sleep=lambda _: None)
    rs = [svc.submit(a, b), svc.submit(a2, b2), svc.submit(a, b)]
    svc.step()
    assert card_rules == [(fast, 3, 3)]
    assert all(r.ok and r.group_size == 3 and r.backend == fast and not r.degraded
               for r in rs)
    with tfaults.failpoint(f"kernel:{fast}"):
        rs2 = [svc.submit(a, b) for _ in range(2)]
        svc.step()
        assert all(r.ok and r.degraded and r.backend == fast for r in rs2)
        assert svc._breakers[fast].state == tbreaker.OPEN
        rs3 = [svc.submit(a2, b2) for _ in range(2)]
        svc.step()
        assert all(r.ok and r.backend == other and not r.degraded for r in rs3)
    assert [c[0] for c in card_rules] == [fast, other, other]
    assert ttelemetry.FALLBACK_COUNTS == {f"fault:{fast}->{other}": 1}
    assert dict(ttelemetry.BREAKER_COUNTS) == {f"{fast}:open": 1, f"{fast}:short_circuit": 1}
    assert ttelemetry.STAGE_COUNTS["executor_apply_batched"] == 0
    assert ttelemetry.STAGE_COUNTS["numeric_reuse"] == 0
    for r, (x, y) in zip(rs + rs2 + rs3, [(a, b), (a2, b2), (a, b), (a, b), (a, b),
                                          (a2, b2), (a2, b2)]):
        torch.testing.assert_close(r.value.values, _other_kernel_values(x, y, other),
                                   rtol=RTOL, atol=ATOL)


def test_card_span_fallback_names_the_real_step(card_rules):
    """Traced, a degraded dispatch's ``serve.dispatch`` span says
    ``fallback="pallas->pallas_lp"`` (the executor's step, singletons and
    batched groups alike); no span or attribute says "xla"."""
    a, b = _port_pair()
    tobs.set_tracing("on")
    svc = tserve.SparseService(backend="pallas", max_batch=2, breaker_threshold=5,
                               sleep=lambda _: None)
    with tfaults.failpoint("kernel:pallas"):
        svc.submit(a, b)
        svc.drain()
        svc.submit(a, b)
        svc.submit(a, b)
        svc.drain()
    events = tobs.trace.events()
    dispatch = [e for e in events if e["name"] == "serve.dispatch"]
    assert [(e["args"]["group"], e["args"]["kernel"], e["args"]["fallback"])
            for e in dispatch] == [(1, "pallas", "pallas->pallas_lp"),
                                   (2, "pallas", "pallas->pallas_lp")]
    assert "xla" not in json.dumps(events)
    numeric = [e["args"] for e in events if e["name"] == "numeric.dispatch"]
    assert [(x["kernel"], x.get("batch"), x["fallback"]) for x in numeric] == [
        ("pallas", None, "pallas->pallas_lp"), ("pallas", 2, "pallas->pallas_lp")]


def test_card_spgemm_grouped_batches_through_the_kernel(card_rules):
    """``spgemm_grouped`` passes the caller's backend to its batched groups:
    under the card's rules three multiplies of one structure are one batched
    K2 launch, values equal to the plain batched replay."""
    a, b = _port_pair()
    pairs = [(a, b), (a.__class__(a.indptr, a.indices, a.values * 2.0, a.shape), b),
             (a, b.__class__(b.indptr, b.indices, -b.values, b.shape))]
    got = texec.spgemm_grouped(pairs, backend="pallas_lp", plan_cache=False)
    assert card_rules == [("pallas_lp", 3, 3)]
    assert ttelemetry.STAGE_COUNTS["executor_apply_batched"] == 0
    for c, (x, y) in zip(got, pairs):
        want = tspgemm_mod.spgemm(x, y, method="sparse", plan_cache=False).c
        torch.testing.assert_close(c.values, want.values, rtol=RTOL, atol=ATOL)


def test_card_dtype_guard_sends_f64_groups_to_the_plain_path(card_rules):
    """f64 operands on the card: the batched group runs the plain batched
    replay and bumps ``dtype:executor->xla``, as ``apply`` does."""
    a, b = _port_pair()
    a = a.__class__(a.indptr, a.indices, a.values.double(), a.shape)
    b = b.__class__(b.indptr, b.indices, b.values.double(), b.shape)
    svc = tserve.SparseService(backend="pallas", max_batch=2, sleep=lambda _: None)
    rs = [svc.submit(a, b) for _ in range(2)]
    svc.step()
    assert all(r.ok and r.value.values.dtype == torch.float64 for r in rs)
    assert card_rules == []
    assert ttelemetry.FALLBACK_COUNTS == {"dtype:executor->xla": 1}
    assert ttelemetry.STAGE_COUNTS["executor_apply_batched"] == 1


@pytest.mark.parametrize("name", ["segsum_reuse", "lp_reuse"])
@pytest.mark.parametrize("stacked", ["both", "a", "b"])
def test_batched_entry_points_equal_stacked_single_replays(name, stacked):
    """On the CPU each batched entry point equals a stack of single replays
    row for row (shared operands included), and ``apply_batched`` under the
    card's rules returns the same."""
    mod = k1 if name == "segsum_reuse" else k2
    single = getattr(mod, f"{name}_arrays")
    batched = getattr(mod, f"{name}_batched_arrays")
    a, b = _port_pair(3)
    plan = tspgemm_mod.spgemm(a, b, method="sparse", plan_cache=False).plan
    g = torch.Generator().manual_seed(5)
    a_rows = torch.randn(4, a.nnz_cap, generator=g)
    b_rows = torch.randn(4, b.nnz_cap, generator=g)
    a_in = a_rows if stacked in ("both", "a") else a_rows[0]
    b_in = b_rows if stacked in ("both", "b") else b_rows[0]
    args = (plan.a_slot_s, plan.b_slot_s, plan.seg_ids)
    nnz_cap = plan.indices.shape[0]
    got = batched(*args, a_in, b_in, nnz_cap=nnz_cap)
    rows = [single(*args, a_in[i] if a_in.ndim == 2 else a_in,
                   b_in[i] if b_in.ndim == 2 else b_in, nnz_cap=nnz_cap) for i in range(4)]
    assert got.shape == (4, nnz_cap) and got.dtype == torch.float32
    torch.testing.assert_close(got, torch.stack(rows), rtol=1e-6, atol=1e-6)
    backend = "pallas" if name == "segsum_reuse" else "pallas_lp"
    ex = texec.ReuseExecutor(plan, backend=backend)
    torch.testing.assert_close(texec._replay_batched(plan, a_in, b_in), got,
                               rtol=1e-6, atol=1e-6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tladder, "kernels_only", lambda device: True)
        torch.testing.assert_close(ex.apply_batched(a_in, b_in), got, rtol=0, atol=0)
    assert ttelemetry.STAGE_COUNTS["executor_apply_batched"] == 1  # the line above it


def test_batched_entry_points_refuse_what_the_card_refuses():
    a, b = _port_pair(3)
    plan = tspgemm_mod.spgemm(a, b, method="sparse", plan_cache=False).plan
    args = (plan.a_slot_s, plan.b_slot_s, plan.seg_ids)
    nnz_cap = plan.indices.shape[0]
    av, bv = a.values, b.values
    for bad_a, bad_b, match in (
            (av, bv, "stacked"),
            (av.expand(2, -1), bv.expand(3, -1), "differ in batch"),
            (torch.zeros(2, 2 * a.nnz_cap)[:, ::2], bv, "unit stride"),
            (av.double().expand(2, -1), bv, "float32"),
            (av.expand(k1.MAX_BATCH + 1, -1), bv, "batch above")):
        with pytest.raises(tvalidate.SpgemmInputError, match=match):
            k1.segsum_reuse_batched_arrays(*args, bad_a, bad_b, nnz_cap=nnz_cap)


def test_build_failure_fails_the_group_without_a_retry(card_rules, monkeypatch):
    """A kernel library that cannot be built is deterministic: the group
    fails with ``KernelBuildError`` on its first attempt, never retried and
    never a rung."""
    a, b = _port_pair()

    def unbuildable(*args, **kwargs):
        raise _build.KernelBuildError("nvcc failed for segsum_reuse.cu")

    monkeypatch.setattr(texec, "_replay", unbuildable)
    svc = tserve.SparseService(backend="pallas", max_batch=1, retries=3,
                               sleep=lambda _: None)
    r = svc.submit(a, b)
    svc.step()
    assert isinstance(r.error, _build.KernelBuildError)
    assert isinstance(r.error, tvalidate.KernelFallbackError)
    assert dict(ttelemetry.RETRY_COUNTS) == {"serve.dispatch:attempt": 1}
    assert not ttelemetry.FALLBACK_COUNTS
    assert svc.counters["failed"] == 1


def test_group_of_mismatched_values_fails_typed(monkeypatch):
    """Stacking values of different lengths cannot happen inside a group
    (its key holds the structure key); forced, it is a typed
    ``PlanMismatchError`` on every response, not a shape crash."""
    a, b = _port_pair()
    svc = tserve.SparseService(max_batch=2, sleep=lambda _: None)
    rs = [svc.submit(a, b), svc.submit(a, b)]
    short = svc._queue[1].a
    svc._queue[1].a = short.__class__(short.indptr, short.indices, short.values[:-1],
                                      short.shape)
    svc.step()
    assert [type(r.error).__name__ for r in rs] == ["PlanMismatchError"] * 2
    assert dict(ttelemetry.RETRY_COUNTS) == {"serve.dispatch:attempt": 1}


def test_port_serve_imports_neither_jax_nor_repro():
    """The port's serving tier reads only torch and the port."""
    for path in SERVE_DIR.glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", text, re.M), path.name
    names = set(tserve.__all__)
    assert names == set(jserve.__all__) - {"ServeEngine", "prefill_to_cache"}
    for name in names:
        assert hasattr(tserve, name)
    assert tservice.RETRY_LABEL == importlib.import_module(
        "repro.serve.spgemm_service").RETRY_LABEL

"""repro_torch.runtime (validation, faults, the degradation ladder, retry,
watchdog) against the JAX package's.

Tolerances: bitwise for error classes, counter keys and counts, corrupted
arrays, retry schedules and plan digests; values of a ladder step against
the reference's plain ("xla") output at rtol/atol 1e-5, the tolerance of
the reference's own tests.

The two packages are compared only through armed failpoints or the "xla"
backend: on this jax the reference's Pallas replay kernels do not run
interpreted, so its "pallas" backend fails and falls back on the CPU even
with no failpoint armed.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jtune
from repro.core import executor as jexec
from repro.core import telemetry as jtelemetry
from repro.core.compression import flops_stats as jflops
from repro.core.spgemm import spgemm as jspgemm
from repro.kernels import ops as jops
from repro.runtime import faults as jfaults
from repro.runtime import retry as jretry
from repro.runtime import validate as jvalidate
from repro.sparse import generators as jgen
from repro_torch import obs as tobs
from repro_torch.core import autotune as ttune
from repro_torch.core import executor as texec
from repro_torch.core import telemetry as ttelemetry
from repro_torch.core.spgemm import numeric_reuse, spgemm
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.obs import recorder as trecorder
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import ladder as tladder
from repro_torch.runtime import retry as tretry
from repro_torch.runtime import validate as tvalidate
from repro_torch.runtime.watchdog import Heartbeat, StepWatchdog, StragglerDetected
from repro_torch.sparse import generators as tgen
from repro_torch.sparse.oracle import gustavson_ell_structure

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_port_state():
    ttelemetry.reset_all()
    ttune.reset_tuner()
    tfaults.reset_failpoints()
    tobs.reset_obs()
    yield
    ttune.reset_tuner()
    tfaults.reset_failpoints()
    tobs.reset_obs()


def _pair(seed=1, m=32, k=24, n=40):
    ja = jgen.random_csr(m, k, 4.0, seed)
    jb = jgen.random_csr(k, n, 4.0, seed + 1)
    ta = tgen.random_csr(m, k, 4.0, seed, device="cpu")
    tb = tgen.random_csr(k, n, 4.0, seed + 1, device="cpu")
    return ja, jb, ta, tb


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------- validation


DATA_FAULTS = [s.name for s in jfaults.data_faults()]


def test_registries_match_the_reference():
    assert sorted(tfaults.FAULTS) == sorted(jfaults.FAULTS)
    for name, spec in tfaults.FAULTS.items():
        ref = jfaults.FAULTS[name]
        assert (spec.kind, spec.site, spec.description) == (ref.kind, ref.site, ref.description)
        assert (spec.expects is None) == (ref.expects is None)
        if spec.expects is not None:
            assert spec.expects.__name__ == ref.expects.__name__
    assert [s.name for s in tfaults.data_faults()] == DATA_FAULTS
    assert [s.site for s in tfaults.kernel_faults()] == [
        "kernel:pallas", "kernel:pallas_lp", "kernel:flat_lp", "kernel:dense_acc"]
    with pytest.raises(tvalidate.SpgemmConfigError):
        tfaults.inject_csr("kernel_pallas", _pair()[2])


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("name", DATA_FAULTS)
def test_check_csr_raises_the_references_class_on_every_data_fault(name, mode, seed):
    """The same corruption (bitwise: the same slot for the same seed) raises
    the same typed class in both packages, in both modes, through
    ``check_csr`` and through ``spgemm(validate=...)`` before any stage."""
    ja, jb, ta, tb = _pair()
    jbad = jfaults.inject_csr(name, ja, seed=seed)
    tbad = tfaults.inject_csr(name, ta, seed=seed)
    for field in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(_np(getattr(tbad, field)), _np(getattr(jbad, field)))
    with pytest.raises(jvalidate.SpgemmError) as want:
        jvalidate.check_csr(jbad, mode, name="A")
    with pytest.raises(tvalidate.SpgemmError) as got:
        tvalidate.check_csr(tbad, mode, name="A")
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(got.value, tfaults.FAULTS[name].expects)
    with pytest.raises(tfaults.FAULTS[name].expects):
        spgemm(tbad, tb, method="sparse", plan_cache=False, validate=mode)
    assert not ttelemetry.STAGE_COUNTS


def test_validate_modes_and_env(monkeypatch):
    _, _, ta, tb = _pair()
    monkeypatch.delenv("REPRO_VALIDATE", raising=False)
    assert tvalidate.resolve_mode(None) == "off"
    monkeypatch.setenv("REPRO_VALIDATE", "device")
    assert tvalidate.resolve_mode(None) == jvalidate.resolve_mode(None) == "device"
    assert spgemm(ta, tb, method="sparse", plan_cache=False).stats["validate"] == "device"
    with pytest.raises(tvalidate.SpgemmConfigError):
        tvalidate.resolve_mode("hots")
    bad = tfaults.inject_csr("nan_values", ta)
    assert tvalidate.check_csr(bad, "off") is bad  # off: no work, no error


def test_validate_off_adds_no_work():
    _, _, ta, tb = _pair()
    spgemm(ta, tb, method="sparse", plan_cache=False)
    plain = ttelemetry.snapshot()
    ttelemetry.reset_all()
    spgemm(ta, tb, method="sparse", plan_cache=False, validate="off")
    assert ttelemetry.snapshot() == plain


def test_plan_guard_and_plan_compat_match_the_reference():
    ja, jb, ta, tb = _pair(3)
    jres = jspgemm(ja, jb, method="sparse", plan_cache=False)
    tres = spgemm(ta, tb, method="sparse", plan_cache=False)
    jg, tg = jvalidate.PlanGuard(jres.plan), tvalidate.PlanGuard(tres.plan)
    assert (tg.nnz_cap, tg.a_req, tg.b_req) == (jg.nnz_cap, jg.a_req, jg.b_req)
    with pytest.raises(tvalidate.PlanMismatchError):
        tg.check_values(ta.values[: tg.a_req - 1], tb.values, "host")
    with pytest.raises(tvalidate.PlanMismatchError):
        tg.check_values(ta.values[None], tb.values, "host")
    tg.check_values(ta.values[None], tb.values, "host", batched=True)
    nan_b = tb.values.clone()
    nan_b[0] = float("nan")
    tg.check_values(ta.values, nan_b, "host")  # host mode checks shapes only
    with pytest.raises(tvalidate.SpgemmInputError):
        tg.check_values(ta.values, nan_b, "device")
    ex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False, validate="host")
    ex.check_compat(ta, tb)
    _, _, other, _ = _pair(4)
    with pytest.raises(tvalidate.PlanMismatchError):
        ex.check_compat(other, tb)
    with pytest.raises(tvalidate.PlanMismatchError):
        texec.ReuseExecutor(tres.plan).check_compat(ta, tb)
    with pytest.raises(tvalidate.PlanMismatchError):
        ex.apply(ta.values[:1], tb.values)


# ------------------------------------------------------------------- ladder


def _ell(ta, tb):
    return tuple(torch.from_numpy(x) for x in gustavson_ell_structure(ta, tb))


@pytest.mark.parametrize("backend", ["pallas", "pallas_lp"])
def test_executor_ladder_matches_the_reference(backend):
    """An armed kernel failpoint steps the replay to the plain path: the
    same FALLBACK_COUNTS in both packages, the reference's xla values, one
    recorder "fallback" event; "raise" gives KernelFallbackError."""
    ja, jb, ta, tb = _pair()
    jex = jexec.ReuseExecutor.from_matrices(ja, jb, backend=backend, plan_cache=False)
    tex = texec.ReuseExecutor.from_matrices(ta, tb, backend=backend, plan_cache=False)
    with jfaults.failpoint(f"kernel:{backend}"):
        want_vals = jex.apply(ja.values, jb.values)
    with tfaults.failpoint(f"kernel:{backend}"):
        got = tex.apply(ta.values, tb.values)
    assert dict(ttelemetry.FALLBACK_COUNTS) == dict(jtelemetry.FALLBACK_COUNTS) == {
        f"fault:{backend}->xla": 1}
    assert tex.kernel_source == jex.kernel_source == "fallback"
    np.testing.assert_allclose(got.numpy(), np.asarray(want_vals), rtol=RTOL, atol=ATOL)
    events = [e for e in trecorder.default_recorder().events() if e["event"] == "fallback"]
    assert len(events) == 1 and events[0]["fallback"] == f"{backend}->xla"
    strict = texec.ReuseExecutor(tex.plan, backend=backend, on_kernel_failure="raise")
    jstrict = jexec.ReuseExecutor(jex.plan, backend=backend, on_kernel_failure="raise")
    for pkg_faults, ex, vals, err in (
            (jfaults, jstrict, (ja.values, jb.values), jvalidate.KernelFallbackError),
            (tfaults, strict, (ta.values, tb.values), tvalidate.KernelFallbackError)):
        with pkg_faults.failpoint(f"kernel:{backend}"):
            with pytest.raises(err):
                ex.apply(*vals)
    assert trecorder.default_recorder().last_dump is not None


LADDER_CASES = {
    # (kernel=, measured winner or None, armed sites)
    "flat_lp_explicit": ("flat_lp", None, ("kernel:flat_lp",)),
    "dense_acc_explicit": ("dense_acc", None, ("kernel:dense_acc",)),
    "auto_static": ("auto", None, ("kernel:dense_acc",)),
    "auto_measured_two_steps": ("auto", "flat_lp", ("kernel:flat_lp", "kernel:dense_acc")),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_numeric_values_ladder_matches_the_reference(case):
    kernel, winner, sites = LADDER_CASES[case]
    ja, jb, ta, tb = _pair(2)
    c_idx, c_nnz = _ell(ta, tb)
    jc_idx, jc_nnz = jnp.asarray(c_idx.numpy()), jnp.asarray(c_nnz.numpy())
    if winner is not None:
        fm = int(jflops(ja, jb.row_nnz())[0])
        jtune.record_measured(jtune.bucket_key(ja.m, jb.k, fm, ja.values.dtype,
                                               jb.values.dtype, table="numeric"), winner)
        ttune.record_measured(ttune.bucket_key(ta.m, tb.k, fm, ta.values.dtype,
                                               tb.values.dtype, table="numeric",
                                               device="cpu"), winner)
    for site in sites:
        jfaults.arm(site)
        tfaults.arm(site)
    want = jops.numeric_values(ja, jb, jc_idx, jc_nnz, kernel=kernel)
    got = tops.numeric_values(ta, tb, c_idx, c_nnz, kernel=kernel)
    jfaults.reset_failpoints()
    assert dict(ttelemetry.FALLBACK_COUNTS) == dict(jtelemetry.FALLBACK_COUNTS)
    assert dict(tops.KERNEL_COUNTS) == {"xla": 1}
    xla = jops.numeric_values(ja, jb, jc_idx, jc_nnz, kernel="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(want), np.asarray(xla), rtol=RTOL, atol=ATOL)
    steps = [e for e in trecorder.default_recorder().events() if e["event"] == "fallback"]
    assert len(steps) == sum(ttelemetry.FALLBACK_COUNTS.values())
    with tfaults.failpoint(sites[0]):
        with pytest.raises(tvalidate.KernelFallbackError):
            tops.numeric_values(ta, tb, c_idx, c_nnz, kernel=kernel, on_kernel_failure="raise")
    with tfaults.failpoint("kernel:xla"):
        with pytest.raises(tvalidate.KernelFallbackError, match="exhausted"):
            tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="xla")


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_numeric_values_build_failure_raises_and_launch_failure_steps(failure, monkeypatch):
    """A library that cannot be built (typed KernelFallbackError) is never a
    rung: it raises with FALLBACK_COUNTS empty. A launch's CUDA error
    (KernelLaunchError) steps one rung, on the same device."""
    _, _, ta, tb = _pair(6)
    c_idx, c_nnz = _ell(ta, tb)
    exc = (tvalidate.KernelFallbackError("nvcc failed for spgemm_numeric.cu")
           if failure == "build" else _build.KernelLaunchError("CUDA error 700"))

    def broken(*args, **kwargs):
        raise exc

    monkeypatch.setattr(tops, "spgemm_numeric_bucketed", broken)
    if failure == "build":
        with pytest.raises(tvalidate.KernelFallbackError, match="nvcc"):
            tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="dense_acc")
        assert not ttelemetry.FALLBACK_COUNTS and not tops.KERNEL_COUNTS
        return
    got = tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="dense_acc")
    assert dict(ttelemetry.FALLBACK_COUNTS) == {"fault:dense_acc->xla": 1}
    assert got.device == ta.values.device
    want = tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="xla")
    assert torch.equal(got, want)
    with pytest.raises(tvalidate.KernelFallbackError) as info:
        tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="dense_acc", on_kernel_failure="raise")
    assert isinstance(info.value.__cause__, _build.KernelLaunchError)


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_executor_build_failure_raises_and_launch_failure_steps(failure, monkeypatch):
    _, _, ta, tb = _pair(7)
    exc = (tvalidate.KernelFallbackError("nvcc failed for segsum_reuse.cu")
           if failure == "build" else _build.KernelLaunchError("CUDA error 700"))

    def broken(*args, **kwargs):
        raise exc

    monkeypatch.setattr(texec, "segsum_reuse", broken)
    ex = texec.ReuseExecutor.from_matrices(ta, tb, backend="pallas", plan_cache=False)
    if failure == "build":
        with pytest.raises(tvalidate.KernelFallbackError, match="nvcc"):
            ex.apply(ta.values, tb.values)
        assert not ttelemetry.FALLBACK_COUNTS and ex.kernel_source == "static"
        return
    got = ex.apply(ta.values, tb.values)
    assert dict(ttelemetry.FALLBACK_COUNTS) == {"fault:pallas->xla": 1}
    assert torch.equal(got, numeric_reuse(ex.plan, ta.values, tb.values))
    strict = texec.ReuseExecutor(ex.plan, backend="pallas", on_kernel_failure="raise")
    with pytest.raises(tvalidate.KernelFallbackError) as info:
        strict.apply(ta.values, tb.values)
    assert isinstance(info.value.__cause__, _build.KernelLaunchError)


def _poison_replays(monkeypatch):
    """A replay kernel writing garbage: every port replay's first value
    becomes NaN (the reference's ``executor:poison_output`` failpoint)."""
    real = texec._replay

    def poisoned(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[:1] = float("nan")
        return out

    monkeypatch.setattr(texec, "_replay", poisoned)


def test_ladder_rungs_on_the_card_are_kernels_only():
    """On the card no rung, measured candidate or nan-guard rerun hands a
    kernel's work to the plain version; on the CPU the rungs are the
    reference's."""
    assert tops.numeric_ladder("dense_acc", "flat_lp", on_card=False) == [
        "dense_acc", "flat_lp", "xla"]
    assert tops.numeric_ladder("flat_lp", "flat_lp", on_card=False) == ["flat_lp", "xla"]
    assert tops.numeric_ladder("dense_acc", None, on_card=False) == ["dense_acc", "xla"]
    for pick, other in (("dense_acc", "flat_lp"), ("flat_lp", "dense_acc")):
        for static in (None, "dense_acc", "flat_lp"):
            assert tops.numeric_ladder(pick, static, on_card=True) == [pick, other]
    assert tops.numeric_ladder("xla", "dense_acc", on_card=True) == ["xla"]
    assert texec.replay_rungs("pallas", on_card=False) == ["pallas", "xla"]
    assert texec.replay_rungs("pallas", on_card=True) == ["pallas", "pallas_lp"]
    assert texec.replay_rungs("pallas_lp", on_card=True) == ["pallas_lp", "pallas"]
    assert texec.replay_rungs("xla", on_card=True) == ["xla"]


@pytest.mark.parametrize("entry", ["numeric_values", "executor"])
def test_card_ladder_steps_between_kernels(entry, monkeypatch):
    """The card's ladder, driven on the CPU with ``kernels_only`` forced:
    a failed kernel steps to the other kernel, both failed raise
    ``KernelFallbackError``, measure mode times the kernels only, and the
    nan guard reruns through the other kernel."""
    monkeypatch.setattr(tladder, "kernels_only", lambda device: True)
    _, _, ta, tb = _pair(11)
    if entry == "numeric_values":
        c_idx, c_nnz = _ell(ta, tb)
        first, other = "flat_lp", "dense_acc"

        def call(pick="auto", **kw):
            return tops.numeric_values(ta, tb, c_idx, c_nnz, kernel=pick, **kw)
    else:
        plan = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False).plan
        first, other = "pallas", "pallas_lp"

        def call(pick="auto", **kw):
            return texec.ReuseExecutor(plan, backend=pick, **kw).apply(ta.values, tb.values)

    want = call(other)
    ttelemetry.reset_all()
    tops.reset_kernel_counts()
    with tfaults.failpoint(f"kernel:{first}"):
        got = call(first)
    assert dict(ttelemetry.FALLBACK_COUNTS) == {f"fault:{first}->{other}": 1}
    assert torch.equal(got, want)
    if entry == "numeric_values":
        assert dict(tops.KERNEL_COUNTS) == {other: 1}
    with tfaults.failpoint(f"kernel:{first}"), tfaults.failpoint(f"kernel:{other}"):
        with pytest.raises(tvalidate.KernelFallbackError, match="exhausted"):
            call(first)
    timed = []
    monkeypatch.setattr(ttune, "measure_candidates",
                        lambda cands, reps=3: (timed.extend(cands) or first, {}))
    call(tune="measure")
    assert sorted(timed) == sorted([first, other])
    if entry == "executor":
        ttelemetry.reset_all()
        _poison_replays(monkeypatch)
        guard = texec.ReuseExecutor(plan, backend="pallas", nan_guard=True)
        guard.apply(ta.values, tb.values)
        # the poisoned rerun through pallas_lp is not finite either
        assert dict(ttelemetry.FALLBACK_COUNTS) == {"nan_guard:rerun": 1, "nan_guard:data": 1}


@pytest.mark.parametrize("entry", ["numeric_values", "executor"])
@pytest.mark.parametrize("exc", [torch.cuda.OutOfMemoryError, ValueError])
def test_ladder_lets_other_errors_through(entry, exc, monkeypatch):
    """Only a launch's CUDA error or an armed failpoint is a kernel failure:
    out-of-memory and plain bugs pass through untouched, no step taken."""
    _, _, ta, tb = _pair(12)

    def broken(*args, **kwargs):
        raise exc("not a kernel failure")

    if entry == "numeric_values":
        c_idx, c_nnz = _ell(ta, tb)
        monkeypatch.setattr(tops, "spgemm_lp_bucketed", broken)
        call = lambda: tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="flat_lp")  # noqa: E731
    else:
        ex = texec.ReuseExecutor.from_matrices(ta, tb, backend="pallas", plan_cache=False)
        monkeypatch.setattr(texec, "segsum_reuse", broken)
        call = lambda: ex.apply(ta.values, tb.values)  # noqa: E731
    with pytest.raises(exc, match="not a kernel failure"):
        call()
    assert not ttelemetry.FALLBACK_COUNTS


@pytest.mark.parametrize("fault", ["poison_output", "nan_in_b"])
def test_nan_guard_keys_match_the_reference(fault, monkeypatch):
    ja, jb, ta, tb = _pair(8)
    jex = jexec.ReuseExecutor.from_matrices(ja, jb, plan_cache=False, nan_guard=True)
    tex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False, nan_guard=True)
    jbv, tbv = jb.values, tb.values
    if fault == "nan_in_b":
        jbv = jbv.at[0].set(jnp.nan)
        tbv = tbv.clone()
        tbv[0] = float("nan")
        want = jex.apply(ja.values, jbv)
        got = tex.apply(ta.values, tbv)
        verdict = "data"
    else:
        with jfaults.failpoint("executor:poison_output"):
            want = jex.apply(ja.values, jbv)
        _poison_replays(monkeypatch)
        got = tex.apply(ta.values, tbv)
        verdict = "recovered"
    assert dict(ttelemetry.FALLBACK_COUNTS) == dict(jtelemetry.FALLBACK_COUNTS) == {
        "nan_guard:rerun": 1, f"nan_guard:{verdict}": 1}
    assert tex.nan_events == jex.nan_events == [(verdict, "xla")]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               equal_nan=True)
    with pytest.raises(tvalidate.SpgemmConfigError):
        tex.apply(ta.values, tb.values, donate=True)


# ------------------------------------------------------------ retry, watchdog


def test_retry_schedule_and_counters_match_the_reference():
    for kw in ({}, {"base_delay_s": 0.01, "max_delay_s": 0.05, "jitter": 0.0, "seed": 3},
               {"jitter": 0.9, "seed": 11}):
        assert tretry.backoff_schedule(6, **kw) == jretry.backoff_schedule(6, **kw)

    def run(pkg_retry, err):
        attempts = []

        def flaky():
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("transient")
            return "ok"

        slept = []
        assert pkg_retry.retry_call(flaky, retries=4, sleep=slept.append, label="flaky") == "ok"

        def always():
            raise RuntimeError("down")

        with pytest.raises(pkg_retry.RetryExhaustedError) as info:
            pkg_retry.retry_call(always, retries=2, sleep=slept.append, label="down")
        assert info.value.attempts == 3

        def bad_input():
            raise err("corrupt")

        with pytest.raises(err):
            pkg_retry.retry_call(bad_input, retries=5, sleep=slept.append, label="input")
        return slept

    assert run(tretry, tvalidate.SpgemmInputError) == run(jretry, jvalidate.SpgemmInputError)
    assert dict(ttelemetry.RETRY_COUNTS) == dict(jtelemetry.RETRY_COUNTS) == {
        "flaky:attempt": 3, "flaky:retry": 2, "down:attempt": 3, "down:retry": 2,
        "down:giveup": 1, "input:attempt": 1}
    assert trecorder.default_recorder().last_dump is not None
    with pytest.raises(tvalidate.SpgemmConfigError):
        tretry.retry_call(lambda: None, retries=-1)


def test_step_watchdog_verdicts(capsys):
    wd = StepWatchdog(deadline_s=0.0, policy="warn")
    with wd.step(3):
        time.sleep(0.001)
    assert [s for s, _ in wd.slow_steps] == [3]
    assert "WATCHDOG" in capsys.readouterr().out
    strict = StepWatchdog(deadline_s=0.0, policy="raise")
    with pytest.raises(StragglerDetected):
        with strict.step(1):
            time.sleep(0.001)
    with pytest.raises(KeyError):  # a failing body is not masked by the verdict
        with strict.step(2):
            raise KeyError("body")
    assert [s for s, _ in strict.slow_steps] == [1, 2]
    relaxed = StepWatchdog(deadline_s=60.0, policy="raise")
    with relaxed.step(0):
        pass
    assert not relaxed.slow_steps


def test_executor_watchdog_verdicts_pass_through_the_ladder():
    _, _, ta, tb = _pair(9)
    ex = texec.ReuseExecutor.from_matrices(ta, tb, plan_cache=False, backend="pallas",
                                           watchdog=StepWatchdog(0.0, policy="raise"))
    with pytest.raises(StragglerDetected):
        ex.apply(ta.values, tb.values)
    assert not ttelemetry.FALLBACK_COUNTS  # a deadline verdict is not a kernel failure
    warn = texec.ReuseExecutor(ex.plan, watchdog=StepWatchdog(0.0, policy="warn"))
    warn.apply(ta.values, tb.values)
    warn.apply_batched(ta.values[None], tb.values)
    assert len(warn.watchdog.slow_steps) == 2


def test_heartbeat_writes_its_liveness_file(tmp_path):
    path = tmp_path / "beat.json"
    hb = Heartbeat(str(path), interval_s=0.01).start()
    hb.step = 4
    deadline = time.monotonic() + 5
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert hb.stop() == 0
    assert path.exists()


def test_every_counter_key_fits_its_family(monkeypatch):
    """Drive every counter family through the port, then hold each key to
    the reference's grammar (which the port's KEY_FAMILIES equals)."""
    assert ttelemetry.KEY_FAMILIES == jtelemetry.KEY_FAMILIES
    assert set(ttelemetry.ALL_COUNTERS) == set(jtelemetry.ALL_COUNTERS)
    _, _, ta, tb = _pair(10)
    spgemm(ta, tb, method="sparse", tune="measure")
    ex = texec.ReuseExecutor.from_matrices(ta, tb, backend="pallas_lp", nan_guard=True)
    with monkeypatch.context() as mp, tfaults.failpoint("kernel:pallas_lp"):
        _poison_replays(mp)
        ex.apply(ta.values, tb.values)
    ex.apply_batched(ta.values[None], tb.values)
    c_idx, c_nnz = _ell(ta, tb)
    tops.numeric_values(ta, tb, c_idx, c_nnz, kernel="flat_lp")
    ti = type(ta)(ta.indptr, ta.indices, ta.values.double(), ta.shape)
    spgemm(ti, tb, method="lp", plan_cache=False)
    tretry.retry_call(lambda: 1, label="probe")
    ttelemetry.BREAKER_COUNTS["svc:open"] += 1
    snap = ttelemetry.snapshot()
    assert all(snap[f] for f in ("trace", "hash", "dispatch", "kernel", "tune", "fallback",
                                 "retry", "breaker"))
    for family, keys in snap.items():
        for key in keys:
            assert ttelemetry.key_matches_family(family, key), (family, key)
    assert not ttelemetry.key_matches_family("fallback", "fault:x")
    before = ttelemetry.snapshot()
    tretry.retry_call(lambda: 1, label="probe")
    assert ttelemetry.diff(before, ttelemetry.snapshot()) == {"retry": {"probe:attempt": 1}}
    ttelemetry.reset_all()
    assert not any(ttelemetry.snapshot().values())

"""repro_torch.obs (spans, Chrome export, histograms, recorder) against the
JAX package's ``repro.obs``.

Tolerances: bitwise throughout — span names, nesting depths and attributes,
histogram quantiles and summaries on the same samples, Prometheus and JSONL
text, recorder rings. Durations are host clock readings and are compared
only for their sign.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import recorder as jrecorder
from repro.obs import trace as jtrace
from repro_torch import obs as tobs
from repro_torch.core import autotune as ttune
from repro_torch.core import executor as texec
from repro_torch.core import telemetry as ttelemetry
from repro_torch.core.spgemm import spgemm
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import recorder as trecorder
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.sparse import generators as tgen


@pytest.fixture(autouse=True)
def _reset_port_state():
    ttelemetry.reset_all()
    ttune.reset_tuner()
    tfaults.reset_failpoints()
    tobs.reset_obs()
    yield
    tfaults.reset_failpoints()
    tobs.reset_obs()


def _shape_of(events):
    return [(e["name"], e["depth"], {k: v for k, v in e["args"].items()}) for e in events]


def _drive(tr):
    """The same span program in either package."""
    with tr.span("spgemm.prepare", pad_policy="pow2"):
        with tr.span("plan.build", fm_cap=64) as sp:
            sp.set("nnz_cap", 32)
        with tr.trace_context("req-7"):
            with tr.span("numeric.dispatch", kernel="pallas"):
                pass
    try:
        with tr.span("numeric.kernel", kernel="xla", rung=1):
            raise KeyError("boom")
    except KeyError:
        pass


def test_span_nesting_attributes_and_chrome_export_match_the_reference(tmp_path):
    for tr in (ttrace, jtrace):
        tr.set_tracing("on")
        _drive(tr)
    got, want = ttrace.events(), jtrace.events()
    assert _shape_of(got) == _shape_of(want)
    assert [e["name"] for e in got] == ["plan.build", "numeric.dispatch", "spgemm.prepare",
                                        "numeric.kernel"]
    assert got[1]["args"]["trace_id"] == "req-7" and got[3]["args"]["error"] == "KeyError"
    assert all(e["dur"] >= 0 for e in got)
    path = tmp_path / "trace.json"
    payload = ttrace.export_chrome_trace(str(path))
    loaded = json.loads(path.read_text())
    ref = jtrace.export_chrome_trace()
    strip = [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in loaded["traceEvents"]]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                     for e in ref["traceEvents"]]
    assert payload["otherData"] == ref["otherData"] == {"dropped_events": 0}
    assert {e["name"] for e in got} <= ttrace.SPAN_NAMES == jtrace.SPAN_NAMES
    # the spans fed the per-phase and per-kernel histograms
    hists = tmetrics.default_registry().snapshot()["histograms"]
    assert {"plan.build", "numeric.dispatch[pallas]", "numeric.kernel[xla]"} <= set(hists)


@pytest.mark.parametrize("raw", [None, "", "0", "1", "true", "off", "on", "xprof", "bogus"])
def test_trace_modes_and_env_match_the_reference(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("REPRO_TRACE", raising=False)
    else:
        monkeypatch.setenv("REPRO_TRACE", raw)
    if raw == "bogus":
        with pytest.raises(SpgemmConfigError):
            ttrace.resolve_trace_mode(None)
        return
    assert ttrace.resolve_trace_mode(None) == jtrace.resolve_trace_mode(None)
    for mode in (True, False, "on", "off", "xprof"):
        assert ttrace.resolve_trace_mode(mode) == jtrace.resolve_trace_mode(mode)
    with pytest.raises(SpgemmConfigError):
        ttrace.resolve_trace_mode("xprof2")


def test_tracing_off_is_a_shared_no_op():
    ttrace.set_tracing("off")
    assert ttrace.span("plan.build") is ttrace.span("numeric.kernel")
    with ttrace.span("plan.build") as sp:
        sp.set("x", 1)
    assert ttrace.trace_context("t") is ttrace.span("plan.build")
    assert ttrace.events() == [] and not tmetrics.default_registry().snapshot()["histograms"]
    with ttrace.trace_scope("on"):
        assert ttrace.enabled()
    assert not ttrace.enabled()
    assert ttrace.new_trace_id() == "trace-1" and ttrace.current_trace_id() is None


@pytest.mark.parametrize("samples", [
    [0.0], [3e-6], [1e-6, 2e-6, 4e-6, 8e-6], list(np.random.default_rng(0).lognormal(-7, 2, 997)),
    [0.5] * 10 + [100.0], list(np.linspace(0, 1e-3, 50)), [1e5, 2e5]])
def test_histogram_quantiles_equal_the_reference(samples):
    th, jh = tmetrics.Histogram("h"), jmetrics.Histogram("h")
    for v in samples:
        th.observe(v)
        jh.observe(v)
    for q in (0, 1, 10, 50, 90, 95, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q)
    ts, js = th.summary(), jh.summary()
    assert json.dumps(ts) == json.dumps(js)
    assert math.isnan(tmetrics.Histogram("e").percentile(50))


def test_registry_exports_equal_the_reference():
    regs = (tmetrics.MetricsRegistry("t"), jmetrics.MetricsRegistry("t"))
    for reg in regs:
        for v in (1e-4, 2e-4, 5e-3):
            reg.observe("numeric.dispatch", v)
        reg.observe("numeric.dispatch[pallas]", 7e-5)
        reg.set_gauge("queue.depth", 3)
        reg.gauge("heartbeat.write_errors", fn=lambda: 2)
    # both packages' counters are zero here (both fixtures reset them)
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert regs[0].to_jsonl() == regs[1].to_jsonl()
    assert set(regs[0].counters()) == set(ttelemetry.ALL_COUNTERS)


def test_recorder_ring_dump_and_capacity():
    for rec in (trecorder.FlightRecorder(3), jrecorder.FlightRecorder(3)):
        for i in range(5):
            rec.record("dispatch", kernel="xla", step=i)
        dump = rec.note_error(RuntimeError("x"), site="test")
        assert [e["seq"] for e in dump["events"]] == [4, 5, 6]
        assert [e.get("step") for e in dump["events"]] == [3, 4, None]
        assert dump["recorded"] == 6 and len(rec) == 3 and rec.last_dump is dump
    with pytest.raises(SpgemmConfigError):
        trecorder.FlightRecorder(0)
    trecorder.record("fallback", kernel="pallas")
    assert len(trecorder.default_recorder()) == 1
    tobs.reset_obs()
    assert len(trecorder.default_recorder()) == 0


def _operands():
    a = tgen.random_csr(40, 30, 3.0, 1, device="cpu")
    b = tgen.random_csr(30, 35, 3.0, 2, device="cpu")
    return a, b


def test_spgemm_trace_on_records_the_reference_spans_and_none_adds_none():
    a, b = _operands()
    spgemm(a, b, method="sparse", plan_cache=False, trace=None)
    assert ttrace.events() == []
    base = ttelemetry.snapshot()
    ttelemetry.reset_all()
    spgemm(a, b, method="sparse", plan_cache=False, trace="on")
    assert ttelemetry.snapshot() == base  # tracing adds no dispatch, hash or stage
    names = [e["name"] for e in ttrace.events()]
    assert names == ["spgemm.prepare", "plan.build", "numeric.dispatch"]
    assert not ttrace.enabled()  # the call's scope ended
    spgemm(a, b, method="dense", trace=True)
    assert [e["name"] for e in ttrace.events()][3:] == ["spgemm.symbolic", "numeric.dispatch"]
    ex = texec.ReuseExecutor.from_matrices(a, b, plan_cache=False, backend="pallas")
    with ttrace.trace_scope("on"):
        ex.apply(a.values, b.values)
    last = ttrace.events()[-1]
    assert last["name"] == "numeric.dispatch" and last["args"]["kernel"] == "pallas"
    assert trecorder.default_recorder().events()[-1]["verdict"] == "ok"
    assert {e["name"] for e in ttrace.events()} <= ttrace.SPAN_NAMES


def test_xprof_mode_annotates_the_torch_profiler():
    a, b = _operands()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spgemm(a, b, method="sparse", plan_cache=False, trace="xprof")
    seen = {e.key for e in prof.key_averages()}
    assert {"spgemm.prepare", "plan.build", "numeric.dispatch"} <= seen
    assert [e["name"] for e in ttrace.events()] == ["spgemm.prepare", "plan.build",
                                                    "numeric.dispatch"]
    assert torch.is_tensor(a.values)

"""repro_torch.obs (spans, Chrome export, histograms, recorder) against the
JAX package's ``repro.obs``.

Tolerances: bitwise throughout — span names, nesting depths and attributes,
histogram quantiles and summaries on the same samples, Prometheus and JSONL
text, recorder rings. Durations are host clock readings and are compared
only for their sign.
"""
import dataclasses
import gc
import json
import math
import time

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


# the spans the port adds to the reference's taxonomy
PORT_SPANS = {"plan.hash", "host.read"}
# a fresh sparse multiply of ``_operands`` (both repadded), in the order the
# spans close: six reads inside spgemm.prepare, the hash's four copies, the
# plan's size, then C's nnz for the stats
FRESH_SPANS = (["host.read"] * 6 + ["spgemm.prepare"] + ["host.read"] * 4
               + ["plan.hash", "host.read", "plan.build", "numeric.dispatch", "host.read"])


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
    # the port's names are the reference's plus its own two
    assert ttrace.SPAN_NAMES == jtrace.SPAN_NAMES | PORT_SPANS
    assert {e["name"] for e in got} <= ttrace.SPAN_NAMES
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
    assert names == FRESH_SPANS
    assert not ttrace.enabled()  # the call's scope ended
    spgemm(a, b, method="dense", trace=True)
    assert [e["name"] for e in ttrace.events()][len(FRESH_SPANS):] == (
        ["host.read"] * 7 + ["spgemm.symbolic", "host.read", "numeric.dispatch"])
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
    assert [e["name"] for e in ttrace.events()] == FRESH_SPANS
    assert torch.is_tensor(a.values)


# --------------------------------------------------------------------------
# The port's own spans: plan.hash, host.read
# --------------------------------------------------------------------------

HASH_ENTRIES = {
    "spgemm": lambda a, b: spgemm(a, b, method="sparse", plan_cache=False),
    "spgemm_grouped": lambda a, b: texec.spgemm_grouped(
        [(a, b), (dataclasses.replace(a, values=a.values * 2), b)], plan_cache=False),
    "from_matrices": lambda a, b: texec.ReuseExecutor.from_matrices(a, b, plan_cache=False),
}


@pytest.mark.parametrize("entry", sorted(HASH_ENTRIES))
def test_plan_hash_is_one_span_per_structure_key_call(entry):
    a, b = _operands()
    assert (a.shape, int(a.indptr[-1]), b.shape, int(b.indptr[-1])) == (
        (40, 30), 111, (30, 35), 87)  # repadded to 128 each; 333 products, fm_cap 512
    ttrace.set_tracing("on")
    HASH_ENTRIES[entry](a, b)
    hashes = [e for e in ttrace.events() if e["name"] == "plan.hash"]
    assert len(hashes) == ttelemetry.HASH_COUNTS["structure_key"] == (
        2 if entry == "spgemm_grouped" else 1)
    # the span holds the whole digest: its four host copies nest inside it
    reads = [e for e in ttrace.events()
             if e["name"] == "host.read" and e["args"]["site"].startswith("structure_key.")]
    assert len(reads) == 4 * len(hashes) and all(e["depth"] == 1 for e in reads)
    assert all(e["depth"] == 0 for e in hashes)  # inside no other span
    # the bytes hashed: each operand's indptr and live indices as int32, its
    # shape and capacity, then (fm_cap, pad policy)
    want = (4 * (41 + 111 + 31 + 87) + len(repr(((40, 30), 128))) + len(repr(((30, 35), 128)))
            + len(repr((512, "pow2"))))
    assert [e["args"]["bytes"] for e in hashes] == [want] * len(hashes)


# every way a tensor's value reaches the host
READS = ("item", "tolist", "cpu", "numpy", "__int__", "__float__", "__bool__", "__index__")


def _record_reads(monkeypatch) -> list:
    """Record each read of a tensor's values by the host: (method, time in
    us on the tracer's clock), whatever marks it. An empty tensor carries no
    value (``meta.f32_accumulation_ok`` reads a dtype off one)."""
    seen = []
    for name in READS:
        def read(self, *args, _name=name, _orig=getattr(torch.Tensor, name), **kwargs):
            if self.numel():
                seen.append((_name, (time.perf_counter() - ttrace._STATE.t0) * 1e6))
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, read)
    return seen


# a fresh sparse multiply of ``_operands`` without a plan cache: its reads by
# site (both operands are repadded, and the hash copies two arrays of each)
FRESH_READS = {
    "prepare_sparse_inputs.nnz_a": 1, "prepare_sparse_inputs.nnz_b": 1, "_repad_csr.nnz": 2,
    "_fm_scalars.fm": 1, "_fm_scalars.maxrf": 1, "structure_key.indptr": 2,
    "structure_key.indices": 2, "resolve_plan.nnz": 1, "spgemm.nnz_c": 1}


@pytest.mark.parametrize("mode", ["off", "on", "xprof"])
def test_fresh_multiply_spans_every_host_read(mode, monkeypatch):
    a, b = _operands()
    ttrace.clear()
    seen = _record_reads(monkeypatch)
    spgemm(a, b, method="sparse", plan_cache=False, trace=mode)
    monkeypatch.undo()
    assert len(seen) >= sum(FRESH_READS.values())
    spans = [e for e in ttrace.events() if e["name"] == "host.read"]
    if mode == "off":
        assert ttrace.events() == []
        return
    sites = [e["args"]["site"] for e in spans]
    assert {s: sites.count(s) for s in sites} == FRESH_READS
    # each read of a tensor by the host lies inside a host.read span
    for name, t in seen:
        assert any(e["ts"] <= t <= e["ts"] + e["dur"] for e in spans), name


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "pallas_lp"])
def test_replay_makes_no_host_read_and_no_event_with_tracing_off(backend, monkeypatch):
    a, b = _operands()
    ex = texec.ReuseExecutor.from_matrices(a, b, plan_cache=False, backend=backend)
    ttrace.set_tracing("off")
    ttrace.clear()
    seen = _record_reads(monkeypatch)
    ex.apply(a.values, b.values)
    ex.apply_batched(torch.stack([a.values, a.values * 2]), b.values)
    monkeypatch.undo()
    assert seen == []
    assert ttrace.events() == []


def test_chrome_export_lays_over_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    # a collection between two clock reads would shift one against the other
    gc.collect()
    gc.disable()
    try:
        ttrace.clear()
        ttrace.set_tracing("xprof")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ttrace.span("plan.hash"):
                time.sleep(0.01)
        ttrace.set_tracing("off")
    finally:
        gc.enable()
    ann = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "plan.hash" and e.is_user_annotation()]
    exported = ttrace.export_chrome_trace()["traceEvents"]
    assert len(ann) == 1 and [e["name"] for e in exported] == ["plan.hash"]
    ts_us, dur_us = ann[0].start_ns() / 1e3, (ann[0].end_ns() - ann[0].start_ns()) / 1e3
    assert dur_us >= 1e4
    assert abs(exported[0]["ts"] - ts_us) < 2e3
    assert abs(exported[0]["dur"] - dur_us) < 2e3

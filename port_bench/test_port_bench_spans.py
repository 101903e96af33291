"""The fresh path's readers on made-up traces: ``hash_ms.fresh`` (the
program's ``plan.hash`` spans) and ``host_reads.fresh`` (the device's
device->host copies); and a traced run of the fresh cell on the CPU at a
tiny size, where only the first finds something to read."""
from __future__ import annotations

import pytest

from pb_core import HERE, Run, load_module
from pb_system import PortSystem
from pb_trace import TraceData
from test_port_bench_harness import run


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"pb_metric_{name}")


def _ev(s, e, name, ann=True, corr=0):
    return (s, e, name, 1, corr, 0, ann)


def test_span_readers_on_a_made_up_trace():
    cpu = [_ev(0, 1000, "bench.window"),
           _ev(-50, 50, "plan.hash"),  # across the window's start: 50 ns inside
           _ev(100, 300, "plan.hash"),
           _ev(120, 130, "host.read"), _ev(200, 210, "host.read"),
           _ev(400, 600, "plan.build"), _ev(450, 460, "host.read"),
           _ev(500, 520, "plan.hash", ann=False),  # an operation of that name, no span
           _ev(950, 1100, "plan.hash"),  # across the window's end: 50 ns inside
           _ev(1200, 1300, "plan.hash"), _ev(1210, 1220, "host.read")]  # outside
    dtoh, htod = "Memcpy DtoH (Device -> Pageable)", "Memcpy HtoD (Pageable -> Device)"
    dev = [(125, 128, dtoh, 0), (205, 208, "Memcpy DtoH (Device -> Pinned)", 0),
           (300, 400, "expand_kernel", 0), (455, 458, dtoh, 0),
           (500, 510, htod, 0), (520, 530, "Memcpy DtoD (Device -> Device)", 0),
           (1215, 1218, dtoh, 0)]  # outside the window
    run = Run(entry="fresh", steps=2, trace=TraceData(cpu, dev))
    assert (run.trace.w0, run.trace.w1) == (0, 1000)
    assert reader("hash_ms.fresh").read(run) == pytest.approx((50 + 200 + 50) * 1e-6 / 2)
    # the device's copies to the host, whether the program marks them or not
    assert reader("host_reads.fresh").read(run) == 3 / 2
    unmarked = Run(entry="fresh", steps=2, trace=TraceData(cpu[:1] + cpu[5:6], dev))
    assert reader("host_reads.fresh").read(unmarked) == 3 / 2
    # host operations are recorded only for the readers of program spans
    assert reader("hash_ms.fresh").PROGRAM_SPANS
    assert not getattr(reader("host_reads.fresh"), "PROGRAM_SPANS", False)


def test_span_readers_read_nothing_without_the_spans():
    # the CUDA activity alone, as a reuse cell records it: no program span
    cpu = [_ev(100, 115, "cudaLaunchKernel", ann=False, corr=7),
           _ev(600, 900, "cudaDeviceSynchronize", ann=False, corr=8)]
    bare = TraceData(cpu, [(120, 450, "segsum_reuse_kernel", 7)])
    # program spans, but not plan.hash, as the parent program records; and
    # no device operation, as on the CPU
    older = TraceData([_ev(0, 1000, "bench.window"), _ev(100, 400, "plan.build")], [])
    for name in ("hash_ms.fresh", "host_reads.fresh"):
        for trace in (older, None):
            assert reader(name).read(Run(entry="fresh", steps=3, trace=trace)) is None
        assert reader(name).read(Run(entry="fresh", steps=0, trace=bare)) is None
    assert reader("hash_ms.fresh").read(Run(entry="fresh", steps=3, trace=bare)) is None
    # the device ran and copied nothing to the host
    assert reader("host_reads.fresh").read(Run(entry="fresh", steps=3, trace=bare)) == 0


def test_traced_fresh_run_reads_the_program_spans(monkeypatch):
    # at the tiny sizes a dense accumulator would fit, and "auto" would pick
    # the dense method; with no room for one it picks the sparse method, as
    # at the cells' sizes
    from repro_torch.core import meta

    monkeypatch.setattr(meta, "DENSE_BYTES_BUDGET", 0)
    res = run("rmat-s15-ef16.aa-fresh", PortSystem(), trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert 0 < m["hash_ms.fresh"]["value"] and m["hash_ms.fresh"]["unit"] == "ms"
    # no device ran an operation here: no idle share, no copy to the host, no
    # device time in plan.build
    assert "device_idle.fresh" not in m and "host_reads.fresh" not in m
    assert m["plan_build_ms.fresh"]["value"] == 0

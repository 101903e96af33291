"""SparseService quickstart on the PyTorch port: overload-safe SpGEMM serving
in six scenes.

The port of examples/serve_spgemm.py. The paper's Reuse case at serving
rates: many requests, few structures, every reply a pinned-plan replay.
This script walks the serving tier's whole contract:

  1. admission + grouped dispatch: mixed-structure traffic, one dispatch
     per structure group, every reply checked bitwise against the fresh
     spgemm() reference;
  2. backpressure: a burst past the queue bound sheds with typed
     ``AdmissionRejected``, never an unbounded queue, never a silent drop;
  3. deadlines: an infeasible deadline is refused at the door, an expired
     one is shed from the queue as ``DeadlineExceeded``; everything else
     completes;
  4. the breaker under kernel faults: the fast path starts failing
     (injected), the degradation ladder keeps every reply correct, the
     circuit breaker opens and routes traffic to the safe path, and a
     half-open probe re-admits the fast path once it heals;
  5. warming: the service's own traffic log prefetches the hot plans after
     an eviction, so the next burst never pays a plan build;
  6. observability: tracing on for a burst; request trace ids ride every
     span into a Chrome trace export, per-phase latency histograms land in
     the metrics registry, and ``stats(debug=True)`` returns the flight
     recorder's ring.

Where it runs decides what serves a request (``repro_torch.serve``). On the
CPU the reference's rules hold exactly: "pallas" is the plain replay there,
an open breaker routes to "xla", and every reply, the degraded ones too, is
bitwise the fresh multiply. On the card a fresh multiply and a reply both
come from the CUDA kernel K1 (a batched group is one batched K1 launch),
whose adds come in a fixed order: replies are bitwise the fresh multiply.
In scene 4's fault window the ladder steps to K2 and the open breaker
routes to the other kernel (K2), never to the plain version; K2 adds in
another order, so those replies are held to the port's f32 tolerance
(|reply - fresh| <= 1e-4 * S + 1e-6, S the product of absolute values).

Runs on the card by default; --device cpu runs it on the CPU:

    PYTHONPATH=src python examples/torch_serve_spgemm.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import obs
from repro_torch.core import spgemm, telemetry
from repro_torch.runtime import AdmissionRejected, DeadlineExceeded, faults
from repro_torch.serve import SparseService
from repro_torch.sparse import random_csr

F32_TOL = (1e-4, 1e-6)  # |reply - fresh| <= 1e-4 * S + 1e-6 where a reply came from K2
TRACE_PATH = "trace_serve_quickstart.json"


class Clock:
    """A hand-cranked clock so the deadline/breaker scenes are exact."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def pick_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The asked device; ``ap.error`` (exit 2) for a card that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return device


def make_structures(device):
    """The two (A, B) structures of the reference, and each one's fresh
    spgemm reference C and |A| |B| (the tolerance's scale), dense."""
    structures = [
        (random_csr(48, 32, 3.0, 1, device=device), random_csr(32, 40, 3.0, 2, device=device)),
        (random_csr(24, 32, 2.0, 3, device=device), random_csr(32, 16, 2.0, 4, device=device)),
    ]
    refs = [spgemm(a, b, method="sparse").c.to_dense() for a, b in structures]
    scales = [a.to_dense().abs() @ b.to_dense().abs() for a, b in structures]
    return structures, refs, scales


def make_service(clock: Clock) -> SparseService:
    return SparseService(backend="pallas", max_queue=8, max_batch=4,
                         breaker_threshold=2, breaker_cooldown_s=5.0,
                         clock=clock, sleep=lambda _: None)


def reply_ok(resp, ref: torch.Tensor, scale: torch.Tensor) -> bool:
    """A reply against its fresh reference: bitwise, except a reply the
    card's other kernel (K2) gave, which is held to F32_TOL."""
    got = resp.value.to_dense()
    if got.device.type == "cpu" or (resp.backend == "pallas" and not resp.degraded):
        return bool(torch.equal(got, ref))
    err = (got.double() - ref.double()).abs()
    return bool((err <= F32_TOL[0] * scale.double() + F32_TOL[1]).all())


def scene_grouped(svc, structures, refs, scales):
    """1. six requests alternating the structures, drained. Returns them."""
    reqs = [svc.submit(*structures[i % 2]) for i in range(6)]
    svc.drain()
    for i, r in enumerate(reqs):
        assert r.ok and reply_ok(r, refs[i % 2], scales[i % 2])
    return reqs


def scene_backpressure(svc, structures):
    """2. a burst of 12 into a queue of 8. Returns (burst, rejected)."""
    burst = [svc.submit(*structures[0]) for _ in range(12)]
    rejected = [r for r in burst if isinstance(r.error, AdmissionRejected)]
    assert len(rejected) == 4  # 8 admitted (max_queue), 4 refused
    svc.drain()
    assert all(r.ok for r in burst if r not in rejected)
    return burst, rejected


def scene_deadlines(svc, structures, clock):
    """3. a deadline refused at admission, one expired in the queue, one
    met. Returns (infeasible, expired, fine)."""
    svc.metrics.reset()    # forget the measured (fast) steps for this demo
    svc.step_hint_s = 0.5  # pretend a step costs 0.5s (seeds the estimator)
    infeasible = svc.submit(*structures[0], deadline_s=0.1)
    assert isinstance(infeasible.error, AdmissionRejected)
    expired = svc.submit(*structures[0], deadline_s=1.0)
    fine = svc.submit(*structures[1], deadline_s=60.0)
    clock.now += 2.0  # the queue sat longer than the first deadline
    svc.drain()
    assert isinstance(expired.error, DeadlineExceeded) and fine.ok
    return infeasible, expired, fine


def scene_breaker(svc, structures, refs, scales, clock):
    """4. four singletons under an armed ``kernel:pallas``, then the probe
    after the cooldown. Returns (the window's responses, the probe's, the
    breaker counts the window added)."""
    def serve_one():
        r = svc.submit(*structures[0])
        svc.step()
        assert r.ok and reply_ok(r, refs[0], scales[0])
        return r

    before = dict(telemetry.BREAKER_COUNTS)
    with faults.failpoint("kernel:pallas"):
        window = [serve_one() for _ in range(4)]
    counts = {k: v - before.get(k, 0) for k, v in telemetry.BREAKER_COUNTS.items()}
    clock.now += 5.0  # cooldown elapses, kernel healed
    probe = serve_one()
    assert probe.backend == "pallas" and not probe.degraded
    return window, probe, counts


def scene_warming(svc, structures):
    """5. an eviction storm, warm(), one request a structure. Returns
    (warm stats, plan-cache misses before the burst, after it)."""
    svc.plan_cache.clear()
    stats = svc.warm()
    misses0 = svc.plan_cache.stats()["misses"]
    svc.submit(*structures[0])
    svc.submit(*structures[1])
    svc.drain()
    misses = svc.plan_cache.stats()["misses"]
    assert misses == misses0
    return stats, misses0, misses


def scene_tracing(svc, structures, path: str = TRACE_PATH):
    """6. a traced burst of four, exported to ``path``. Returns (the spans,
    their request trace ids, the numeric.dispatch histogram, the debug
    stats)."""
    obs.set_tracing("on")
    try:
        traced = [svc.submit(*structures[i % 2]) for i in range(4)]
        svc.drain()
        assert all(r.ok for r in traced)
        spans = obs.export_chrome_trace(path)["traceEvents"]
    finally:
        obs.set_tracing(None)  # back to the $REPRO_TRACE default (off)
    tids = sorted({e["args"].get("trace_id") for e in spans if e["args"].get("trace_id")})
    return spans, tids, obs.default_registry().histogram("numeric.dispatch"), \
        svc.stats(debug=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = pick_device(ap, ap.parse_args(argv).device)
    structures, refs, scales = make_structures(device)
    clock = Clock()
    svc = make_service(clock)

    reqs = scene_grouped(svc, structures, refs, scales)
    print(f"1. served {len(reqs)} requests in "
          f"{svc.counters['group_dispatches']} group dispatches "
          f"(group sizes: {sorted(r.group_size for r in reqs)})")

    burst, rejected = scene_backpressure(svc, structures)
    print(f"2. burst of {len(burst)}: {len(rejected)} shed with "
          f"AdmissionRejected, the rest completed")

    scene_deadlines(svc, structures, clock)
    print("3. deadlines: 0.1s refused at admission (est wait 0.5s), 1.0s "
          "expired in queue -> DeadlineExceeded, 60s completed")

    window, probe, counts = scene_breaker(svc, structures, refs, scales, clock)
    safe = window[-1].backend
    bar = ("every reply still bitwise-correct" if device.type == "cpu" else
           "every reply within F32_TOL of the fresh multiply; K1's replies bitwise")
    route = "routes to the other kernel" if device.type == "cuda" else "routes to xla"
    print(f"4. fault window: degraded={[r.degraded for r in window]} (breaker opened "
          f"after {svc._breakers['pallas'].failure_threshold}; opens="
          f"{counts.get('pallas:open', 0)}, short_circuits="
          f"{counts.get('pallas:short_circuit', 0)} requests skipped the broken kernel: "
          f"the open breaker {route} ({safe}); {bar})")
    print(f"4. recovery: half-open probe succeeded, breaker "
          f"{svc._breakers['pallas'].state}, traffic back on {probe.backend}")

    stats, _, _ = scene_warming(svc, structures)
    print(f"5. warmed {stats['built']} plans from the traffic log; the next "
          f"burst ran with zero plan-cache misses")

    spans, tids, hist, debug = scene_tracing(svc, structures)
    print(f"6. traced burst: {len(spans)} spans from requests {tids} -> "
          f"{TRACE_PATH} (open in chrome://tracing); "
          f"numeric.dispatch p50={hist.percentile(50)*1e6:.0f}us "
          f"p99={hist.percentile(99)*1e6:.0f}us over {hist.count} dispatches; "
          f"flight recorder holds {debug['flight_recorder']['recorded']} "
          f"events")

    print(f"\nfinal stats: completed={svc.counters['completed']} "
          f"shed_rate={svc.stats()['shed_rate']:.3f} "
          f"breaker={svc.stats()['breakers']['pallas']['state']}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

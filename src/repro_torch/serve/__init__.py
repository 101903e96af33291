"""repro_torch.serve — the serving tier (port of ``repro.serve``).

engine:         token-serving ServeEngine (batched prefill, then eager
                decode over in-place caches) for the model zoo.
spgemm_service: overload-safe SpGEMM request serving (bounded admission,
                deadlines, grouped dispatch, circuit-broken degradation);
                on the card every request is served by a replay kernel,
                a batched group by one batched launch.
breaker:        per-kernel circuit breaker over the degradation ladder.
warmer:         traffic-log driven plan-cache warming.
"""
from repro_torch.serve.breaker import CircuitBreaker
from repro_torch.serve.engine import ServeEngine, prefill_to_cache
from repro_torch.serve.spgemm_service import SparseResponse, SparseService
from repro_torch.serve.warmer import TrafficEntry, TrafficLog, warm_plan_cache

__all__ = [
    "ServeEngine",
    "prefill_to_cache",
    "SparseService",
    "SparseResponse",
    "CircuitBreaker",
    "TrafficLog",
    "TrafficEntry",
    "warm_plan_cache",
]

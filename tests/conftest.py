"""Shared fixtures. NOTE: no XLA device-count flags here by design — smoke
tests and benches must see 1 CPU device; only launch/dryrun.py (separate
process) forces 512 placeholder devices."""
import jax
import numpy as np
import pytest

try:
    import hypothesis  # noqa: F401

    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

# Modules whose property tests need hypothesis (see requirements-dev.txt):
# without it they must be skipped at collection, not error at import.
_HYPOTHESIS_MODULES = ["test_accumulators.py", "test_sparse.py", "test_spgemm.py"]
collect_ignore = [] if _HAVE_HYPOTHESIS else list(_HYPOTHESIS_MODULES)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (repro_torch kernels); skips without one")


def pytest_report_header(config):
    if not _HAVE_HYPOTHESIS:
        return ("hypothesis not installed — skipping "
                + ", ".join(_HYPOTHESIS_MODULES)
                + " (pip install -r requirements-dev.txt)")
    return None


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)


@pytest.fixture(autouse=True)
def _reset_telemetry():
    """Per-test telemetry + tuner isolation: every counter starts at zero
    and no fitted table / measured winner leaks across tests (the tuner
    registries are process-global). Lazy imports keep collection cheap."""
    from repro import obs
    from repro.core import autotune, telemetry
    from repro.runtime import faults

    telemetry.reset_all()
    autotune.reset_tuner()
    faults.reset_failpoints()
    obs.reset_obs()
    yield
    faults.reset_failpoints()  # an armed failpoint must never leak forward
    obs.reset_obs()  # enabled tracing / ring contents must not leak either


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop compiled-executable references between modules: the full suite
    jits hundreds of programs and XLA-CPU's JIT object space is finite —
    without this the tail of the suite hits 'Failed to materialize symbols'
    resource failures."""
    yield
    jax.clear_caches()

"""Measured autotuner for the kkSpGEMM meta-algorithm.

The paper's central claim is that no single accumulator wins — but its
selection constants (``AVG_ROW_FLOPS_CUTOFF = 256``, ``DENSE_K_CUTOFF =
250_000`` in ``core/meta.py``) were calibrated for KNL/Pascal, and Nagasaka
et al. show the hash/dense crossover is architecture-dependent. This module
closes the loop two ways, in increasing order of precedence:

  static   — the paper's constants. Always available; the documented
             fallback and the default when no fit exists.
  fitted   — per-backend thresholds learned from measured crossover data:
             ``fit_thresholds`` ingests ``bench_accumulators`` rows (the
             ``BENCH_accum_<sha>.json`` CI artifact) and fits the
             dense-acc/LP-hash crossover per ``backend|platform`` key by
             minimizing total pick time over candidate cutoffs (the
             geometric midpoints between measured avg-row-flop points, plus
             0 and inf) — so on the sweep it was fitted from, the fitted
             rule is never slower in total than the static rule.
             ``set_tuned_thresholds`` activates a table;
             ``choose_kernel``/``choose_method`` consult it automatically.
  measured — opt-in first-sight micro-benchmarking (``spgemm(...,
             tune="measure")``, ``ReuseExecutor(tune="measure")``,
             ``numeric_values(..., tune="measure")``): on first sight of a
             structure-stats bucket (key = ``round_capacity``-bucketed
             ``(m, k, fm, avg_row_flops)`` + operand dtypes + backend +
             selection-table site), each eligible kernel from the selection
             table is timed on the real operands and the winner is cached —
             in the bucket table here and in the plan-cache entry — so
             replays and ``spgemm_grouped`` dispatch the measured winner
             with zero re-tuning.

Telemetry: ``TUNE_COUNTS`` counts ``micro_bench`` (a candidate sweep ran),
``bucket_hit`` (a cached bucket winner was reused) and ``plan_meta_hit`` (a
winner came back from a plan-cache entry), mirroring ``STAGE_COUNTS`` /
``HASH_COUNTS`` so tests can assert the zero-re-tuning contract.

Port of ``repro/core/autotune.py``. Where the reference asks JAX for the
default device, the port takes the device from the operands:
``backend_key(device)`` is ``cuda|<torch.cuda.get_device_name(device)>``
for a CUDA device and ``cpu|cpu`` otherwise (the reference's key on the
CPU), and a call without a device means the card when one is visible.
``bucket_key`` spells dtypes as numpy does ("float32", "bfloat16"), so the
two packages give equal keys on the CPU. ``measure_candidates`` keeps the
reference's protocol (one warm-up, the median of ``reps`` runs timed with
``time.perf_counter``), closing every run with ``torch.cuda.synchronize``
on the card where the reference blocks until ready; each output is
dropped as soon as it is timed, so a sweep holds one candidate's output at
a time.
"""
from __future__ import annotations

import json
import math
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.core.meta import (
    AVG_ROW_FLOPS_CUTOFF,
    DENSE_K_CUTOFF,
    round_capacity,
)
from repro_torch.core.utils import block_until_ready

# Opt-in empirical modes accepted by spgemm()/ReuseExecutor/numeric_values.
# None is the default: static constants, or the fitted table when one is
# active for the current backend.
TUNE_MODES = (None, "measure")

# The bench_accumulators arm names, and the arm each choose_kernel pick
# corresponds to (the fitter times picks through these columns).
ACCUM_ARMS = ("dense_acc", "segsum", "lp_hash")
ARM_OF_PICK = {"dense_acc": "dense_acc", "flat_lp": "lp_hash"}

# Micro-bench telemetry (see module docstring).
TUNE_COUNTS: Counter = Counter()

# First-sight bucket table: bucket_key -> winning kernel/backend name.
_MEASURED: dict[tuple, str] = {}

# The active fitted-thresholds table (None -> static constants).
_ACTIVE: "TunedThresholds | None" = None


def validate_tune(tune) -> None:
    if tune not in TUNE_MODES:
        from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
        raise SpgemmConfigError(
            f"unknown tune mode {tune!r}; expected one of {TUNE_MODES} "
            f"(None = static/fitted thresholds, 'measure' = first-sight "
            f"micro-bench)")


def reset_tune_counts() -> None:
    TUNE_COUNTS.clear()


def reset_tuner() -> None:
    """Full tuner reset: counters, measured-winner buckets, fitted table.

    Test-isolation helper (conftest runs it per test): the registry and the
    bucket table are process-global, so a fitted table or measured winner
    must never leak across tests.
    """
    global _ACTIVE
    TUNE_COUNTS.clear()
    _MEASURED.clear()
    _ACTIVE = None


# --------------------------------------------------------------------------
# Fitted thresholds
# --------------------------------------------------------------------------


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def backend_key(device=None) -> str:
    """The per-backend key fitted thresholds are stored under.

    ``backend|device_kind``: ``cuda|NVIDIA H100 80GB HBM3`` for a CUDA
    device (the card's name: crossovers differ between cards, exactly what
    static cutoffs can't capture), ``cpu|cpu`` otherwise. ``device`` is the
    operands' device; None means the card when one is visible.
    """
    dev = _device(device)
    if dev.type == "cuda":
        return f"cuda|{torch.cuda.get_device_name(dev)}"
    return "cpu|cpu"


@dataclass(frozen=True)
class BackendFit:
    """One backend's fitted crossover points.

    avg_row_flops_cutoff: fitted dense_acc/flat_lp crossover. May be 0.0
        (LP-hash always wins on this backend) or inf (dense-acc always wins
        — e.g. on the CPU, where both run their plain versions).
    dense_k_cutoff: fitted KKDENSE k cutoff, or None to keep the paper's
        static constant (the accumulator sweep does not vary k today).
    points: the ``(avg_row_flops, winner)`` evidence the fit was made from.
    """

    avg_row_flops_cutoff: float
    dense_k_cutoff: int | None = None
    n_points: int = 0
    points: tuple = field(default_factory=tuple)


class TunedThresholds:
    """Per-backend fitted threshold table consulted by ``core.meta``.

    ``fits`` maps ``backend_key()`` strings to ``BackendFit``. A backend
    with no row falls back to the static paper constants — the fitted table
    only ever *narrows* behavior where there is measured evidence.
    ``jax_version`` keeps the reference's JSON schema (the key is read and
    written as it is); the port's own fits leave it None.
    """

    SCHEMA = 1

    def __init__(self, fits: dict[str, BackendFit] | None = None, *,
                 jax_version: str | None = None,
                 source: str | None = None):
        self.fits: dict[str, BackendFit] = dict(fits or {})
        self.jax_version = jax_version
        self.source = source

    def for_backend(self, key: str | None = None) -> BackendFit | None:
        """The fit for ``key`` (default: ``backend_key()``), or None.

        Falls back to a backend-name-only match (``cpu|*``) when exactly one
        fitted row shares the backend half of the key — older artifacts
        lack the device-kind stamp.
        """
        key = backend_key() if key is None else key
        fit = self.fits.get(key)
        if fit is not None:
            return fit
        base = key.split("|", 1)[0]
        matches = [f for k, f in self.fits.items()
                   if k.split("|", 1)[0] == base]
        return matches[0] if len(matches) == 1 else None

    def to_json(self) -> dict:
        return {
            "schema": self.SCHEMA,
            "kind": "tuned_thresholds",
            "jax_version": self.jax_version,
            "source": self.source,
            "fits": {
                k: {
                    # inf serialized as a string: portable JSON, exact
                    # round-trip (json's bare Infinity is non-standard)
                    "avg_row_flops_cutoff": (
                        f.avg_row_flops_cutoff
                        if math.isfinite(f.avg_row_flops_cutoff)
                        else "inf"),
                    "dense_k_cutoff": f.dense_k_cutoff,
                    "n_points": f.n_points,
                    "points": [list(p) for p in f.points],
                }
                for k, f in self.fits.items()
            },
        }

    @classmethod
    def from_json(cls, payload: dict) -> "TunedThresholds":
        if payload.get("kind") != "tuned_thresholds":
            from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
            raise SpgemmConfigError(
                "not a tuned_thresholds payload (kind="
                f"{payload.get('kind')!r}) — pass the JSON written by "
                "TunedThresholds.save / benchmarks.run --fit-thresholds")
        fits = {}
        for k, f in payload.get("fits", {}).items():
            cutoff = f["avg_row_flops_cutoff"]
            fits[k] = BackendFit(
                avg_row_flops_cutoff=(
                    math.inf if cutoff == "inf" else float(cutoff)),
                dense_k_cutoff=(None if f.get("dense_k_cutoff") is None
                                else int(f["dense_k_cutoff"])),
                n_points=int(f.get("n_points", 0)),
                points=tuple(tuple(p) for p in f.get("points", ())),
            )
        return cls(fits, jax_version=payload.get("jax_version"),
                   source=payload.get("source"))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2)
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "TunedThresholds":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


def set_tuned_thresholds(table: TunedThresholds | None) -> TunedThresholds | None:
    """Activate a fitted table (None deactivates). Returns the previous one."""
    global _ACTIVE
    if table is not None and not isinstance(table, TunedThresholds):
        raise TypeError(
            f"expected TunedThresholds or None, got {type(table).__name__}")
    prev, _ACTIVE = _ACTIVE, table
    return prev


def get_tuned_thresholds() -> TunedThresholds | None:
    return _ACTIVE


def load_thresholds(path: str, *, activate: bool = True) -> TunedThresholds:
    """Load a saved fitted table, activating it by default."""
    table = TunedThresholds.load(path)
    if activate:
        set_tuned_thresholds(table)
    return table


def avg_row_flops_cutoff(device=None) -> tuple[float, str]:
    """The effective dense_acc/flat_lp cutoff: (value, source).

    source is "fitted" when the active table has a row for ``device``'s
    backend (the operands' device; None as in ``backend_key``), "static"
    (the paper's 256) otherwise.
    """
    if _ACTIVE is not None:
        fit = _ACTIVE.for_backend(backend_key(device))
        if fit is not None:
            return float(fit.avg_row_flops_cutoff), "fitted"
    return float(AVG_ROW_FLOPS_CUTOFF), "static"


def dense_k_cutoff(device=None) -> tuple[int, str]:
    """The effective KKDENSE k cutoff: (value, source)."""
    if _ACTIVE is not None:
        fit = _ACTIVE.for_backend(backend_key(device))
        if fit is not None and fit.dense_k_cutoff is not None:
            return int(fit.dense_k_cutoff), "fitted"
    return DENSE_K_CUTOFF, "static"


def _fit_cutoff(points: list[tuple[float, float, float]],
                static_cutoff: float) -> float:
    """Threshold fit over ``(avg_row_flops, t_dense_acc, t_lp)`` points.

    Candidate cutoffs — 0, the geometric midpoints between consecutive
    points, inf — cover every pick-pattern a single threshold can realize
    on these points, so minimizing total pick time guarantees the fitted
    rule is never slower in total than the static one on this sweep (the
    static cutoff lies in one of the candidate regions). Ties break toward
    the candidate closest to the static cutoff in log space: no evidence,
    no movement.
    """
    pts = sorted(points)
    arfs = [p[0] for p in pts]
    cands = [0.0]
    for lo, hi in zip(arfs, arfs[1:]):
        if hi > lo:
            cands.append(math.sqrt(lo * hi))
    cands.append(math.inf)

    def total(c: float) -> float:
        return sum(td if arf < c else tl for arf, td, tl in pts)

    def log_dist(c: float) -> float:
        c = min(max(c, 1e-12), 1e12)
        return abs(math.log(c) - math.log(static_cutoff))

    return min(cands, key=lambda c: (total(c), log_dist(c)))


def fit_thresholds(payload_or_rows, *,
                   static_cutoff: float = float(AVG_ROW_FLOPS_CUTOFF),
                   source: str | None = None) -> TunedThresholds:
    """Fit per-backend thresholds from ``bench_accumulators`` rows.

    Accepts either a full ``--json`` benchmark payload (``{"rows": [...]}``)
    or a bare row list. Rows named ``accumulators/<regime>/<arm>`` with
    ``derived.avg_row_flops`` feed the fit; each row's ``backend``/
    ``platform`` stamps key the fit per backend (rows without stamps fall
    back to the payload's top-level backend). Regimes missing either the
    ``dense_acc`` or ``lp_hash`` arm are skipped — the fit compares the two
    arms ``choose_kernel`` actually picks between.
    """
    if isinstance(payload_or_rows, dict):
        rows = payload_or_rows.get("rows", [])
        default_bkey = (f"{payload_or_rows.get('backend', 'unknown')}|"
                        f"{payload_or_rows.get('platform', 'unknown')}")
        jax_version = payload_or_rows.get("jax_version")
    else:
        rows = list(payload_or_rows)
        default_bkey = "unknown|unknown"
        jax_version = None

    grouped: dict[str, dict[str, dict]] = {}
    for row in rows:
        parts = str(row.get("name", "")).split("/")
        if len(parts) != 3 or parts[0] != "accumulators":
            continue
        _, regime, arm = parts
        if arm not in ACCUM_ARMS:
            continue
        derived = row.get("derived", {})
        if "avg_row_flops" not in derived:
            continue
        if row.get("backend") is not None:
            bkey = f"{row['backend']}|{row.get('platform', 'unknown')}"
        else:
            bkey = default_bkey
        entry = grouped.setdefault(bkey, {}).setdefault(regime, {})
        entry["arf"] = float(derived["avg_row_flops"])
        entry[arm] = float(row["us_per_call"])

    fits: dict[str, BackendFit] = {}
    for bkey, regimes in grouped.items():
        points = sorted(
            (e["arf"], e["dense_acc"], e["lp_hash"])
            for e in regimes.values()
            if "dense_acc" in e and "lp_hash" in e
        )
        if not points:
            continue
        cutoff = _fit_cutoff(points, static_cutoff)
        fits[bkey] = BackendFit(
            avg_row_flops_cutoff=cutoff,
            dense_k_cutoff=None,
            n_points=len(points),
            points=tuple(
                (arf, "dense_acc" if td <= tl else "flat_lp")
                for arf, td, tl in points
            ),
        )
    return TunedThresholds(fits, jax_version=jax_version, source=source)


# --------------------------------------------------------------------------
# First-sight micro-bench ("measure" mode)
# --------------------------------------------------------------------------


def dtype_name(dtype) -> str:
    """A dtype as numpy spells it: torch.float32 -> "float32"."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def bucket_key(m: int, k: int, fm: int, a_dtype, b_dtype,
               table: str, device=None) -> tuple:
    """The structure-stats bucket a measured winner is cached under.

    ``round_capacity``-bucketed (m, k, fm, avg_row_flops) + operand dtypes
    + backend + ``table`` (the selection-table site the winner applies to:
    "replay" for plan-replay backends, "numeric" for the ELL numeric-phase
    kernels — the two sites have different candidate sets, so their winners
    must not collide). ``fm`` is bucketed with the same pow2 rule as
    ``fm_cap``, so callers holding either the true ``fm`` or the bucketed
    cap land in the same bucket; avg row flops derives from the bucketed
    fm for the same reason. ``device``: the operands' (see ``backend_key``).
    """
    fm_b = round_capacity(max(int(fm), 1))
    arf_b = round_capacity(max(fm_b // max(int(m), 1), 1))
    return (table, backend_key(device), round_capacity(max(int(m), 1)),
            round_capacity(max(int(k), 1)), fm_b, arf_b,
            dtype_name(a_dtype), dtype_name(b_dtype))


def lookup_measured(key: tuple) -> str | None:
    """Cached bucket winner, or None (bumps ``bucket_hit`` on a hit)."""
    winner = _MEASURED.get(key)
    if winner is not None:
        TUNE_COUNTS["bucket_hit"] += 1
    return winner


def record_measured(key: tuple, winner: str) -> None:
    _MEASURED[key] = winner


def measured_table_size() -> int:
    return len(_MEASURED)


def measure_candidates(candidates: dict[str, Callable[[], object]], *,
                       reps: int = 3) -> tuple[str, dict[str, float]]:
    """Time each candidate thunk and return (winner, times_us).

    Protocol mirrors the benchmark harness: one excluded warmup (which also
    pays any kernel build) + median of ``reps`` timed runs, each closed by a
    synchronize so launch-only returns don't win by cheating. An output is
    dropped before the next run starts. Bumps ``TUNE_COUNTS["micro_bench"]``
    once per sweep.
    """
    if not candidates:
        from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
        raise SpgemmConfigError(
            "measure_candidates needs at least one candidate")
    TUNE_COUNTS["micro_bench"] += 1
    times: dict[str, float] = {}
    for name, fn in candidates.items():
        block_until_ready(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        ts.sort()
        times[name] = ts[len(ts) // 2] * 1e6
    winner = min(times, key=times.get)
    return winner, times


def measure_and_record(key: tuple,
                       candidates: dict[str, Callable[[], object]], *,
                       reps: int = 3) -> tuple[str, dict[str, float]]:
    """``measure_candidates`` + cache the winner under ``key``."""
    winner, times = measure_candidates(candidates, reps=reps)
    record_measured(key, winner)
    return winner, times

"""repro_torch.analysis — the port's static contract linter.

Port of ``repro/analysis``: the same rule ids, the same ``Finding`` and
``Report`` fields and fingerprints, the same ``--json`` report, the same
``# repro: allow[...]`` grammar and the same registries, read at the same
relative paths, so one tree gives both linters the same report. Where the
reference reads jit- and Pallas-traced code, this one also reads the
port's kernel launches: a *kernel wrapper* is a function of ``kernels/``
that launches a hand-written kernel (through ``_build.launch`` or
``_build.load``, or through another wrapper), and ``jit-boundary`` holds
the wrappers and their same-module helpers to no try, no host wait without
a reason, and no silent fallback around a launch (``rules_jit``);
``env.import-time-device-work`` also knows torch's device queries and a
kernel build at import (``rules_env``).

Pieces:

  * :mod:`repro_torch.analysis.context`  — parsed-module project model + the
    machine-readable registries (``SPAN_NAMES``, ``KEY_FAMILIES``,
    ``ALL_COUNTERS``, the typed taxonomy) read *statically* from the tree
    under scan, so fixture trees lint exactly like the real package;
  * :mod:`repro_torch.analysis.registry` — the rule registry (``@rule``);
  * ``rules_*`` modules                  — one module per shipped rule;
  * :mod:`repro_torch.analysis.runner`   — ``run_analysis``: scan +
    suppression (``# repro: allow[RULE]``) + baseline filtering;
  * :mod:`repro_torch.analysis.cli`      — ``python -m repro_torch.analysis``
    (exit 0 iff no *new* findings; ``--json`` report artifact).
"""
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.registry import RULES, all_rule_ids, rule
from repro_torch.analysis.runner import run_analysis

# rule modules self-register on import; keep after registry import
from repro_torch.analysis import (  # noqa: E402  (registration side effects)
    rules_env,
    rules_jit,
    rules_spans,
    rules_taxonomy,
    rules_telemetry,
)

__all__ = [
    "Finding",
    "Report",
    "RULES",
    "all_rule_ids",
    "rule",
    "run_analysis",
    "rules_env",
    "rules_jit",
    "rules_spans",
    "rules_taxonomy",
    "rules_telemetry",
]

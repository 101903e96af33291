"""Rule ``span`` — every ``span("...")`` literal is in the taxonomy.

``obs/trace.py`` exports ``SPAN_NAMES``, the fixed span taxonomy that the
ROADMAP table, the flight recorder's ring schema, and the latency
histograms all key on. A free-typed span name creates a series no
dashboard knows about and silently drops out of the phase-latency story.

Sub-checks:

  * ``span.unknown-name`` — a ``span("...")``/``start_span("...")`` call
    whose literal name is not in ``SPAN_NAMES``.
  * ``span.dynamic-name`` — a span call with a non-literal name (can't be
    checked statically; build the name from taxonomy constants instead).
  * ``span.no-registry`` — ``obs/trace.py`` exists but exports no
    ``SPAN_NAMES`` literal (the registry this rule checks against).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.asthelpers import calls_in, dotted, string_value
from repro_torch.analysis.context import TRACE_MODULE, Project
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

RULE = "span"

SPAN_CALLS = {"span", "start_span"}


@rule(RULE, "span name literals come from obs.trace.SPAN_NAMES")
def check(project: Project):
    trace = project.module(TRACE_MODULE)
    names = project.span_names()
    if trace is not None and names is None:
        yield Finding(
            rule=RULE, code=f"{RULE}.no-registry",
            path=TRACE_MODULE, line=1,
            message="obs/trace.py exports no SPAN_NAMES literal",
            hint="add SPAN_NAMES = frozenset({...}) listing the span "
                 "taxonomy (ROADMAP phase table)",
            snippet=trace.snippet(1))
        return
    if names is None:
        return  # no trace module under this root: nothing to check

    for mod in project.modules:
        if mod.rel == TRACE_MODULE:
            continue  # the registry module itself (defines the machinery)
        for call in calls_in(mod.tree):
            last = dotted(call.func).rsplit(".", 1)[-1]
            if last not in SPAN_CALLS or not call.args:
                continue
            value = string_value(call.args[0])
            if value is None:
                yield Finding(
                    rule=RULE, code=f"{RULE}.dynamic-name",
                    path=mod.rel, line=call.lineno,
                    message=f"{last}(...) with a non-literal span name",
                    hint="pass a literal from obs.trace.SPAN_NAMES so the "
                         "taxonomy stays statically checkable",
                    snippet=mod.snippet(call.lineno))
            elif value not in names:
                yield Finding(
                    rule=RULE, code=f"{RULE}.unknown-name",
                    path=mod.rel, line=call.lineno,
                    message=(f"span name '{value}' is not in "
                             f"obs.trace.SPAN_NAMES"),
                    hint="add it to SPAN_NAMES (and the ROADMAP phase "
                         "table) in the same commit, or fix the typo",
                    snippet=mod.snippet(call.lineno))

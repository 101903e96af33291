"""Rule ``taxonomy`` — errors go through the typed taxonomy, loudly.

``runtime/validate.py`` owns the error taxonomy: every failure mode
has a typed class that still subclasses its builtin ancestor, so callers
can catch precisely while legacy ``except ValueError`` keeps working.

Sub-checks:

  * ``taxonomy.bare-raise`` — ``raise ValueError(...)`` or
    ``raise RuntimeError(...)`` outside ``runtime/validate.py``. Use (or
    add) a taxonomy class; they subclass the builtin, so no caller breaks.
  * ``taxonomy.broad-except`` — an ``except Exception``/bare ``except``
    handler that swallows: no re-raise, no typed-error construction, no
    telemetry record. Silent failure is the one thing the hardened
    execution story forbids.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.asthelpers import dotted
from repro_torch.analysis.context import TAXONOMY_MODULE, Project
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule
from repro_torch.analysis.rules_jit import _broad, _handler_is_loud

RULE = "taxonomy"

BARE = {"ValueError", "RuntimeError"}


@rule(RULE, "no bare ValueError/RuntimeError; no silent broad excepts")
def check(project: Project):
    taxonomy = project.taxonomy_classes()
    for mod in project.modules:
        exempt = mod.rel == TAXONOMY_MODULE
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Raise) and not exempt:
                exc = node.exc
                target = exc.func if isinstance(exc, ast.Call) else exc
                name = dotted(target) if target is not None else ""
                if name in BARE:
                    yield Finding(
                        rule=RULE, code=f"{RULE}.bare-raise",
                        path=mod.rel, line=node.lineno,
                        message=(f"bare raise {name} — use the typed "
                                 f"taxonomy in runtime/validate.py"),
                        hint=("raise SpgemmConfigError / SpgemmInputError / "
                              "PlanMismatchError / ... (they subclass "
                              f"{name}, so no caller breaks)"),
                        snippet=mod.snippet(node.lineno))
            if isinstance(node, ast.Try):
                for handler in node.handlers:
                    if _broad(handler) and not _handler_is_loud(handler, taxonomy):
                        yield Finding(
                            rule=RULE, code=f"{RULE}.broad-except",
                            path=mod.rel, line=handler.lineno,
                            message=("broad except that swallows: no "
                                     "re-raise, no typed error, no "
                                     "telemetry record"),
                            hint=("re-raise typed, bump a counter, or "
                                  "annotate # repro: allow[taxonomy] with "
                                  "a why"),
                            snippet=mod.snippet(handler.lineno))

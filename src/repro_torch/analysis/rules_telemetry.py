"""Rule ``telemetry-key`` — counter keys follow the documented grammars.

Every subsystem keeps a module-level ``Counter`` and the key shapes are a
documented contract (``core/telemetry.py`` ``KEY_FAMILIES``): dashboards,
the serving tier's retry-rate math, and the tests all parse these strings.
A typo'd key (``nan_guard:re-run``) silently creates a new series nothing
reads.

Sub-checks:

  * ``telemetry-key.grammar`` — a literal or f-string key written into a
    ``*_COUNTS`` counter does not match any template of its family.
    F-strings check their literal fragments (dynamic pieces map onto
    ``{}`` wildcards); a dynamic piece that is a *parameter* of the
    enclosing function is expanded from literal same-module call-site
    arguments, so ``BREAKER_COUNTS[f"{self.name}:{event}"]`` is checked
    against the actual events passed to ``_count(...)``.
  * ``telemetry-key.unknown-family`` — a write to a ``*_COUNTS`` name with
    no ``KEY_FAMILIES`` entry.
  * ``telemetry-key.unregistered`` — a module-level ``*_COUNTS = Counter()``
    definition whose name is absent from ``telemetry.ALL_COUNTERS`` (it
    would dodge ``snapshot()``/``reset_all()`` and leak state across
    tests).
  * ``telemetry-key.reset-drift`` — ``ALL_COUNTERS`` and ``_RESETS`` have
    different sizes (a counter registered for snapshots but not cleared by
    ``reset_all``, or vice versa).
"""
from __future__ import annotations

import ast
import itertools
import re

from repro_torch.analysis.asthelpers import calls_in, dotted, string_value
from repro_torch.analysis.context import TELEMETRY_MODULE, ModuleInfo, Project
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

RULE = "telemetry-key"

_MAX_EXPANSION = 64
_SENTINEL = "\x00"


def _family_of(counter_name: str) -> str:
    return counter_name.removesuffix("_COUNTS").lower()


def _template_matches(template: str, key: str) -> bool:
    pattern = "^" + ".+".join(
        re.escape(part) for part in template.split("{}")) + "$"
    return re.match(pattern, key, flags=re.DOTALL) is not None


def _param_index(fn: ast.FunctionDef | ast.AsyncFunctionDef, name: str) -> int | None:
    """Positional index of ``name`` at *call sites* (self/cls stripped)."""
    args = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if args and args[0] in {"self", "cls"}:
        args = args[1:]
    try:
        return args.index(name)
    except ValueError:
        return None


def _callsite_values(mod: ModuleInfo, fname: str, index: int) -> list[str] | None:
    """Literal strings passed at position ``index`` to same-module calls of
    ``fname``; None when any call site is non-literal (can't expand)."""
    vals: list[str] = []
    for call in calls_in(mod.tree):
        last = dotted(call.func).rsplit(".", 1)[-1]
        if last != fname:
            continue
        if index < len(call.args):
            s = string_value(call.args[index])
            if s is None:
                return None
            vals.append(s)
        else:
            return None
    return vals or None


def _key_candidates(node: ast.expr,
                    fn: ast.FunctionDef | ast.AsyncFunctionDef | None,
                    mod: ModuleInfo) -> list[str] | None:
    """Concrete key strings a write could produce (dynamic → sentinel).

    None means the key is fully dynamic with no literal fragment —
    statically unchecked (counted in stats, not flagged).
    """
    s = string_value(node)
    if s is not None:
        return [s]
    if isinstance(node, ast.JoinedStr):
        pieces: list[list[str]] = []
        for part in node.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                pieces.append([part.value])
            elif isinstance(part, ast.FormattedValue) and fn is not None \
                    and isinstance(part.value, ast.Name):
                idx = _param_index(fn, part.value.id)
                vals = (_callsite_values(mod, fn.name, idx)
                        if idx is not None else None)
                pieces.append(vals if vals else [_SENTINEL])
            else:
                pieces.append([_SENTINEL])
        if all(v == [_SENTINEL] for v in pieces):
            return None
        combos = list(itertools.islice(
            itertools.product(*pieces), _MAX_EXPANSION))
        return ["".join(c) for c in combos]
    return None


def _counter_writes(mod: ModuleInfo):
    """Yield (counter_name, key_expr, enclosing_fn, lineno) for every
    subscript write into a ``*_COUNTS`` name."""

    class V(ast.NodeVisitor):
        def __init__(self):
            self.stack: list[ast.FunctionDef | ast.AsyncFunctionDef] = []
            self.hits = []

        def visit_FunctionDef(self, node):
            self.stack.append(node)
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def _check_target(self, target):
            if isinstance(target, ast.Subscript):
                base = dotted(target.value).rsplit(".", 1)[-1]
                if base.endswith("_COUNTS"):
                    fn = self.stack[-1] if self.stack else None
                    self.hits.append(
                        (base, target.slice, fn, target.lineno))

        def visit_AugAssign(self, node):
            self._check_target(node.target)
            self.generic_visit(node)

        def visit_Assign(self, node):
            for t in node.targets:
                self._check_target(t)
            self.generic_visit(node)

    v = V()
    v.visit(mod.tree)
    return v.hits


@rule(RULE, "counter keys match KEY_FAMILIES grammars; every counter registered")
def check(project: Project):
    families = project.key_families()
    registered = project.registered_counters()
    telemetry = project.module(TELEMETRY_MODULE)

    if telemetry is not None and families is None:
        yield Finding(
            rule=RULE, code=f"{RULE}.no-registry",
            path=TELEMETRY_MODULE, line=1,
            message="core/telemetry.py has no KEY_FAMILIES literal dict",
            hint="define KEY_FAMILIES: dict[str, tuple[str, ...]] mapping "
                 "family -> grammar templates ('{}' is a wildcard segment)",
            snippet=telemetry.snippet(1))
        families = {}
    elif families is None:
        return  # no telemetry module under this root: nothing to check

    unchecked = 0
    for mod in project.modules:
        for counter, key_expr, fn, lineno in _counter_writes(mod):
            family = _family_of(counter)
            if family not in families:
                yield Finding(
                    rule=RULE, code=f"{RULE}.unknown-family",
                    path=mod.rel, line=lineno,
                    message=(f"write to {counter} but family '{family}' has "
                             f"no KEY_FAMILIES grammar"),
                    hint="add the family's templates to "
                         "core/telemetry.py KEY_FAMILIES",
                    snippet=mod.snippet(lineno))
                continue
            candidates = _key_candidates(key_expr, fn, mod)
            if candidates is None:
                unchecked += 1
                continue
            templates = families[family]
            for key in candidates:
                if not any(_template_matches(t, key) for t in templates):
                    shown = key.replace(_SENTINEL, "{…}")
                    yield Finding(
                        rule=RULE, code=f"{RULE}.grammar",
                        path=mod.rel, line=lineno,
                        message=(f"key '{shown}' does not match any "
                                 f"'{family}' grammar template "
                                 f"{list(templates)}"),
                        hint="use a documented key shape or extend "
                             "KEY_FAMILIES in the same commit",
                        snippet=mod.snippet(lineno))
                    break

        # module-level Counter definitions must be registered
        if registered is not None:
            for node in mod.tree.body:
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                    value = node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets = [node.target]
                    value = node.value
                else:
                    continue
                if not (isinstance(value, ast.Call)
                        and dotted(value.func).rsplit(".", 1)[-1] == "Counter"):
                    continue
                for t in targets:
                    if isinstance(t, ast.Name) and t.id.endswith("_COUNTS") \
                            and t.id not in registered:
                        yield Finding(
                            rule=RULE, code=f"{RULE}.unregistered",
                            path=mod.rel, line=node.lineno,
                            message=(f"{t.id} is a module-level Counter not "
                                     f"registered in telemetry.ALL_COUNTERS"),
                            hint="add it to ALL_COUNTERS and wire a reset "
                                 "into _RESETS so reset_all() clears it",
                            snippet=mod.snippet(node.lineno))

    if telemetry is not None:
        resets = project.reset_registered()
        all_counters = registered
        if resets is not None and all_counters is not None \
                and len(resets) != len(all_counters):
            yield Finding(
                rule=RULE, code=f"{RULE}.reset-drift",
                path=TELEMETRY_MODULE, line=1,
                message=(f"ALL_COUNTERS has {len(all_counters)} counters but "
                         f"_RESETS wires {len(resets)} reset functions"),
                hint="every registered counter needs a reset in _RESETS",
                snippet="ALL_COUNTERS/_RESETS size mismatch")

    # surfaced in stats by the runner via function attribute
    check.unchecked = unchecked  # type: ignore[attr-defined]

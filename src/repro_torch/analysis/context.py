"""Parsed-project model: module ASTs, allow-comments, static registries.

The analyzer never *imports* the code under scan — everything is read from
the AST. That keeps the pass runnable on broken trees (CI should report the
contract violation, not an ImportError) and makes fixture trees in tests
lint exactly like the real package: a tiny directory with its own
``core/telemetry.py`` / ``obs/trace.py`` / ``runtime/validate.py`` gets its
own registries.

Registry sources (all under the scan root):

  * ``obs/trace.py``        → ``SPAN_NAMES`` (the span taxonomy)
  * ``core/telemetry.py``   → ``KEY_FAMILIES`` (counter-key grammars) and
                              ``ALL_COUNTERS`` (registered counter names)
  * ``runtime/validate.py`` → the typed error taxonomy (class defs)

Suppression: ``# repro: allow[rule-a,rule-b] why`` on the flagged line or
the line directly above it. The rule list matches rule ids ("taxonomy") or
full sub-check codes ("taxonomy.broad-except"); ``allow[*]`` matches every
rule. Suppressions are reported (never silent) — they are the in-code
version of the baseline, for findings that are *intentional*, with the why
next to the code instead of in a JSON file.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([A-Za-z0-9_.\-*,\s]+)\]")

# Registry file locations, relative to the scan root.
TRACE_MODULE = "obs/trace.py"
TELEMETRY_MODULE = "core/telemetry.py"
TAXONOMY_MODULE = "runtime/validate.py"


@dataclass
class ModuleInfo:
    """One parsed source file."""

    path: Path  # absolute
    rel: str  # posix, relative to scan root
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    # line number -> set of allowed rule ids/codes ("*" allows all)
    allow: dict[int, set[str]] = field(default_factory=dict)

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def allowed(self, line: int, rule_id: str, code: str) -> bool:
        """Does an allow-comment on this line (or the one above) cover us?"""
        for ln in (line, line - 1):
            ids = self.allow.get(ln)
            if ids and ("*" in ids or rule_id in ids or code in ids):
                return True
        return False


def _parse_allows(lines: list[str]) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = ALLOW_RE.search(text)
        if m:
            ids = {part.strip() for part in m.group(1).split(",") if part.strip()}
            out[i] = ids
    return out


class Project:
    """The tree under scan + lazily extracted registries."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.modules: list[ModuleInfo] = []
        self.parse_errors: list[tuple[str, str]] = []
        for path in sorted(self.root.rglob("*.py")):
            rel = path.relative_to(self.root).as_posix()
            if rel.startswith("analysis/"):
                continue  # the linter does not lint itself (fixtures do)
            source = path.read_text()
            try:
                tree = ast.parse(source)
            except SyntaxError as e:  # surfaced as a finding by the runner
                self.parse_errors.append((rel, str(e)))
                continue
            lines = source.splitlines()
            self.modules.append(ModuleInfo(
                path=path, rel=rel, source=source, tree=tree, lines=lines,
                allow=_parse_allows(lines)))
        self._cache: dict[str, object] = {}

    # ------------------------------------------------------------------
    # registry extraction (AST-level, never imports the scanned code)
    # ------------------------------------------------------------------

    def module(self, rel: str) -> ModuleInfo | None:
        for m in self.modules:
            if m.rel == rel:
                return m
        return None

    def _module_assign(self, rel: str, name: str) -> ast.expr | None:
        mod = self.module(rel)
        if mod is None:
            return None
        for node in mod.tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value
        return None

    def span_names(self) -> frozenset[str] | None:
        """``SPAN_NAMES`` from obs/trace.py, or None when absent."""
        if "span_names" not in self._cache:
            value = self._module_assign(TRACE_MODULE, "SPAN_NAMES")
            # unwrap frozenset({...}) / set({...}) wrappers around the literal
            if isinstance(value, ast.Call) and len(value.args) == 1 \
                    and ast.unparse(value.func).rsplit(".", 1)[-1] in (
                        "frozenset", "set"):
                value = value.args[0]
            names = None
            if value is not None:
                try:
                    names = frozenset(ast.literal_eval(value))
                except (ValueError, TypeError):
                    names = None
            self._cache["span_names"] = names
        return self._cache["span_names"]  # type: ignore[return-value]

    def key_families(self) -> dict[str, tuple[str, ...]] | None:
        """``KEY_FAMILIES`` grammar templates from core/telemetry.py."""
        if "key_families" not in self._cache:
            value = self._module_assign(TELEMETRY_MODULE, "KEY_FAMILIES")
            fams = None
            if value is not None:
                try:
                    raw = ast.literal_eval(value)
                    fams = {str(k): tuple(str(t) for t in v)
                            for k, v in raw.items()}
                except (ValueError, TypeError, AttributeError):
                    fams = None
            self._cache["key_families"] = fams
        return self._cache["key_families"]  # type: ignore[return-value]

    def registered_counters(self) -> frozenset[str] | None:
        """Counter variable names registered in telemetry.ALL_COUNTERS."""
        if "registered" not in self._cache:
            value = self._module_assign(TELEMETRY_MODULE, "ALL_COUNTERS")
            names = None
            if isinstance(value, ast.Dict):
                names = frozenset(
                    v.id for v in value.values if isinstance(v, ast.Name))
            self._cache["registered"] = names
        return self._cache["registered"]  # type: ignore[return-value]

    def reset_registered(self) -> frozenset[str] | None:
        """Reset-function names wired into telemetry._RESETS."""
        if "resets" not in self._cache:
            value = self._module_assign(TELEMETRY_MODULE, "_RESETS")
            names = None
            if isinstance(value, (ast.Tuple, ast.List)):
                names = frozenset(
                    e.id for e in value.elts if isinstance(e, ast.Name))
            self._cache["resets"] = names
        return self._cache["resets"]  # type: ignore[return-value]

    def taxonomy_classes(self) -> frozenset[str]:
        """Typed-error class names defined in runtime/validate.py (plus the
        retry taxonomy member defined next to its mechanism)."""
        if "taxonomy" not in self._cache:
            names = set()
            mod = self.module(TAXONOMY_MODULE)
            if mod is not None:
                for node in mod.tree.body:
                    if isinstance(node, ast.ClassDef):
                        names.add(node.name)
            # RetryExhaustedError lives in runtime/retry.py by design
            retry = self.module("runtime/retry.py")
            if retry is not None:
                for node in retry.tree.body:
                    if isinstance(node, ast.ClassDef):
                        names.add(node.name)
            self._cache["taxonomy"] = frozenset(names)
        return self._cache["taxonomy"]  # type: ignore[return-value]


def default_root() -> Path:
    """The ``repro_torch`` package directory (what the port's gate scans)."""
    return Path(__file__).resolve().parents[1]

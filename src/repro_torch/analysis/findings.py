"""Finding / report model + the read-only baseline mechanism.

A finding is identified across commits by its *fingerprint*: a digest of
(rule, path, normalized source line). Line numbers shift every edit, so the
baseline matches on content, not position — a grandfathered finding stays
grandfathered when unrelated lines move, and resurfaces the moment the
offending line itself changes.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    """One rule violation: where, what, and how to fix it."""

    rule: str  # rule id ("taxonomy", "env", ...)
    code: str  # sub-check id ("taxonomy.bare-raise", ...)
    path: str  # posix path relative to the scan root
    line: int  # 1-based
    message: str
    hint: str = ""  # fix hint shown in the report
    snippet: str = ""  # stripped source line (fingerprint input)

    @property
    def fingerprint(self) -> str:
        blob = f"{self.rule}|{self.path}|{' '.join(self.snippet.split())}"
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
            "snippet": self.snippet,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.code}] {self.message}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out


@dataclass
class Report:
    """The outcome of one analysis run, split by disposition.

    ``new`` findings fail the gate; ``suppressed`` carry an inline
    ``# repro: allow[RULE]``; ``baselined`` match the committed baseline.
    """

    root: str
    rules: list[str] = field(default_factory=list)
    new: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.new

    def to_dict(self) -> dict:
        return {
            "root": self.root,
            "rules": self.rules,
            "ok": self.ok,
            "counts": {
                "new": len(self.new),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
            },
            "new": [f.to_dict() for f in self.new],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "baselined": [f.to_dict() for f in self.baselined],
            "stats": self.stats,
        }


BASELINE_VERSION = 1


def load_baseline(path) -> set[str]:
    """Fingerprint set from a committed ``analysis/baseline.json``.

    A missing file is an *empty* baseline (the strict default); a malformed
    one is a loud error — silently ignoring a corrupt baseline would let
    every grandfathered finding back through the gate as "new", or worse,
    mask a bad merge.
    """
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return set()
    if not isinstance(payload, dict) or payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: not a repro_torch.analysis baseline (want "
            f"{{'version': {BASELINE_VERSION}, 'findings': [...]}})")
    out = set()
    for entry in payload.get("findings", []):
        fp = entry.get("fingerprint")
        if not fp:
            raise ValueError(f"{path}: baseline entry without fingerprint: "
                             f"{entry!r}")
        out.add(fp)
    return out

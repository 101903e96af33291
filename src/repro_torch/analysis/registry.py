"""Rule registry: ``@rule`` decorator + lookup.

A rule is a callable ``(project: Project) -> Iterable[Finding]``. Modules
register themselves at import time; :mod:`repro_torch.analysis.__init__` imports
every shipped rule module so ``RULES`` is complete after
``import repro_torch.analysis``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch.analysis.context import Project
from repro_torch.analysis.findings import Finding


@dataclass(frozen=True)
class Rule:
    id: str
    doc: str  # one-line summary of what the rule holds
    check: Callable[[Project], Iterable[Finding]]


RULES: dict[str, Rule] = {}


def rule(rule_id: str, doc: str):
    """Register ``fn`` as the checker for ``rule_id``."""

    def deco(fn: Callable[[Project], Iterable[Finding]]):
        if rule_id in RULES:
            raise RuntimeError(f"duplicate analysis rule id: {rule_id}")
        RULES[rule_id] = Rule(id=rule_id, doc=doc, check=fn)
        return fn

    return deco


def all_rule_ids() -> list[str]:
    return sorted(RULES)

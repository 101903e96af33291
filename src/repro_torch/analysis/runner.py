"""Run selected rules over a tree and split findings by disposition."""
from __future__ import annotations

from pathlib import Path

from repro_torch.analysis.context import Project
from repro_torch.analysis.findings import Finding, Report, load_baseline
from repro_torch.analysis.registry import RULES


def run_analysis(root: Path | str,
                 rules: list[str] | None = None,
                 baseline_path: Path | str | None = None) -> Report:
    """Scan ``root`` with ``rules`` (default: all registered).

    Every finding lands in exactly one bucket: ``new`` (fails the gate),
    ``suppressed`` (inline ``# repro: allow[...]``), or ``baselined``
    (fingerprint present in the committed baseline). Unparseable files are
    themselves findings — a tree the analyzer cannot read must not pass
    the analyzer's gate.
    """
    root = Path(root)
    selected = sorted(RULES) if rules is None else list(rules)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise KeyError(f"unknown analysis rule(s): {unknown}; "
                       f"known: {sorted(RULES)}")

    project = Project(root)
    baseline = (load_baseline(baseline_path)
                if baseline_path is not None else set())

    report = Report(root=str(root), rules=selected)
    for rel, err in project.parse_errors:
        report.new.append(Finding(
            rule="parse", code="parse.syntax-error", path=rel, line=1,
            message=f"file does not parse: {err}",
            hint="fix the syntax error", snippet=""))

    for rule_id in selected:
        for finding in RULES[rule_id].check(project):
            mod = project.module(finding.path)
            if mod is not None and mod.allowed(
                    finding.line, finding.rule, finding.code):
                report.suppressed.append(finding)
            elif finding.fingerprint in baseline:
                report.baselined.append(finding)
            else:
                report.new.append(finding)

    by_rule: dict[str, int] = {}
    for f in report.new + report.suppressed + report.baselined:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    report.stats = {
        "modules": len(project.modules),
        "parse_errors": len(project.parse_errors),
        "findings_by_rule": by_rule,
    }
    return report

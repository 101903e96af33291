"""CLI for the port's contract linter: ``python -m repro_torch.analysis``.

Exit status is the gate: 0 when no *new* findings (suppressed and
baselined ones are reported but pass), 1 otherwise. ``--json`` writes the
report as an artifact. The port keeps no baseline: every finding is either
repaired or carries an inline allow with its reason, so ``--baseline`` has
no default (a file given there is read as the reference's is, and never
written: the port's linter has no option that writes a baseline).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.context import default_root
from repro_torch.analysis.registry import all_rule_ids
from repro_torch.analysis.runner import run_analysis

EPILOG = """\
suppression:
  inline   # repro: allow[RULE] <why>      on the flagged line or the line
           above; RULE is a rule id (taxonomy), a sub-check code
           (taxonomy.broad-except), a comma list, or *.
  baseline --baseline PATH                 fingerprints of grandfathered
           findings (content-hashed: rule|path|normalized line, so line
           drift does not resurrect them); none by default, and
           the port's linter only reads it.

exit status: 0 = no new findings, 1 = new findings (or baseline drift).
"""


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static contract linter for the PyTorch port: "
                    "jit-boundary (kernel wrappers: no try, no unexplained "
                    "host wait, no silent fallback), telemetry-key, taxonomy, "
                    "span, and env discipline.",
        epilog=EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--root", type=Path, default=None,
        help="package tree to scan (default: the repro_torch package)")
    parser.add_argument(
        "--rules", nargs="+", metavar="RULE", default=None,
        help=f"subset of rules to run (default: all of {all_rule_ids()})")
    parser.add_argument(
        "--json", type=Path, metavar="PATH", default=None,
        help="write the full report as JSON to PATH (CI artifact)")
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="baseline file of grandfathered fingerprints (default: none; "
             "a missing file = empty baseline)")
    args = parser.parse_args(argv)

    root = args.root if args.root is not None else default_root()
    report = run_analysis(root, rules=args.rules, baseline_path=args.baseline)

    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(report.to_dict(), fh, indent=2)
            fh.write("\n")

    for finding in report.new:
        print(finding.render())
    for finding in report.suppressed:
        print(f"{finding.path}:{finding.line}: [{finding.code}] suppressed "
              f"(inline allow)")
    for finding in report.baselined:
        print(f"{finding.path}:{finding.line}: [{finding.code}] baselined")

    counts = (f"{len(report.new)} new, {len(report.suppressed)} suppressed, "
              f"{len(report.baselined)} baselined")
    mods = report.stats.get("modules", 0)
    if report.ok:
        print(f"repro_torch.analysis: OK — {mods} modules, {counts}")
        return 0
    print(f"repro_torch.analysis: FAIL — {mods} modules, {counts}",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())

"""The reference's contract linter (``repro.analysis``) over the port.

``src/repro_torch`` mirrors ``src/repro`` path for path, so the linter reads
the port's own registries (``obs/trace.SPAN_NAMES``,
``core/telemetry.KEY_FAMILIES``, ``runtime/validate``'s taxonomy) and holds
every module to them, ``serve/`` included. The port keeps no baseline file:
every finding either is fixed or carries an inline ``# repro: allow[...]``
that names a documented difference.
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import all_rule_ids, run_analysis

PORT_ROOT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# the port's inline suppressions: the reference's own (a tracing failure
# degrades silently) and STAGE_COUNTS, registered under the family "trace"
# in the place of TRACE_COUNTS (eager torch never retraces)
SUPPRESSED = {("obs/trace.py", "taxonomy.broad-except"),
              ("core/spgemm.py", "telemetry-key.unknown-family")}


@pytest.mark.parametrize("rule", all_rule_ids())
def test_port_has_no_new_findings(rule):
    report = run_analysis(PORT_ROOT, rules=[rule])
    assert report.ok, "\n".join(f.render() for f in report.new)
    assert not report.baselined


def test_port_suppressions_are_the_documented_ones():
    report = run_analysis(PORT_ROOT)
    assert report.ok, "\n".join(f.render() for f in report.new)
    assert {(f.path, f.code) for f in report.suppressed} == SUPPRESSED


def test_port_scan_covers_every_module_serve_included():
    report = run_analysis(PORT_ROOT)
    modules = sorted(p.relative_to(PORT_ROOT).as_posix() for p in PORT_ROOT.rglob("*.py"))
    assert report.stats["modules"] == len(modules)
    assert report.stats["parse_errors"] == 0
    assert {"serve/spgemm_service.py", "serve/breaker.py", "serve/warmer.py",
            "runtime/ladder.py"} <= set(modules)


def test_cli_passes_on_the_port():
    env = {"PYTHONPATH": str(PORT_ROOT.parent), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro.analysis", "--root", str(PORT_ROOT)],
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new" in out.stdout

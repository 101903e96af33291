"""The contract linter over the port: the reference's (``repro.analysis``)
and the port's own (``repro_torch.analysis``).

``src/repro_torch`` mirrors ``src/repro`` path for path, so both linters read
the port's own registries (``obs/trace.SPAN_NAMES``,
``core/telemetry.KEY_FAMILIES``, ``runtime/validate``'s taxonomy) and hold
every module to them, ``serve/`` included. The port keeps no baseline file:
every finding either is fixed or carries an inline ``# repro: allow[...]``
that names a documented difference.

Only the port's linter reads kernel launches: its ``jit-boundary`` holds the
kernel wrappers of ``kernels/`` (functions that reach ``_build.launch`` or
``_build.load``) and their same-module helpers to no try, no host wait
without a reason, and no silent fallback around a launch, and its ``env``
knows torch's device queries. On the reference's own tree it gives the
reference's report, finding for finding.
"""
import ast
import importlib
import json
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

from torch_import_guard import ROOT, run_guarded

PORT_ROOT = ROOT / "src" / "repro_torch"
REF_ROOT = ROOT / "src" / "repro"
REF_BASELINE = ROOT / "analysis" / "baseline.json"

LINTERS = ("repro.analysis", "repro_torch.analysis")
RULE_IDS = ("env", "jit-boundary", "span", "taxonomy", "telemetry-key")

# the reference's inline suppressions, which the port keeps (a tracing
# failure degrades silently; the dry run's survey records a failing cell and
# goes on), and STAGE_COUNTS, registered under the family "trace" in the
# place of TRACE_COUNTS (eager torch never retraces)
_SHARED = {("obs/trace.py", "taxonomy.broad-except"): 1,
           ("launch/dryrun.py", "taxonomy.broad-except"): 1,
           ("core/spgemm.py", "telemetry-key.unknown-family"): 1}
# what each linter reports as suppressed on the port: the port's linter also
# sees K3's documented host waits (ROADMAP Queue 1 item 6 (c)): the class
# starts, the device-memory allotment, the count of lost rows, and the
# column bound's two reads where no k is given
SUPPRESSED = {
    "repro.analysis": Counter(_SHARED),
    "repro_torch.analysis": Counter({**_SHARED,
                                     ("kernels/spgemm_lp.py", "jit-boundary.host-sync"): 5}),
}

# the seven direct kernel launches of the port, by the function that makes them
LAUNCH_SITES = {("kernels/segsum_reuse.py", "launch_replay"),
                ("kernels/segsum_reuse.py", "launch_replay_batched"),
                ("kernels/spgemm_numeric.py", "launch_ell"),
                ("kernels/grouped_matmul.py", "grouped_matmul"),
                ("kernels/spgemm_symbolic.py", "_launch"),
                ("kernels/flash_attention.py", "flash_attention"),
                ("kernels/bsr_spgemm.py", "bsr_spgemm_numeric"),
                ("kernels/plan_columns.py", "plan_columns")}
# the K1/K2 replay path, which must stay free of host waits (CUDA-graph
# capture, ROADMAP Queue 1 item 6 (d))
REPLAY_PATH = {("kernels/segsum_reuse.py", name)
               for name in ("launch_replay", "launch_replay_batched", "run_batched",
                            "segsum_reuse_arrays", "segsum_reuse_batched_arrays")} | {
               ("kernels/spgemm_lp.py", name)
               for name in ("lp_reuse_arrays", "lp_reuse_batched_arrays")}


def linter(name: str):
    return importlib.import_module(name)


def finding_keys(findings) -> list:
    return sorted((f.code, f.path, f.line, f.fingerprint) for f in findings)


# --------------------------------------------------------------------------
# both linters over the port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rule", RULE_IDS)
@pytest.mark.parametrize("name", LINTERS)
def test_port_has_no_new_findings(name, rule):
    lint = linter(name)
    assert tuple(lint.all_rule_ids()) == RULE_IDS
    report = lint.run_analysis(PORT_ROOT, rules=[rule])
    assert report.ok, "\n".join(f.render() for f in report.new)
    assert not report.baselined


@pytest.mark.parametrize("name", LINTERS)
def test_port_suppressions_are_the_documented_ones(name):
    report = linter(name).run_analysis(PORT_ROOT)
    assert report.ok, "\n".join(f.render() for f in report.new)
    assert Counter((f.path, f.code) for f in report.suppressed) == SUPPRESSED[name]


@pytest.mark.parametrize("name", LINTERS)
def test_port_scan_covers_every_module_serve_included(name):
    report = linter(name).run_analysis(PORT_ROOT)
    modules = sorted(p.relative_to(PORT_ROOT).as_posix() for p in PORT_ROOT.rglob("*.py"))
    # the linter does not lint itself (its fixtures do)
    linted = [m for m in modules if not m.startswith("analysis/")]
    assert report.stats["modules"] == len(linted)
    assert report.stats["parse_errors"] == 0
    assert {"serve/spgemm_service.py", "serve/breaker.py", "serve/warmer.py",
            "runtime/ladder.py", "kernels/segsum_reuse.py"} <= set(linted)


@pytest.mark.parametrize("name", LINTERS)
def test_cli_passes_on_the_port(name):
    if name == "repro.analysis":
        env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
        out = subprocess.run([sys.executable, "-m", "repro.analysis", "--root", str(PORT_ROOT)],
                             capture_output=True, text=True, env=env)
    else:
        # the port's gate, where importing jax or repro raises: the default
        # root is src/repro_torch and there is no default baseline
        out = run_guarded("import runpy\nrunpy.run_module('repro_torch.analysis', "
                          "run_name='__main__', alter_sys=True)\n")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new" in out.stdout
    assert f"{name}: OK" in out.stdout


# --------------------------------------------------------------------------
# the port's linter over the reference's tree: the reference's report
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rule", [*RULE_IDS, None])
def test_port_linter_gives_the_reference_report_on_its_tree(rule):
    rules = None if rule is None else [rule]
    want = linter("repro.analysis").run_analysis(REF_ROOT, rules=rules,
                                                 baseline_path=REF_BASELINE)
    got = linter("repro_torch.analysis").run_analysis(REF_ROOT, rules=rules,
                                                      baseline_path=REF_BASELINE)
    for bucket in ("new", "suppressed", "baselined"):
        assert finding_keys(getattr(got, bucket)) == finding_keys(getattr(want, bucket)), bucket
    assert got.stats == want.stats
    assert got.rules == want.rules


def test_json_reports_agree_on_the_reference_tree(tmp_path):
    def sorted_report(path):
        payload = json.loads(path.read_text())
        for bucket in ("new", "suppressed", "baselined"):
            payload[bucket].sort(key=lambda f: (f["path"], f["line"], f["code"]))
        return payload

    reports = {}
    for name in LINTERS:
        cli = importlib.import_module(f"{name}.cli")
        out = tmp_path / f"{name}.json"
        rc = cli.main(["--root", str(REF_ROOT), "--baseline", str(REF_BASELINE),
                       "--json", str(out)])
        assert rc == 0
        reports[name] = sorted_report(out)
    assert reports["repro.analysis"] == reports["repro_torch.analysis"]
    assert reports["repro.analysis"]["counts"]["suppressed"] > 0


# the reference's own kinds of findings, in a jit/Pallas fixture tree: both
# linters must report them alike
JAX_TREE = {
    "mod.py": """
        import jax
        import numpy as np


        def helper(x):
            return np.asarray(x)


        def f(x):
            return helper(x) + float(x[0])


        g = jax.jit(f)


        @jax.jit
        def h(x):
            try:
                return x.item()
            except Exception:
                return x


        def run_cell(cell):
            return cell.lower().compile()


        def survey(cells):
            out = []
            for c in cells:
                try:
                    out.append(run_cell(c))
                except Exception:
                    pass
            return out
    """,
    "dev.py": """
        import os

        import jax

        N = jax.device_count()
        os.environ["X"] = "1"
        MODE = os.environ.get("MODE")
        # repro: allow[env.import-time-device-work] fixture-sanctioned
        D = jax.devices()
    """,
}


def test_both_linters_agree_on_a_jit_fixture(tmp_path):
    root = make_tree(tmp_path, JAX_TREE)
    reports = {name: linter(name).run_analysis(root) for name in LINTERS}
    ref, port = reports["repro.analysis"], reports["repro_torch.analysis"]
    for bucket in ("new", "suppressed", "baselined"):
        assert finding_keys(getattr(port, bucket)) == finding_keys(getattr(ref, bucket))
        # and the same words: the same --json report
        assert sorted(json.dumps(f.to_dict()) for f in getattr(port, bucket)) == \
            sorted(json.dumps(f.to_dict()) for f in getattr(ref, bucket))
    assert Counter(f.code for f in ref.new) == Counter({
        "jit-boundary.host-sync": 3, "jit-boundary.try-in-traced": 1,
        "jit-boundary.silent-catch": 1, "taxonomy.broad-except": 2,
        "env.import-time-device-work": 1, "env.import-time-mutation": 1,
        "env.unsanctioned-read": 1})


# --------------------------------------------------------------------------
# the port's checks of kernel launches, on fixture trees
# --------------------------------------------------------------------------

# a fixture tree's registries, and a _build whose launch and load stand in
# for the port's
BASE = {
    "core/telemetry.py": """
        from collections import Counter

        KEY_FAMILIES = {"fallback": ("fault:{}->{}",)}
        FALLBACK_COUNTS = Counter()


        def reset_fallback_counts():
            FALLBACK_COUNTS.clear()


        ALL_COUNTERS = {"fallback": FALLBACK_COUNTS}
        _RESETS = (reset_fallback_counts,)
    """,
    "obs/trace.py": """
        SPAN_NAMES = frozenset({"numeric.kernel"})


        def span(name, **attrs):
            return None
    """,
    "runtime/validate.py": """
        class SpgemmError(Exception):
            pass


        class KernelFallbackError(SpgemmError, RuntimeError):
            pass
    """,
    "kernels/__init__.py": "",
    "kernels/_build.py": """
        class KernelLaunchError(RuntimeError):
            pass


        def build(names=()):
            return {}


        def load(name):
            build((name,))


        def launch(name, argtypes, *args):
            load(name)
    """,
}


def make_tree(tmp_path: Path, files: dict) -> Path:
    root = tmp_path / "pkg"
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(content))
    return root


# case -> (files, rule, what the port's linter reports: code -> count)
TORCH_CASES = {
    "host-sync in a wrapper and its helper": ({
        "kernels/k.py": """
            import torch

            from pkg.kernels import _build


            def _offsets(counts):
                g_off = torch.cumsum(counts, 0)
                return g_off, int(g_off[-1])


            def k(x, scale: float):
                g_off, n = _offsets(x)
                lost = torch.zeros(1)
                _build.launch("k", [], x.data_ptr(), int(x.shape[0]), float(scale))
                if int(lost):
                    x.cpu()
                return x
        """}, "jit-boundary", {"jit-boundary.host-sync": 3}),
    "no host-sync in a plain version or code that launches nothing": ({
        "kernels/k.py": """
            import torch

            from pkg.kernels import _build


            def k_plain(x):
                return int(x.max()), x.tolist(), x.cpu()


            def k_ref(x):
                return float(x.sum())


            def count_rows(x):
                return int(x.sum())


            def k(x, scale: float, window: int | None = None):
                if x.device.type == "cpu":
                    return k_plain(x)
                _build.launch("k", [], int(x.numel()), int(x.shape[0]), float(scale),
                              int(window is not None), 0 if window is None else int(window))
                return x
        """}, "jit-boundary", {}),
    "host-sync of a parameter that may hold a tensor": ({
        "kernels/k.py": """
            from typing import Optional

            from pkg.kernels import _build


            def k(x, n_rows, scale: Optional[float] = None, causal: bool = False):
                _build.launch("k", [], x, int(causal), float(scale or 1.0))
                return x[:int(n_rows)]
        """}, "jit-boundary", {"jit-boundary.host-sync": 1}),
    "host-sync through a wrapper of another module": ({
        "kernels/a.py": """
            from pkg.kernels import _build


            def launch_a(x):
                _build.launch("a", [], x)
        """,
        "kernels/b.py": """
            from pkg.kernels import a
            from pkg.kernels.a import launch_a


            def run_b(x):
                launch_a(x)
                return x.item()


            def run_c(x):
                a.launch_a(x)
                return x.tolist()
        """}, "jit-boundary", {"jit-boundary.host-sync": 2}),
    "a try inside a wrapper": ({
        "kernels/k.py": """
            from pkg.kernels import _build


            def k(x):
                try:
                    _build.launch("k", [], x)
                except RuntimeError:
                    raise
                return x
        """}, "jit-boundary", {"jit-boundary.try-in-traced": 1}),
    "a silent fallback to the plain version": ({
        "kernels/k.py": """
            from pkg.kernels import _build


            def k_plain(x):
                return x


            def k(x):
                _build.launch("k", [], x)
                return x
        """,
        "core/dispatch.py": """
            from pkg.core.telemetry import FALLBACK_COUNTS
            from pkg.kernels import _build
            from pkg.kernels.k import k, k_plain


            def run(x):
                try:
                    return k(x)
                except _build.KernelLaunchError:
                    return k_plain(x)


            def run_any(x):
                try:
                    return k(x)
                except Exception:
                    return k_plain(x)


            def run_counted(x):
                try:
                    return k(x)
                except _build.KernelLaunchError:
                    FALLBACK_COUNTS["fault:k->plain"] += 1
                    return k_plain(x)


            def run_checked(x):
                try:
                    return k(x)
                except Exception as e:
                    if not isinstance(e, _build.KernelLaunchError):
                        raise
                    return k_plain(x)


            def warm():
                try:
                    _build.build(("k",))
                except Exception:
                    pass
        """}, "jit-boundary", {"jit-boundary.silent-catch": 5}),
    "a loud ladder around a launch": ({
        "kernels/k.py": """
            from pkg.kernels import _build


            def k_plain(x):
                return x


            def k(x):
                _build.launch("k", [], x)
                return x
        """,
        "runtime/ladder.py": """
            def walk(rungs, run):
                return run(rungs[0]), rungs[0]
        """,
        "core/dispatch.py": """
            from pkg.core.telemetry import FALLBACK_COUNTS
            from pkg.kernels import _build
            from pkg.kernels.k import k
            from pkg.runtime import ladder
            from pkg.runtime.validate import KernelFallbackError


            def run_typed(x):
                try:
                    return k(x)
                except Exception as e:
                    raise KernelFallbackError("k failed") from e


            def run_counted_typed(x):
                try:
                    return k(x)
                except _build.KernelLaunchError as e:
                    FALLBACK_COUNTS["fault:k->plain"] += 1
                    raise KernelFallbackError("k failed") from e


            def run_rungs(x):
                try:
                    return k(x)
                except _build.KernelLaunchError:
                    return ladder.walk(("k",), lambda rung: k(x))[0]
        """}, "jit-boundary", {}),
    "a device query and a kernel build at import": ({
        "kernels/k.py": """
            import torch

            from pkg.kernels import _build

            HAVE_CUDA = torch.cuda.is_available()
            _LIB = _build.load("k")
            N = torch.cuda.device_count() if HAVE_CUDA else 0
        """}, "env", {"env.import-time-device-work": 3}),
    "the same queries inside functions": ({
        "kernels/k.py": """
            import torch

            from pkg.kernels import _build


            def have_cuda():
                return torch.cuda.is_available()


            def lib():
                return _build.load("k")


            if __name__ == "__main__":
                print(torch.cuda.get_device_name(0))
        """}, "env", {}),
    "host-sync in compiled and captured code": ({
        "models/step.py": """
            import torch


            def step(x):
                return x.item()


            compiled = torch.compile(step)


            @torch.compile
            def fused(x):
                return x.tolist()


            def replay(x):
                return x.cpu()


            def capture(g, x):
                with torch.cuda.graph(g):
                    replay(x)
        """}, "jit-boundary", {"jit-boundary.host-sync": 3}),
}


@pytest.mark.parametrize("name", LINTERS)
@pytest.mark.parametrize("case", list(TORCH_CASES))
def test_torch_checks_on_fixtures(tmp_path, case, name):
    files, rule, port_codes = TORCH_CASES[case]
    report = linter(name).run_analysis(make_tree(tmp_path, {**BASE, **files}), rules=[rule])
    # the reference's linter sees no kernel launch and no torch device query
    want = port_codes if name == "repro_torch.analysis" else {}
    assert Counter(f.code for f in report.new) == Counter(want), \
        "\n".join(f.render() for f in report.new)


def test_host_sync_allow_covers_a_documented_wait(tmp_path):
    files = {"kernels/k.py": """
        import torch

        from pkg.kernels import _build


        def k(x):
            _build.launch("k", [], x)
            # repro: allow[jit-boundary.host-sync] Queue 1 item 6 (c): fixture wait
            return int(x.sum())
    """}
    report = linter("repro_torch.analysis").run_analysis(
        make_tree(tmp_path, {**BASE, **files}), rules=["jit-boundary"])
    assert report.ok
    assert [f.code for f in report.suppressed] == ["jit-boundary.host-sync"]


# --------------------------------------------------------------------------
# the port's traced set
# --------------------------------------------------------------------------


def port_project():
    from repro_torch.analysis.context import Project

    return Project(PORT_ROOT)


def direct_launch_sites(project) -> set:
    """(module, innermost function) of every ``_build.launch(...)`` call of
    kernels/."""
    out = set()

    def visit(node, rel, fn_name):
        if isinstance(node, ast.FunctionDef):
            fn_name = node.name
        if isinstance(node, ast.Call) and ast.unparse(node.func) == "_build.launch":
            out.add((rel, fn_name))
        for child in ast.iter_child_nodes(node):
            visit(child, rel, fn_name)

    for mod in project.modules:
        if mod.rel.startswith("kernels/") and mod.rel != "kernels/_build.py":
            visit(mod.tree, mod.rel, None)
    return out


def test_port_traced_set_holds_every_launch_and_the_replay_path():
    from repro_torch.analysis.rules_jit import is_plain_name, kernel_wrappers, \
        torch_traced_functions

    project = port_project()
    traced = {(rel, name) for rel, fns in torch_traced_functions(project).items()
              for name in fns}
    assert traced
    assert direct_launch_sites(project) == LAUNCH_SITES
    assert LAUNCH_SITES | REPLAY_PATH <= traced
    assert LAUNCH_SITES | REPLAY_PATH <= kernel_wrappers(project)
    assert {("kernels/spgemm_lp.py", "spgemm_lp"), ("kernels/spgemm_numeric.py", "spgemm_numeric"),
            ("kernels/spgemm_symbolic.py", "spgemm_symbolic")} <= traced
    # never the launcher, the dispatch layer, or a plain version or oracle
    assert not {rel for rel, _ in traced} & {"kernels/_build.py", "kernels/ops.py"}
    assert not [key for key in traced if is_plain_name(key[1])]
    assert {rel for rel, _ in traced} <= {m.rel for m in project.modules
                                          if m.rel.startswith("kernels/")}


def test_reference_dispatch_layer_is_untraced_too():
    from repro.analysis.context import Project
    from repro.analysis.rules_jit import traced_functions

    project = Project(REF_ROOT)
    assert traced_functions(project.module("kernels/ops.py")) == {}
    assert traced_functions(project.module("kernels/segsum_reuse.py"))
    # the reference's linter finds no traced function in the port at all
    assert not any(traced_functions(m) for m in Project(PORT_ROOT).modules)


def test_replay_path_has_no_host_sync_finding():
    from repro_torch.analysis.rules_jit import torch_traced_functions

    project = port_project()
    report = linter("repro_torch.analysis").run_analysis(PORT_ROOT, rules=["jit-boundary"])
    syncs = [f for f in report.new + report.suppressed if f.code.endswith("host-sync")]
    assert syncs  # K3's documented waits
    traced = torch_traced_functions(project)
    for rel, name in REPLAY_PATH:
        fn = traced[rel][name]
        inside = [f for f in syncs if f.path == rel
                  and fn.lineno <= f.line <= fn.end_lineno]
        assert not inside, (name, [f.render() for f in inside])


def test_every_port_host_sync_allow_names_its_roadmap_item():
    report = linter("repro_torch.analysis").run_analysis(PORT_ROOT, rules=["jit-boundary"])
    allowed = [f for f in report.suppressed if f.code == "jit-boundary.host-sync"]
    assert len(allowed) == SUPPRESSED["repro_torch.analysis"][
        ("kernels/spgemm_lp.py", "jit-boundary.host-sync")]
    lines = [line for path in PORT_ROOT.rglob("*.py")
             if not path.relative_to(PORT_ROOT).as_posix().startswith("analysis/")
             for line in path.read_text().splitlines()
             if "allow[jit-boundary.host-sync]" in line]
    assert len(lines) == 5  # the column bound's two reads share a statement
    for line in lines:
        assert "Queue 1 item 6 (c)" in line, line


def test_ladder_handler_is_loud():
    from repro_torch.analysis.rules_jit import _broad, _handler_is_loud, _index, \
        _launch_handler_is_loud

    project = port_project()
    ladder = project.module("runtime/ladder.py")
    walk = next(n for n in ast.walk(ladder.tree)
                if isinstance(n, ast.FunctionDef) and n.name == "walk")
    handlers = [h for t in ast.walk(walk) if isinstance(t, ast.Try) for h in t.handlers]
    assert len(handlers) == 1 and _broad(handlers[0])
    assert _handler_is_loud(handlers[0], project.taxonomy_classes())
    # and it would be loud around a launch too: it raises, and calls no plain version
    assert _launch_handler_is_loud(_index(project), "runtime/ladder.py", handlers[0])


def test_port_cli_writes_no_baseline(tmp_path, capsys):
    from repro_torch.analysis import cli

    baseline = tmp_path / "baseline.json"
    for option in ("--update-baseline", "--list-rules"):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--root", str(PORT_ROOT), "--baseline", str(baseline), option])
        assert exc.value.code == 2
    assert cli.main(["--root", str(PORT_ROOT), "--baseline", str(baseline)]) == 0
    assert not baseline.exists()
    assert "0 new" in capsys.readouterr().out

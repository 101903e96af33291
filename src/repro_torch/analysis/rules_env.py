"""Rule ``env`` — env-var discipline and import hygiene.

Configuration resolution is confined to two documented call sites
(``runtime/validate.resolve_mode`` and ``obs/trace.resolve_trace_mode``)
so "off means off" stays auditable: grep two functions and you have seen
every knob. And importing a module must never reconfigure the process —
no env mutation, no device enumeration — because import order is not a
contract anyone tests.

Sub-checks:

  * ``env.import-time-mutation`` — ``os.environ[...] = ...`` /
    ``setdefault`` / ``pop`` / ``update`` / ``os.putenv`` executed at
    module import time (outside any function; ``if __name__ == "__main__"``
    blocks are exempt — that's entrypoint code, not import code).
  * ``env.unsanctioned-read`` — ``os.environ[...]`` / ``.get`` /
    ``os.getenv`` outside the two sanctioned resolution functions.
  * ``env.import-time-device-work`` — ``jax.devices()`` /
    ``device_count`` / ``default_backend``, torch's device queries
    (``torch.cuda.is_available`` / ``device_count`` / ``current_device`` /
    ``get_device_properties`` / ``get_device_name`` / ``init`` /
    ``set_device``) or a kernel build (``_build.build`` / ``_build.load``)
    at import time (forces backend init, or runs ``nvcc``, as a side effect
    of ``import``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.asthelpers import dotted, enclosing_main_guard
from repro_torch.analysis.context import ModuleInfo, Project
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

RULE = "env"

# (module path, function name) pairs allowed to read os.environ
SANCTIONED_READS = frozenset({
    ("runtime/validate.py", "resolve_mode"),
    ("obs/trace.py", "resolve_trace_mode"),
})

_ENV_NAMES = {"os.environ", "environ"}
_MUTATING_METHODS = {"setdefault", "pop", "update", "clear"}
_DEVICE_CALLS = {"jax.devices", "jax.local_devices", "jax.device_count",
                 "jax.local_device_count", "jax.default_backend",
                 "torch.cuda.is_available", "torch.cuda.device_count",
                 "torch.cuda.current_device", "torch.cuda.get_device_properties",
                 "torch.cuda.get_device_name", "torch.cuda.init",
                 "torch.cuda.set_device", "_build.build", "_build.load"}


def _is_env(node: ast.expr) -> bool:
    return dotted(node) in _ENV_NAMES


def _function_lines(tree: ast.Module) -> set[int]:
    """Lines inside any function/lambda body (call-time, not import-time)."""
    lines: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            lines.update(
                range(node.lineno, (node.end_lineno or node.lineno) + 1))
    return lines


def _main_guard_lines(tree: ast.Module) -> set[int]:
    lines: set[int] = set()
    for node in tree.body:
        if isinstance(node, ast.If) and enclosing_main_guard(tree, node):
            lines.update(
                range(node.lineno, (node.end_lineno or node.lineno) + 1))
    return lines


def _env_mutations(mod: ModuleInfo):
    """Yield (lineno, description) for every env mutation in the module."""
    for sub in ast.walk(mod.tree):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Subscript) and _is_env(t.value):
                    yield sub.lineno, "os.environ[...] = ..."
        elif isinstance(sub, ast.Delete):
            for t in sub.targets:
                if isinstance(t, ast.Subscript) and _is_env(t.value):
                    yield sub.lineno, "del os.environ[...]"
        elif isinstance(sub, ast.Call):
            name = dotted(sub.func)
            if name == "os.putenv":
                yield sub.lineno, "os.putenv(...)"
            elif isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _MUTATING_METHODS \
                    and _is_env(sub.func.value):
                yield sub.lineno, f"os.environ.{sub.func.attr}(...)"


def _env_reads(mod: ModuleInfo):
    for sub in ast.walk(mod.tree):
        if isinstance(sub, ast.Subscript) and _is_env(sub.value) \
                and isinstance(sub.ctx, ast.Load):
            yield sub.lineno
        elif isinstance(sub, ast.Call):
            name = dotted(sub.func)
            if name == "os.getenv":
                yield sub.lineno
            elif isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "get" and _is_env(sub.func.value):
                yield sub.lineno


@rule(RULE, "env reads only at the two resolution points; clean imports")
def check(project: Project):
    for mod in project.modules:
        fn_lines = _function_lines(mod.tree)
        guard_lines = _main_guard_lines(mod.tree)
        import_time = lambda ln: ln not in fn_lines and ln not in guard_lines  # noqa: E731

        for lineno, what in _env_mutations(mod):
            if not import_time(lineno):
                continue
            yield Finding(
                rule=RULE, code=f"{RULE}.import-time-mutation",
                path=mod.rel, line=lineno,
                message=(f"{what} at module import time — importing this "
                         f"module reconfigures the process"),
                hint="move it into an explicit helper the entrypoint calls "
                     "(see launch/dryrun.force_host_devices)",
                snippet=mod.snippet(lineno))

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and dotted(node.func) in _DEVICE_CALLS \
                    and import_time(node.lineno):
                yield Finding(
                    rule=RULE, code=f"{RULE}.import-time-device-work",
                    path=mod.rel, line=node.lineno,
                    message=(f"{dotted(node.func)}() at import time forces "
                             f"backend init as an import side effect"),
                    hint="query devices lazily inside the function that "
                         "needs them",
                    snippet=mod.snippet(node.lineno))

        # --- env reads anywhere outside the sanctioned functions --------
        sanctioned = {fn for (path, fn) in SANCTIONED_READS
                      if path == mod.rel}
        allowed_lines: set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in sanctioned:
                allowed_lines.update(
                    range(node.lineno, (node.end_lineno or node.lineno) + 1))
        for lineno in _env_reads(mod):
            if lineno in allowed_lines:
                continue
            yield Finding(
                rule=RULE, code=f"{RULE}.unsanctioned-read",
                path=mod.rel, line=lineno,
                message=("os.environ read outside the two documented "
                         "resolution points"),
                hint="route the knob through runtime.validate.resolve_mode "
                     "or obs.trace.resolve_trace_mode",
                snippet=mod.snippet(lineno))

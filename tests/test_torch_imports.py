"""The port stands alone: every module of ``src/repro_torch`` imports in a
process where ``import jax`` and ``import repro`` raise."""

from torch_import_guard import REFUSED, ROOT, run_guarded

PORT_ROOT = ROOT / "src" / "repro_torch"

IMPORT_ALL = f"""
import importlib
import sys

names = sys.argv[1:]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
try:
    import jax  # noqa: F401
    refused = False
except ModuleNotFoundError:
    refused = True
print(len(names), leaked, refused)
"""


def port_modules() -> list[str]:
    names = []
    for path in sorted(PORT_ROOT.rglob("*.py")):
        parts = ("repro_torch",) + path.relative_to(PORT_ROOT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_every_port_module_imports_without_jax_or_the_reference():
    names = port_modules()
    assert len(names) > 90 and "repro_torch.analysis.rules_jit" in names
    out = run_guarded(IMPORT_ALL, *names)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert out.stdout.split("\n")[-2] == f"{len(names)} [] True"


def test_the_guard_refuses_the_reference():
    out = run_guarded("import repro.analysis")
    assert out.returncode != 0
    assert "import of repro refused" in out.stderr

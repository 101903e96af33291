"""Nothing the benchmark loads imports JAX or the JAX package ``repro``,
compared by whole top-level module names (``repro_torch`` begins with
``repro``), and the reference imports nothing of the program either."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

GUARD = """
import sys
FORBIDDEN = set(sys.argv[1].split(","))
class Guard:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"the benchmark imported {name}")
        return None
sys.meta_path.insert(0, Guard())
sys.path[:0] = [sys.argv[2], sys.argv[3]]
"""


def _python(body: str, forbidden=FORBIDDEN):
    code = GUARD + body
    return subprocess.run([sys.executable, "-c", code, ",".join(forbidden), str(HERE),
                           str(ROOT / "src")], capture_output=True, text=True, timeout=120)


def test_harness_inputs_metrics_and_program_import_no_jax():
    out = _python("""
from pathlib import Path
import pb_core, pb_trace, pb_system, pb_yardstick, control
import importlib.util
run = importlib.util.spec_from_file_location("pb_run", sys.argv[2] + "/run.py")
importlib.util.module_from_spec(run)
for sub in ("inputs", "metrics"):
    for f in sorted(Path(sys.argv[2], sub).glob("*.py")):
        pb_core.load_module(f, f"pb_{sub}_{f.stem}")
pb_system.PortSystem()  # the program's entry points
found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
assert not found, found
assert "repro_torch" in sys.modules
print("ok")
""")
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_reference_imports_nothing_of_the_program():
    out = _python("""
import importlib.util
spec = importlib.util.spec_from_file_location("r", sys.argv[2] + "/reference/spgemm.py")
mod = importlib.util.module_from_spec(spec); sys.modules["r"] = mod; spec.loader.exec_module(mod)
found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
assert not found, found
print("ok")
""", forbidden=FORBIDDEN + ("repro_torch",))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sources_name_no_forbidden_module():
    """The inputs, metrics and reference are the yardstick: no import of
    the program (the harness reaches it only through ``pb_system``)."""
    for sub in ("inputs", "metrics", "reference"):
        for f in sorted((HERE / sub).glob("*.py")):
            for node in ast.walk(ast.parse(f.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN + ("repro_torch",), (f, n)

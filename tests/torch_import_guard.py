"""Run code in a Python subprocess where ``import jax`` (or ``jaxlib``,
``flax``) and ``import repro`` raise, to show that the port
(``src/repro_torch``) imports neither JAX nor anything of the reference
package. The tests and ``chip_smoke.py`` both use this one guard."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFUSED = ("jax", "jaxlib", "flax", "repro")

GUARD = f"""
import sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {REFUSED!r}:
            raise ModuleNotFoundError(f"import of {{name}} refused: the port imports "
                                      f"no JAX and nothing of the reference", name=name)
        return None


sys.meta_path.insert(0, _Refuse())
"""


def run_guarded(code: str, *args: str, timeout: float = 300) -> subprocess.CompletedProcess:
    """``python -c GUARD + code *args`` from the repo root with
    ``PYTHONPATH=src``; returns the finished process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", GUARD + code, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)

"""The benchmark of the PyTorch/CUDA port ``repro_torch``: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``; the
harness is ``pb_core``. The last line of standard output is the result, one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit, which also close standard
error). The run needs a CUDA card and the program under ``src/``: without
either it exits non-zero and prints no result. It also fails if JAX or the
JAX package ``repro`` was loaded by the time the window closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, whole


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program is missing: no {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 5
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch

    from pb_core import Cell, Harness
    from pb_system import PortSystem

    cell = Cell.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = Harness(cell, PortSystem(), "cuda", T_START).run(args.seed, args.seconds,
                                                              bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

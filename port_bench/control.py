"""The control of the correctness check: the reference, computed in bfloat16
(the precision below the configurations' float32), put in the program's
place. Its readings must fail the limits in ``limits/<workload>.json``; the
benchmark's own runs never run it.

    python3 port_bench/control.py --workload <name> --seeds 11 12 13 --seconds 3

runs, on the CUDA card, the cell's set-up, a short window at the cell's own
load and the check once a seed, with ``ReferenceSystem`` as the system, and
prints one JSON line a seed: the numbers compared and whether the run came
out correct. Without a card it exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class ReferenceSystem:
    """The reference in ``dtype`` standing in for the program: the calls of
    ``pb_system.PortSystem``, each product by the reference of the
    operation ``spgemm``."""

    def __init__(self, dtype):
        from pb_core import reference

        self.ref, self.dtype = reference("spgemm"), dtype

    def set_trace_mode(self, mode: str) -> None:
        pass

    def release(self) -> None:
        pass

    def _mul(self, a, b):
        return self.ref.compute(a, b, dtype=self.dtype, with_scale=False)

    def pin(self, a, b, options):
        return a, b, self._mul(a, b)

    def structure(self, handle):
        c = handle[2]
        return c.indptr, c.indices

    def replay(self, handle, a_values, b_values):
        a, b, _ = handle
        if a_values.dim() > 1 or b_values.dim() > 1:  # a batch of value sets, one a row
            rows = (a_values if a_values.dim() > 1 else b_values).shape[0]

            def row(v, j):
                return v[j] if v.dim() > 1 else v

            return torch.stack([self.replay(handle, row(a_values, j), row(b_values, j))
                                for j in range(rows)])
        c = self._mul(dataclasses.replace(a, values=a_values),
                      dataclasses.replace(b, values=b_values))
        return c.values.float()

    def fresh(self, a, b, call, options):
        c = self._mul(a, b)
        return dataclasses.replace(c, values=c.values.float())

    @staticmethod
    def csr(answer):
        return answer.indptr, answer.indices, answer.values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]

    from pb_core import Cell, Harness

    cell = Cell.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the control of {args.workload} runs on {cell.chips} CUDA device(s); "
              "this machine has fewer", file=sys.stderr)
        return 3
    system = ReferenceSystem(torch.bfloat16)
    for seed in args.seeds:
        res = Harness(cell, system, "cuda", time.perf_counter()).run(
            seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16",
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

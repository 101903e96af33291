"""Multi-pod dry run: one meta run of every (arch x shape x mesh) cell (port
of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--multi-pod | --both-meshes] [--smoke] [--out FILE] [--ops-dir DIR]

It needs no card: each cell's args are meta DTensors on the production
mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) under PyTorch's fake
process group, this process being rank 0 of 256 (512); nothing is
allocated, sent or computed. That is the counterpart of the reference's
512 fake host devices. Run as a module entry point, ``main`` starts the
fake group (``init_fake_group``) for each mesh; importing this module
touches no process group, and a library caller who wants the mesh calls
``init_fake_group`` itself.

Per cell: one run of the cell's function under ``op_cost.count_ops`` gives
this rank's matmul flops (bf16 and f32), bytes, collectives and peak live
bytes; ``roofline.analyze`` turns them into the three terms, and one JSON
record is appended (``report`` renders them). The record keeps the
reference's keys. A field that means nothing in eager torch is ``None``:
``xla_flops_raw`` and ``xla_bytes_raw`` (no XLA cost analysis),
``lower_s`` and ``compile_s`` (nothing is lowered or compiled), and
``memory_analysis.generated_code_bytes``; the meta run's seconds are
``trace_s``. ``--ops-dir`` keeps each cell's op counts (``<arch>__<shape>__
<mesh>.ops.json``), from which ``reanalyze`` re-derives the roofline
columns without a rerun.
"""
import argparse
import json
import math
import os
import time
import traceback

from repro_torch.configs import SHAPES, all_cells, get_config, skip_reason
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.launch.op_cost import count_ops
from repro_torch.launch.roofline import analyze, mesh_name
from repro_torch.runtime.validate import SpgemmConfigError


def init_fake_group(n: int = 256) -> None:
    """Make this process rank 0 of a fake process group of ``n`` ranks
    (``torch.testing._internal.distributed.fake_pg``: collectives return at
    once, nothing is sent), replacing any fake group of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def check_per_rank(mesh) -> None:
    """Hold ``count_ops`` to one rank's share on ``mesh`` before a survey:
    a (64 x dp, 256) @ (256, 64 x tp) matmul, rows over the data axes and
    columns over 'model', must count its global flops over the ranks (a
    counter that saw the global op, or DTensor's shape propagation on
    global shapes, counts more)."""
    import torch

    from repro_torch.launch.mesh import dp_size, rules_for_mesh

    rules = rules_for_mesh(mesh)
    m, n = 64 * dp_size(mesh), 64 * rules.tp_size
    x = mesh.distribute(torch.empty(m, 256, device="meta"), (rules.dp, None))
    w = mesh.distribute(torch.empty(256, n, device="meta"), (None, rules.tp_axis))
    _, cost = count_ops(torch.matmul, x, w)
    ranks = math.prod(mesh.shape.values())
    if cost.flops != 2 * m * 256 * n / ranks:
        raise SpgemmConfigError(f"op_cost counted {cost.flops:.6e} flops of a sharded matmul on "
                           f"{mesh}, not one rank's {2 * m * 256 * n / ranks:.6e}")


def run_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
             verbose: bool = True, ops_dir: str | None = None) -> dict:
    cfg = get_config(arch, smoke=smoke)
    cell = build_cell(arch, shape_name, mesh, smoke=smoke)
    t0 = time.time()
    _, cost = count_ops(cell.call, *cell.args)
    trace_s = time.time() - t0
    if ops_dir:
        os.makedirs(ops_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name(mesh)}.ops.json"
        with open(os.path.join(ops_dir, fname), "w") as f:
            json.dump(cost.to_dict(), f)
    roof = analyze(cost, arch=arch, shape=SHAPES[shape_name], mesh=mesh, cfg=cfg)
    rec = roof.row()
    rec.update(
        lower_s=None, compile_s=None, trace_s=round(trace_s, 1), smoke=smoke, status="ok",
        memory_analysis={
            "argument_bytes": cost.argument_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": cost.temp_bytes,
            "generated_code_bytes": None,
        },
        coll_counts=dict(cost.collective_counts), ops_per_chip=cost.ops,
    )
    if verbose:
        print(f"--- {arch} x {shape_name} x {rec['mesh']} ({trace_s:.1f} s) ---")
        print("memory_analysis:", rec["memory_analysis"],
              f"peak {cost.peak_bytes / 2**30:.2f} GiB a rank")
        print("op counts: flops bf16=%.3e f32=%.3e bytes=%.3e ops=%d" % (
            cost.flops_bf16, cost.flops_f32, cost.bytes, cost.ops))
        print("collectives:", rec["coll_breakdown"])
        print("terms: compute=%.4fs memory=%.4fs collective=%.4fs dominant=%s"
              % (rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"],
                 rec["dominant"]))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--ops-dir", default=None,
                    help="save each cell's op counts (JSON) for reanalyze")
    args = ap.parse_args(argv)

    pods = [False, True] if args.both_meshes else [args.multi_pod]

    cells = list(all_cells())
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    n_ok = n_fail = 0
    with open(args.out, "a") as f:
        for multi_pod in pods:
            init_fake_group(math.prod(production_mesh_shape(multi_pod=multi_pod)[0]))
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            check_per_rank(mesh)
            for arch, shape in cells:
                reason = skip_reason(arch, shape)
                if reason:
                    print(f"SKIP {arch} x {shape}: {reason}")
                    continue
                try:
                    rec = run_cell(arch, shape, mesh, smoke=args.smoke, ops_dir=args.ops_dir)
                    n_ok += 1
                # a failing cell is recorded as a "fail" JSONL row + printed
                # traceback, and flips the exit code at the end: survey
                # semantics, run every cell and report all failures at once
                # repro: allow[jit-boundary,taxonomy] survey loop records and exits nonzero
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
                           "status": "fail", "error": repr(e)[:500]}
                    n_fail += 1
                f.write(json.dumps(rec) + "\n")
                f.flush()
    print(f"\nDRY-RUN: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

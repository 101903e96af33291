"""Render the dry-run and roofline tables from the dry run's JSONL records
(port of ``repro/launch/report.py``, plain Python as it is; it reads the
records of both packages).

    PYTHONPATH=src python -m repro_torch.launch.report --jsonl FILE \
        [--section roofline|dryrun|pick] [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict


def load(path: str):
    recs = {}
    for line in open(path):
        r = json.loads(line)
        key = (r["arch"], r["shape"], r["mesh"])
        recs[key] = r  # last write wins (re-runs overwrite)
    return list(recs.values())


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 1e9:.2f}"


def roofline_table(recs, mesh: str) -> str:
    rows = [r for r in recs if r["mesh"] == mesh and r.get("status") == "ok"]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | t_compute (s) | t_memory (s) | t_coll (s) | "
        "dominant | useful FLOPs ratio | HBM peak/chip (GB) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        ma = r.get("memory_analysis", {}) or {}
        peak = (ma.get("temp_bytes", 0) + ma.get("argument_bytes", 0)
                + ma.get("output_bytes", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{peak / 1e9:.1f} |"
        )
    return "\n".join(out)


def dryrun_table(recs) -> str:
    by_cell = defaultdict(dict)
    for r in recs:
        by_cell[(r["arch"], r["shape"])][r["mesh"]] = r
    out = [
        "| arch | shape | 16x16 | 2x16x16 | args/chip (GB) | temp/chip (GB) | "
        "collectives (GB/chip, 16x16) |",
        "|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), meshes in sorted(by_cell.items()):
        sp = meshes.get("16x16", {})
        mp = meshes.get("2x16x16", {})
        ma = sp.get("memory_analysis", {}) or {}
        coll = sp.get("coll_breakdown", {}) or {}
        brk = " ".join(
            f"{k}={v / 1e9:.1f}" for k, v in coll.items()
            if k not in ("total", "count") and v > 0
        )
        out.append(
            f"| {arch} | {shape} | "
            f"{'ok' if sp.get('status') == 'ok' else 'FAIL'} | "
            f"{'ok' if mp.get('status') == 'ok' else 'FAIL'} | "
            f"{fmt_bytes(ma.get('argument_bytes'))} | "
            f"{fmt_bytes(ma.get('temp_bytes'))} | {brk} |"
        )
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default="dryrun_results.jsonl")
    ap.add_argument("--section", choices=["roofline", "dryrun", "pick"],
                    default="roofline")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    recs = load(args.jsonl)
    if args.section == "roofline":
        print(roofline_table(recs, args.mesh))
    elif args.section == "dryrun":
        print(dryrun_table(recs))
    else:  # pick hillclimb candidates
        rows = [r for r in recs if r["mesh"] == "16x16"
                and r.get("status") == "ok"]
        rows.sort(key=lambda r: r["roofline_fraction"])
        print("worst roofline fraction:")
        for r in rows[:5]:
            print(f"  {r['arch']} x {r['shape']}: frac="
                  f"{r['roofline_fraction']:.3f} dominant={r['dominant']} "
                  f"terms=({r['t_compute_s']:.3f},{r['t_memory_s']:.3f},"
                  f"{r['t_collective_s']:.3f})")
        rows.sort(key=lambda r: -r["t_collective_s"])
        print("most collective-bound (absolute):")
        for r in rows[:5]:
            print(f"  {r['arch']} x {r['shape']}: t_coll="
                  f"{r['t_collective_s']:.3f} dominant={r['dominant']}")


if __name__ == "__main__":
    main()

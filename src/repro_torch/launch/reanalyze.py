"""Re-derive roofline records from saved op counts (no rerun; port of
``repro/launch/reanalyze.py``).

The dry run saves every cell's op counts (``--ops-dir``:
``<arch>__<shape>__<mesh>.ops.json``, ``op_cost.OpCost.to_dict``); when the
roofline model in ``roofline.py`` is refined, this tool regenerates the
roofline columns in place, keeping ``memory_analysis`` and the run's
seconds.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --jsonl FILE --ops-dir DIR
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import collective_bytes, model_flops_for, terms


def reanalyze(rec: dict, ops_dir: str) -> dict:
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.ops.json"
    path = os.path.join(ops_dir, fname)
    if not os.path.exists(path) or rec.get("status") != "ok":
        return rec
    with open(path) as f:
        cost = OpCost.from_dict(json.load(f))
    chips = 1
    for d in rec["mesh"].split("x"):
        chips *= int(d)
    cfg = get_config(rec["arch"], smoke=bool(rec.get("smoke")))
    mf = model_flops_for(cfg, SHAPES[rec["shape"]])
    t_c, t_m, t_l = terms(cost.flops_bf16, cost.flops_f32, cost.bytes, cost.link_bytes)
    bound = max(t_c, t_m, t_l)
    rec.update(
        hlo_flops_per_chip=cost.flops,
        hlo_bytes_per_chip=cost.bytes,
        model_flops=mf,
        t_compute_s=t_c,
        t_memory_s=t_m,
        t_collective_s=t_l,
        dominant=max(
            {"compute": t_c, "memory": t_m, "collective": t_l}.items(),
            key=lambda kv: kv[1],
        )[0],
        useful_flops_ratio=mf / max(chips * cost.flops, 1.0),
        roofline_fraction=(t_c / bound) if bound else 0.0,
        coll_breakdown=collective_bytes(cost),
        flops_bf16_per_chip=cost.flops_bf16,
        flops_f32_per_chip=cost.flops_f32,
        coll_link_bytes=dict(cost.link_bytes),
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default="dryrun_results.jsonl")
    ap.add_argument("--ops-dir", default="ops")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out_path = args.out or args.jsonl
    recs = {}
    with open(args.jsonl) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    with open(out_path + ".tmp", "w") as f:
        for key in sorted(recs):
            f.write(json.dumps(reanalyze(recs[key], args.ops_dir)) + "\n")
    os.replace(out_path + ".tmp", out_path)
    print(f"re-analyzed {len(recs)} records -> {out_path}")


if __name__ == "__main__":
    main()

"""The harness on the CPU at tiny sizes, through the port's CPU path: every
cell's loop agrees with the reference, and the check comes out false for the
control (the reference in bfloat16 in the program's place) and for each
fault a cell can have, planted in the timed path: a replay that returns its
last answer unchanged, an answer altered where it is produced, a structure
altered where it is produced. These runs skip the harness's look for a
card; everything else is the run the benchmark makes."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from control import ReferenceSystem
from pb_core import HERE, Cell, Harness
from pb_system import PortSystem

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("poisson2d-2048-sa.rap-reuse", "rmat-s15-ef16.aa-fresh", "rmat-s15-ef16.aa-reuse")
TINY = {"poisson2d-2048-sa": {"grid": [20, 23]}, "rmat-s15-ef16": {"scale": 8}}
SEED = 2**31 + 977  # above 32 signed bits, as a run's seed may be


def tiny_cell(workload: str) -> Cell:
    cell = Cell.load(ROOT, workload)
    cell.config.update(TINY[cell.config["name"]])
    return cell


def run(workload, system, trace=False, seconds=0.15):
    return Harness(tiny_cell(workload), system, "cpu").run(SEED, seconds, trace)


@pytest.mark.parametrize("workload", CELLS)
def test_loop_agrees_with_the_reference(workload):
    res = run(workload, PortSystem())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
    want = {m["name"] for m in tiny_cell(workload).end_to_end} - {"peak_mem_gib"}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_on_the_cpu_reads_no_device_metric(workload):
    res = run(workload, PortSystem(), trace=True)
    assert res["correct"]
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0
    # no device ran an operation here: device metrics stay silent
    assert not {"device_idle.reuse", "device_idle.fresh", "k1_roofline.reuse",
                "plan_build_ms.fresh", "replay_host_us.reuse"} & set(res["metrics"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_in_bfloat16_fails(workload):
    res = run(workload, ReferenceSystem(torch.bfloat16), seconds=0.05)
    assert not res["correct"]
    assert any(c["value"] is not None and c["value"] > c["limit"]
               for n, c in res["checks"].items() if n.endswith("value_err"))


class StaleReplay(PortSystem):
    """A replay that returns its state unchanged: the last answer again."""

    def __init__(self):
        super().__init__()
        self.last = {}

    def replay(self, handle, a_values, b_values):
        out = self.last.get(id(handle))
        if out is None:
            out = self.last[id(handle)] = super().replay(handle, a_values, b_values)
        return out


class AlteredAnswer(PortSystem):
    """One value of every answer altered where it is produced."""

    def replay(self, handle, a_values, b_values):
        out = super().replay(handle, a_values, b_values).clone()
        out[0] += 1.0
        return out

    def fresh(self, a, b, call, options):
        c = super().fresh(a, b, call, options)
        values = c.values.clone()
        values[0] += 1.0
        return dataclasses.replace(c, values=values)


class AlteredStructure(PortSystem):
    """One column index of every fresh C altered where it is produced."""

    def fresh(self, a, b, call, options):
        c = super().fresh(a, b, call, options)
        indices = c.indices.clone()
        indices[0] = (indices[0] + 1) % b.shape[1]
        return dataclasses.replace(c, indices=indices)


FAULTS = [(w, StaleReplay) for w in CELLS if "reuse" in w] + \
         [(w, AlteredAnswer) for w in CELLS] + [("rmat-s15-ef16.aa-fresh", AlteredStructure)]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_fault_makes_the_run_incorrect(workload, fault):
    res = run(workload, fault())
    assert not res["correct"]
    assert res["failed"] > 0


def test_inputs_are_made_from_the_seed():
    cell = tiny_cell("rmat-s15-ef16.aa-reuse")
    h = Harness(cell, PortSystem(), "cpu")
    a = [dataclasses.asdict(p) for p in cell.traffic.products]
    assert a == [{"name": "AA", "a": "A", "b": "A", "op": "spgemm", "call": None, "options": {}}]
    ops1, ops2 = h.inputs(SEED), h.inputs(SEED)
    assert torch.equal(ops1[0]["A"].values, ops2[0]["A"].values)
    assert not torch.equal(h.inputs(SEED + 1)[0]["A"].values, ops1[0]["A"].values)


# New mixes, each added as new files plus new entries of BENCHMARK.json, no
# existing file edited: a pinned backend (K2), batched replays, another entry
# of the port (the kernel pipeline's ELL answer), a fresh chain.
NEW_MIXES = {
    "rmat-s15-ef16.aa-lp": ("rmat-s15-ef16", "aa-lp", {
        "entry": "replay", "vary": ["A"], "value_sets": 4, "sync": "end",
        "products": [{"name": "AA", "a": "A", "b": "A", "op": "spgemm",
                      "options": {"backend": "pallas_lp"}}]}),
    "poisson2d-2048-sa.rap-batched": ("poisson2d-2048-sa", "rap-batched", {
        "entry": "replay", "vary": ["A"], "value_sets": 4, "batch": 2, "sync": "end",
        "products": [{"name": "AP", "a": "A", "b": "P"}, {"name": "RAP", "a": "R", "b": "AP"}]}),
    "rmat-s15-ef16.aa-ops": ("rmat-s15-ef16", "aa-ops", {
        "entry": "fresh", "structures": 2, "sync": "each",
        "products": [{"name": "AA", "a": "A", "b": "A", "op": "spgemm",
                      "call": "repro_torch.kernels.ops:pallas_spgemm"}]}),
    "poisson2d-2048-sa.rap-fresh": ("poisson2d-2048-sa", "rap-fresh", {
        "entry": "fresh", "sync": "each",
        "products": [{"name": n, "a": a, "b": b, "call": "repro_torch.core.spgemm:spgemm",
                      "options": {"plan_cache": False}}
                     for n, a, b in (("AP", "A", "P"), ("RAP", "R", "AP"))]}),
}


def checkout_with(tmp_path: Path, workload: str) -> Path:
    """A copy of the benchmark with the cell ``workload`` added as new files
    (its traffic mix and limits) and new entries of ``BENCHMARK.json``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    config, traffic, mix = NEW_MIXES[workload]
    (tmp_path / HERE.name / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    limits = {f"{p['name']}.{n}": {"limit": lim} for p in mix["products"]
              for n, lim in (("structure", 0), ("value_err", 1e-4))}
    (tmp_path / HERE.name / "limits" / f"{workload}.json").write_text(json.dumps(limits))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": workload, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a mix added by files alone"})
    e2e = "replay_ms" if mix["entry"] == "replay" else "multiply_ms"
    for m in bench["end_to_end"]:
        if m["name"] == e2e:
            m["workloads"].append(workload)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.mark.parametrize("workload", sorted(NEW_MIXES))
def test_a_new_mix_runs_from_new_files_only(tmp_path, workload):
    before = {f.relative_to(HERE): f.read_bytes() for f in HERE.rglob("*")
              if f.is_file() and "__pycache__" not in f.parts}
    root = checkout_with(tmp_path, workload)
    copied = {f.relative_to(root / HERE.name): f.read_bytes()
              for f in (root / HERE.name).rglob("*") if f.is_file()}
    assert all(copied[k] == v for k, v in before.items())  # no existing file edited
    assert len(copied) == len(before) + 2  # the mix and its limits
    cell = Cell.load(root, workload)
    cell.config.update(TINY[cell.config["name"]])
    res = Harness(cell, PortSystem(), "cpu").run(SEED, 0.15, False)
    assert res["correct"] and res["attempted"] > 0, res["checks"]
    e2e = "replay_ms" if cell.traffic.entry == "replay" else "multiply_ms"
    assert e2e in res["metrics"]
    control = Harness(cell, ReferenceSystem(torch.bfloat16), "cpu").run(SEED, 0.05, False)
    assert not control["correct"]

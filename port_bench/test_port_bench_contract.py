"""BENCHMARK.json against the benchmark's contract, and the harness's
behaviour where it must not run: every name and unit uses only the allowed
characters, every cell's files are found by name (so a new configuration,
traffic mix or metric is new files plus new entries), and ``run.py`` exits
non-zero, printing no result, without a card or without the program."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pb_core import HERE, Cell, load_module, reference

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"] and all(PATH.match(p) for p in BENCH["paths"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in entries:
        for k in TEXT_KEYS:
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k], e[k]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = Cell.load(ROOT, workload)
    assert hasattr(cell.generator, "operands") and hasattr(cell.generator, "value_sets")
    cfg = {c["name"]: c for c in BENCH["configs"]}[
        {w["name"]: w for w in BENCH["workloads"]}[workload]["config"]]
    assert cfg["file"].startswith("port_bench/") and cell.config["name"] == cfg["name"]
    assert cell.config["reduced"] == cfg["reduced"]
    assert cell.end_to_end and any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"pb_metric_{m['name']}")
        assert callable(reader.read)
        if m in cell.per_layer:  # each moves an end-to-end metric the cell reports
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for p in cell.traffic.products:
        op = reference(p.op)  # reference/<op>.py
        assert callable(op.compute) and callable(op.work)
        for name in ("structure", "value_err"):
            assert f"{p.name}.{name}" in cell.limits


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def _run(cwd: Path, workload: str):
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload", workload,
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_run_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the run without one")
    out = _run(ROOT, BENCH["workloads"][0]["name"])
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_exits_non_zero_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, BENCH["workloads"][0]["name"])
    assert out.returncode != 0 and out.stdout.strip() == ""

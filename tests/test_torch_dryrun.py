"""The port's dry run (``repro_torch.launch.cells``, ``dryrun``,
``reanalyze``, ``report``) against the reference's, and the meta-tensor
repair of the MoE routing it needs.

Two subprocesses run side by side, once for the file: the port's, rank 0
of PyTorch's fake process group of 8 on a 2 x 4 meta mesh (no other test
file on this worker sees a default group), builds every smoke cell of
``all_cells()`` and runs fourteen once (``run_cell``, op counts saved); the
reference's, with 8 forced host devices, builds the same cells on its
2 x 4 mesh and reads their args, specs and microbatch counts without
compiling. The cells must give the reference's arg shapes and dtypes,
specs and microbatch counts; the records must carry every key of the
reference's; ``reanalyze`` must give back the same roofline columns and
``report`` the reference's tables of the same records. A cell that fails
on the 16 x 16 mesh (the smoke MoE's 8 experts do not split over 16) is a
"fail" record and exit 1.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.launch import report as ref_report
from repro.launch.roofline import Roofline as RefRoofline
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import report

REPO = Path(__file__).resolve().parents[1]
DONATE = {"train": [0, 1], "prefill": [], "decode": [1]}

PORT = r"""
import json, sys, time
import torch
from repro_torch import _tree
from repro_torch.configs import all_cells
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import init_fake_group, run_cell
from repro_torch.launch.mesh import make_test_mesh

out_path, ops_dir, jsonl = sys.argv[1:4]
# run once: every decode cell and two steps (the smoke widths at the full
# lengths: a prefill's blockwise loops take most of a minute here)
RUN = {("gemma2-9b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k")}
init_fake_group(8)
mesh = make_test_mesh((2, 4), device="meta")
out = {}
with open(jsonl, "w") as f:
    for arch, shape in all_cells():
        cell = build_cell(arch, shape, mesh, smoke=True)
        leaves = [x for x in _tree.leaves(cell.args) if isinstance(x, torch.Tensor)]
        specs = cell.arg_specs()
        placed = [tuple(x.placements) == mesh.placements(s)
                  for x, s in zip(_tree.leaves(cell.args), specs) if hasattr(x, "placements")]
        out[f"{arch}|{shape}"] = {
            "shapes": [[list(x.shape), str(x.dtype).replace("torch.", "")] for x in leaves],
            "specs": specs, "mb": cell.num_microbatches, "donate": list(cell.donate_argnums),
            "placed": all(placed), "position": cell.args[-1] if shape.startswith(("decode",
                                                                                "long")) else None}
        if shape in ("decode_32k", "long_500k") or (arch, shape) in RUN:
            t0 = time.time()
            rec = run_cell(arch, shape, mesh, smoke=True, verbose=False, ops_dir=ops_dir)
            out[f"{arch}|{shape}"]["run_s"] = time.time() - t0
            f.write(json.dumps(rec) + "\n")
json.dump(out, open(out_path, "w"))
"""

REFERENCE = r"""
import inspect, json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import all_cells
from repro.launch.cells import build_cell
from repro.launch.mesh import make_test_mesh

mesh = make_test_mesh((2, 4))
out = {}
for arch, shape in all_cells():
    cell = build_cell(arch, shape, mesh, smoke=True)
    shardings = jax.tree.leaves(cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    out[f"{arch}|{shape}"] = {
        "shapes": [[list(x.shape), str(x.dtype)] for x in jax.tree.leaves(cell.args)],
        "specs": [list(s.spec) for s in shardings],
        "mb": inspect.getclosurevars(cell.fn).nonlocals.get("num_microbatches", 1),
        "donate": list(cell.donate_argnums)}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's cells, reference's cells, the port's records path, ops dir)."""
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    port = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(PORT), str(root / "port.json"),
         str(root / "ops"), str(root / "records.jsonl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(root / "ref.json")],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, port_err = port.communicate(timeout=400)
        _, ref_err = ref.communicate(timeout=400)
    finally:
        for p in (port, ref):
            if p.poll() is None:
                p.kill()
    assert port.returncode == 0, port_err[-4000:]
    assert ref.returncode == 0, ref_err[-4000:]
    return (json.loads((root / "port.json").read_text()),
            json.loads((root / "ref.json").read_text()), root / "records.jsonl", root / "ops")


def _norm(spec) -> list:
    """A spec's entries as JSON gives them (tuples as lists, a one-axis
    tuple as its name), trailing replicated dims dropped."""
    out = [e[0] if isinstance(e, list) and len(e) == 1 else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def test_every_smoke_cell_has_the_references_args_specs_and_microbatches(runs):
    port, ref, _, _ = runs
    assert sorted(port) == sorted(ref)
    for key, want in ref.items():
        got = port[key]
        kind = key.split("|")[1].split("_")[0]
        kind = "decode" if kind == "long" else kind
        ref_shapes, ref_specs = want["shapes"], want["specs"]
        if kind == "decode":  # the reference traces the position, the port takes an int
            assert ref_shapes[-1] == [[], "int32"] and ref_specs[-1] == []
            ref_shapes, ref_specs = ref_shapes[:-1], ref_specs[:-1]
            assert got["position"] == SHAPES[key.split("|")[1]].seq_len - 1, key
        assert got["shapes"] == ref_shapes, key
        assert [_norm(s) for s in got["specs"][:len(ref_specs)]] == [
            _norm(s) for s in ref_specs], key
        assert got["mb"] == want["mb"], key
        assert got["donate"] == want["donate"] == DONATE[kind], key
        assert got["placed"], key


def test_microbatches_follow_the_references_rule(runs):
    port, _, _, _ = runs
    for key, got in port.items():
        arch, shape = key.split("|")
        if not shape.startswith("train"):
            continue
        cfg = get_config(arch, smoke=True)
        want = {"moe": 4, "ssm": 4}.get(cfg.family, 1)
        assert got["mb"] == (max(want, 2) if cfg.num_heads % 4 else want), key


def _records(path):
    return [json.loads(x) for x in Path(path).read_text().splitlines()]


def test_records_carry_every_key_of_the_references(runs):
    port, _, path, _ = runs
    row = RefRoofline(arch="a", shape="s", mesh="2x4", chips=8, hlo_flops=1.0, hlo_bytes=1.0,
                      coll_bytes_per_chip=0.0, coll_breakdown={}, bytes_per_chip_peak=0.0,
                      model_flops=1.0).row()
    want = set(row) | {"lower_s", "compile_s", "smoke", "status", "memory_analysis"}
    ma = {"argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes"}
    recs = _records(path)
    assert len(recs) == sum("run_s" in c for c in port.values()) == 14
    assert all(r["status"] == "ok" for r in recs)
    for r in recs:
        assert want <= set(r), sorted(want - set(r))
        assert set(r["memory_analysis"]) == ma
        # what means nothing in eager torch is None, never 0 or a guess
        assert r["xla_flops_raw"] is r["xla_bytes_raw"] is r["lower_s"] is r["compile_s"] is None
        assert r["memory_analysis"]["generated_code_bytes"] is None
        assert r["trace_s"] >= 0 and r["hlo_flops_per_chip"] > 0
        assert r["mesh"] == "2x4" and r["smoke"] is True


def test_reanalyze_round_trips(runs, tmp_path):
    from repro_torch.launch import reanalyze

    _, _, path, ops = runs
    out = tmp_path / "again.jsonl"
    reanalyze.main(["--jsonl", str(path), "--ops-dir", str(ops), "--out", str(out)])
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    before = {key(r): r for r in _records(path)}
    after = {key(r): r for r in _records(out)}
    assert before == after


def test_report_renders_the_references_tables(runs):
    _, _, path, _ = runs
    recs = report.load(str(path))
    assert report.roofline_table(recs, "2x4") == ref_report.roofline_table(recs, "2x4")
    assert report.dryrun_table(recs) == ref_report.dryrun_table(recs)
    assert report.roofline_table(recs, "2x4").count("\n") == 15  # header, rule, 14 rows


def test_a_failing_cell_is_a_fail_record_and_exit_1(tmp_path):
    """The smoke MoE's 8 experts do not split over the production mesh's 16
    'model' shards: its record says so and the survey exits 1."""
    out = tmp_path / "fail.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-moe-30b-a3b",
         "--shape", "decode_32k", "--smoke", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 1, res.stderr[-4000:]
    (rec,) = _records(out)
    assert rec["status"] == "fail" and rec["mesh"] == "16x16"
    assert "do not split" in rec["error"]
    assert "DRY-RUN: 0 ok, 1 failed" in res.stdout


# --------------------------------------------------------------------------
# the routing on meta tensors (the dry run's MoE cells)
# --------------------------------------------------------------------------


def test_routing_and_moe_layer_run_on_meta():
    """``routing_symbolic`` counts each expert's assignments with a
    scatter-add (``torch.bincount`` has no meta kernel), so the MoE block
    runs on meta tensors: shapes and dtypes as on the CPU."""
    import repro_torch.models as tm
    from repro_torch.models.moe import moe_layer, routing_symbolic

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    logits = torch.empty((24, cfg.num_experts), device="meta")
    w, ids, slot, keep = routing_symbolic(logits, cfg.experts_per_token, 8, cfg.num_experts)
    k = cfg.experts_per_token
    assert [x.shape for x in (w, ids, slot, keep)] == [(24, k)] * 4
    assert all(x.device.type == "meta" for x in (w, ids, slot, keep))
    assert keep.dtype == torch.bool and ids.dtype == torch.int64
    params = tm.param_specs(cfg, tm.NO_SHARDING, dtype=torch.bfloat16)
    p = params["blocks"][0]["moe"]
    p = {name: leaf[0] for name, leaf in p.items()}
    x = torch.empty((2, 12, cfg.d_model), dtype=torch.bfloat16, device="meta")
    y = moe_layer(p, x, cfg, tm.NO_SHARDING)
    assert y.shape == x.shape and y.dtype == x.dtype and y.device.type == "meta"


def test_routing_counts_are_the_bincount():
    """The scatter-add's counts give the slots ``torch.bincount`` gave: each
    expert's assignments numbered 0, 1, ... in stream order."""
    from repro_torch.models.moe import routing_symbolic

    g = torch.Generator().manual_seed(0)
    logits = torch.randn((64, 8), generator=g)
    _, ids, slot, _ = routing_symbolic(logits, 2, 1000, 8)
    flat_ids, flat_slot = ids.reshape(-1), slot.reshape(-1)
    for e in range(8):
        assert torch.equal(flat_slot[flat_ids == e],
                           torch.arange(int(torch.bincount(flat_ids, minlength=8)[e])))

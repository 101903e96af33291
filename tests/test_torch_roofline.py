"""The port's dry-run cost model (``repro_torch.launch.op_cost`` and
``roofline``) against closed forms, mirroring ``tests/test_roofline.py``.

The reference validates its HLO parser against XLA's ``cost_analysis`` and
against 2n^3 a matmul; XLA counts a ``scan`` body once, so its parser
multiplies loop bodies by their trip counts. Eager torch has no scan to
undercount: a Python loop runs every trip and each trip's ops are counted,
so the loop tests hold the count to the same closed forms the reference's
scan tests do.

The per-rank counts run under PyTorch's fake process group in ONE
subprocess (no other test file on this worker sees a default group): a
sharded matmul counts one rank's share, a K-split product its share and
one all-reduce, and the smoke llama forward at ``(1, 1)`` and at 2 x 4
counts its closed form and, on 2 x 4, each matmul's share.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch.roofline import model_flops_for as ref_model_flops_for
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.op_cost import OpCost, count_ops
from repro_torch.launch.roofline import (
    BF16_FLOPS_PER_S,
    F32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    NETWORK_BYTES_PER_S,
    NVLINK_BYTES_PER_S,
    Roofline,
    collective_bytes,
    lm_train_bound,
    model_flops_for,
)

REPO = Path(__file__).resolve().parents[1]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_chained_matmuls_count_8_2n3():
    n = 256

    def f(x):
        for _ in range(8):
            x = x @ x
        return x

    _, cost = count_ops(f, _meta(n, n))
    assert cost.flops == cost.flops_f32 == 8 * 2 * n ** 3
    assert cost.flops_bf16 == 0


def test_loop_counts_every_trip():
    """The reference's scan test: XLA counts the body once; an eager loop of
    a body function runs, and is counted, 8 times."""
    n = 256

    def body(c):
        return c @ c

    def f(x):
        for _ in range(8):
            x = body(x)
        return x

    _, cost = count_ops(f, _meta(n, n, dtype=torch.bfloat16))
    assert cost.flops == cost.flops_bf16 == 8 * 2 * n ** 3


def test_nested_loops_count_12_2n3():
    n = 128

    def f(x):
        for _ in range(4):
            for _ in range(3):
                x = x @ x
        return x

    _, cost = count_ops(f, _meta(n, n))
    assert cost.flops == 12 * 2 * n ** 3


def test_batched_einsum():
    q = k = _meta(2, 4, 128, 64)
    _, cost = count_ops(lambda q, k: torch.einsum("bhqd,bhkd->bhqk", q, k), q, k)
    assert cost.flops == 2 * 2 * 4 * 128 * 128 * 64


def test_peak_memory_of_an_allocation_chain():
    """x (n f32) -> a = 2x -> b = a + 1 (a freed after) -> b.sum(): a and b
    live together once; the argument is x, the output a 4-byte scalar."""
    n = 1000

    def f(x):
        a = x * 2
        b = a + 1
        del a
        return b.sum()

    _, cost = count_ops(f, _meta(n))
    assert cost.argument_bytes == 4 * n
    assert cost.output_bytes == 4
    assert cost.peak_bytes == 4 * n + 2 * 4 * n
    assert cost.temp_bytes == cost.peak_bytes - 4 * n - 4
    # views are free, materialising ops read and write once each
    _, cost = count_ops(lambda x: x.view(10, 100).t().contiguous(), _meta(n))
    assert cost.bytes == 2 * 4 * n and cost.ops == 3


def test_collective_bytes_is_the_references_dict():
    cost = OpCost(collectives={"all-gather": 64 * 128 * 4, "all-reduce": 16 * 128 * 4},
                  collective_counts={"all-gather": 1, "all-reduce": 2})
    got = collective_bytes(cost)
    assert got == {"all-gather": 64 * 128 * 4, "all-reduce": 16 * 128 * 4,
                   "total": 80 * 128 * 4, "count": 3}


def test_roofline_terms_at_the_h100_constants():
    """One second each: bf16 at 989 TFLOP/s, f32 at 67, HBM at 3.35 TB/s,
    NVLink at 450 GB/s and the network at 50 GB/s."""
    def roof(**kw):
        base = dict(arch="x", shape="train_4k", mesh="16x16", chips=256, hlo_flops=0.0,
                    hlo_bytes=0.0, coll_bytes_per_chip=0.0, coll_breakdown={},
                    bytes_per_chip_peak=0.0, model_flops=0.0)
        return Roofline(**{**base, **kw})

    r = roof(hlo_flops=BF16_FLOPS_PER_S, flops_bf16=BF16_FLOPS_PER_S,
             hlo_bytes=HBM_BYTES_PER_S, link_bytes={"network": NETWORK_BYTES_PER_S},
             model_flops=BF16_FLOPS_PER_S * 256)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert abs(r.useful_ratio - 1.0) < 1e-9
    assert abs(roof(flops_f32=F32_FLOPS_PER_S).t_compute - 1.0) < 1e-9
    assert abs(roof(link_bytes={"nvlink": NVLINK_BYTES_PER_S}).t_collective - 1.0) < 1e-9
    both = roof(flops_bf16=BF16_FLOPS_PER_S, flops_f32=F32_FLOPS_PER_S, hlo_bytes=1.0)
    assert abs(both.t_compute - 2.0) < 1e-9 and both.dominant == "compute"
    row = r.row()
    assert row["xla_flops_raw"] is None and row["xla_bytes_raw"] is None


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_for_is_the_references(arch, shape):
    assert model_flops_for(get_config(arch), SHAPES[shape]) == ref_model_flops_for(
        ref_config(arch), REF_SHAPES[shape])


def test_model_flops_kinds():
    cfg = get_config("llama3.2-1b")
    n = cfg.active_param_count()
    assert model_flops_for(cfg, SHAPES["train_4k"]) == 6 * n * 256 * 4096
    assert model_flops_for(cfg, SHAPES["decode_32k"]) == 2 * n * 128
    moe = get_config("qwen3-moe-235b-a22b")
    assert moe.active_param_count() < 0.15 * moe.param_count()


def test_lm_train_bound_closed_form():
    """llama3.2-1b at 8 x 1,024: 2 x tokens x (4 x blocks - repeats x d_ff x
    d + 3 x head) bf16 flops (forward, recompute and backward of the
    blocks, less the down projection of each repeat that the checkpoint's
    recompute skips; the tied head forward and backward)."""
    cfg = get_config("llama3.2-1b")
    b, t = 8, 1024
    tokens = b * t
    d, hd = cfg.d_model, cfg.resolved_head_dim
    head = cfg.vocab_size * d
    blocks = cfg.num_layers * (2 * d * hd * (cfg.num_heads + cfg.num_kv_heads)
                               + 3 * d * cfg.d_ff)
    skipped = cfg.num_layers * cfg.d_ff * d
    params = {"w": _meta(cfg.param_count())}
    _, _, parts = lm_train_bound(cfg, params, b, t)
    assert parts["bf16_tflop"] * 1e12 == pytest.approx(
        2 * tokens * (4 * blocks - skipped + 3 * head), rel=1e-12)


def test_lm_train_bound_matches_the_counted_step():
    """The smoke llama's step on meta (no mesh): the counted bf16 flops are
    the bound's exactly, and the f32 ones the attention's computed pairs
    (one full T x T block a layer, forward, recompute and backward: more
    than the live pairs)."""
    import repro_torch.models as tm
    from repro_torch.launch.roofline import lm_attention_flops
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    cfg = get_config("llama3.2-1b", smoke=True)
    b, t = 2, 32
    params = tm.param_specs(cfg, tm.NO_SHARDING, dtype=torch.float32)
    batch = {k: _meta(b, t, dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(cfg, tm.NO_SHARDING, AdamWConfig())
    _, cost = count_ops(step, params, adamw_init(params), batch)
    _, _, parts = lm_train_bound(cfg, params, b, t)
    assert cost.flops_bf16 == pytest.approx(parts["bf16_tflop"] * 1e12, rel=1e-12)
    block = 4 * b * cfg.num_heads * cfg.resolved_head_dim * t * t * cfg.num_layers
    assert cost.flops_f32 == 4 * block > 4 * lm_attention_flops(cfg, b, t)


# --------------------------------------------------------------------------
# per-rank counts under the fake process group, in one subprocess
# --------------------------------------------------------------------------

PER_RANK = r"""
import json, sys
import torch
from torch.distributed.tensor import Replicate
import repro_torch.models as tm
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.mesh import make_test_mesh, rules_for_mesh
from repro_torch.launch.op_cost import count_ops

out = {}


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def counts(fn, *args):
    _, c = count_ops(fn, *args)
    return {"flops": c.flops, "bf16": c.flops_bf16, "f32": c.flops_f32,
            "collectives": c.collectives, "counts": c.collective_counts,
            "links": c.link_bytes}


def llama(shape):
    init_fake_group(shape[0] * shape[1])
    mesh = make_test_mesh(shape, device="meta")
    rules = rules_for_mesh(mesh)
    cfg = get_config("llama3.2-1b", smoke=True)
    p = tm.place(tm.param_specs(cfg, rules, dtype=torch.bfloat16),
                 tm.param_shardings(cfg, rules), mesh)
    tok = mesh.distribute(meta(4, 32, dtype=torch.int32), ("data", None))

    def fwd(p, tok):
        with torch.no_grad():
            return tm.forward(p, {"tokens": tok}, cfg, rules, mesh=mesh, remat=False)[0]

    return counts(fwd, p, tok), mesh


out["llama_1x1"], _ = llama((1, 1))
out["llama_2x4"], mesh = llama((2, 4))
rep = [Replicate(), Replicate()]
x = mesh.distribute(meta(64, 256), ("data", None))
w = mesh.distribute(meta(256, 512), (None, "model"))
out["sharded"] = counts(torch.matmul, x, w)
out["replicated_x"] = counts(torch.matmul, mesh.distribute(meta(64, 256), (None, None)), w)
xk = mesh.distribute(meta(64, 256), (None, "model"))
wk = mesh.distribute(meta(256, 512), ("model", None))
out["k_split"] = counts(lambda a, b: (a @ b).redistribute(mesh.device_mesh, rep), xk, wk)
g = mesh.distribute(meta(16, 128), ("data", None))
out["gather"] = counts(lambda a: a.redistribute(mesh.device_mesh, rep), g)
a2a = mesh.distribute(meta(8, 64), ("model", None))
out["all_to_all"] = counts(
    lambda a: a.redistribute(mesh.device_mesh, mesh.placements((None, "model"))), a2a)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def per_rank(tmp_path_factory):
    path = tmp_path_factory.mktemp("per_rank") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(PER_RANK), str(path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(path.read_text())


def test_sharded_matmul_counts_an_eighth(per_rank):
    """x (64, 256) rows over 'data' (2) times w (256, 512) columns over
    'model' (4): one rank's product is an eighth, and nothing is sent."""
    got = per_rank["sharded"]
    assert got["flops"] == 2 * 64 * 256 * 512 / 8
    assert got["collectives"] == {}


def test_replicated_rows_count_a_quarter(per_rank):
    """x whole on every rank: each rank of a 'data' pair repeats its
    'model' quarter, counted as the reference's per-chip HLO counts it."""
    assert per_rank["replicated_x"]["flops"] == 2 * 64 * 256 * 512 / 4


def test_k_split_counts_a_quarter_and_one_reduction(per_rank):
    got = per_rank["k_split"]
    assert got["flops"] == 2 * 64 * 256 * 512 / 4
    assert got["collectives"] == {"all-reduce": 64 * 512 * 4}
    assert got["counts"] == {"all-reduce": 1}
    assert got["links"] == {"nvlink": 64 * 512 * 4, "network": 0.0}


def test_collective_bytes_by_kind(per_rank):
    """A Shard(0) -> Replicate over 'data' is one all-gather of the whole
    (16, 128) f32; Shard(0) -> Shard(1) over 'model' is one all-to-all of
    the local (2, 64) f32, as NCCL issues it (the CPU group's fallback is
    an all-gather and a chunk)."""
    assert per_rank["gather"]["collectives"] == {"all-gather": 16 * 128 * 4}
    assert per_rank["gather"]["counts"] == {"all-gather": 1}
    assert per_rank["all_to_all"]["collectives"] == {"all-to-all": 2 * 64 * 4}
    assert per_rank["all_to_all"]["counts"] == {"all-to-all": 1}


def test_one_forward_counts_its_share_on_each_mesh(per_rank):
    """The smoke llama forward (B 4, T 32, bf16 params): at (1, 1) its
    closed form, the bf16 matmuls of every weight a token multiplies and
    the f32 attention over the one T x T block a layer; on 2 x 4 an eighth
    of each (batch over 'data'; heads, FFN columns and vocab over 'model'),
    but the K/V projections, whose 2 KV heads do not split over 4, a half:
    each 'model' shard projects its batch rows' whole sequence."""
    from repro_torch.launch.roofline import lm_matmul_flops

    cfg = get_config("llama3.2-1b", smoke=True)
    b, t = 4, 32
    bf16 = lm_matmul_flops(cfg, b * t)
    kv = cfg.num_layers * 2 * (2 * b * t * cfg.d_model * cfg.num_kv_heads * cfg.resolved_head_dim)
    f32 = 4 * b * cfg.num_heads * cfg.resolved_head_dim * t * t * cfg.num_layers
    one, eight = per_rank["llama_1x1"], per_rank["llama_2x4"]
    assert (one["bf16"], one["f32"]) == (bf16, f32)
    assert (eight["bf16"], eight["f32"]) == ((bf16 - kv) / 8 + kv / 2, f32 / 8)
    assert one["collectives"] == {} and eight["collectives"]

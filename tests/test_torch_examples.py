"""The seven ``examples/torch_*.py`` against the reference library, on the CPU.

Each example exposes its scenes as functions on tensors; these tests call
them with ``device="cpu"`` and hold what they return against the JAX
package on the same operands (``repro.sparse.generators`` makes them; the
port's generators give the same arrays, checked first). Not against the
reference's examples themselves: two of them fail on this jax (``pl.load``
is gone), and their Pallas paths cannot run here. What holds, and at what
bar:

* quickstart: A*P's and R*A*P's structure and values bitwise the
  reference's ``spgemm``; the reuse replay and the fresh run bitwise theirs;
  CF, CMRF and the decision equal; ``pallas_spgemm``'s ``c_nnz``/``c_idx``
  bitwise the reference's structure and its values within rtol/atol 1e-4 of
  ``repro.kernels.ref.spgemm_numeric_ref`` (the reference's ELL tolerance).
* multigrid_reuse: A_coarse's nnz equal; a timestep's two replays bitwise
  the reference's ``ReuseExecutor.apply``.
* accumulator_crossover: ``choose_kernel`` and ``resolve_numeric_kernel``
  equal on both sides; step 4 bitwise ``repro.kernels.ref.spgemm_lp_ref``.
* serve_spgemm: every reply bitwise the reference's fresh
  ``spgemm(...).c.to_dense()``; scene 1's dispatches and group sizes the
  reference service's (backend "xla", whose replies are its fresh values);
  4 of 12 shed; the breaker opens after 2 and recovers onto "pallas"; no
  plan-cache miss after warming. Also under the card's routing rules
  (``runtime.ladder.kernels_only`` forced), where the open breaker routes to
  the other kernel.
* dist_multigrid: two structure hashes at setup and none over the steps;
  the merged sharded replay bitwise the reference's single-device replay.
* serve_lm (4 steps): greedy tokens held as tests/test_torch_serve_engine.py
  holds them, from numpy-drawn params: each the reference's argmax or
  within 2 x 0.03 of it (bf16 logits), and the reference's tokens up to
  the first near tie.
* train_lm (4 steps at 2 x 32): each loss within 1e-3 relative of the
  reference's step from the same params and batches (the bf16-activation
  loss bound of tests/test_torch_train.py); the example's ``main`` resumes
  from a checkpoint that the reference's ``repro.ckpt.save`` wrote.
* every example returns 0 with ``--device cpu`` and exits 2 when no card
  is visible and ``--device cpu`` is not given.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as jckpt
import repro.core as jcore
import repro.data as jdata
import repro.models as jm
from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import SparseService as JSparseService
from repro.serve import engine as jeng
from repro.sparse import CSR as JCSR
from repro.sparse import formats as jformats
from repro.sparse import generators as jgen
from repro.sparse.oracle import gustavson_ell_structure as j_gustavson_ell_structure
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_init as j_adamw_init
from repro.train import make_train_step as j_make_train_step
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import autotune, telemetry
from repro_torch.data import SyntheticLMDataset
from repro_torch.runtime import faults, ladder
from repro_torch.train import adamw_init

from torch_lm_common import np_params, to_jax, to_port

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "multigrid_reuse", "accumulator_crossover", "serve_spgemm",
            "dist_multigrid", "serve_lm", "train_lm")
LOGIT_TOL = 0.03  # tests/test_torch_serve_engine.py: bf16 logits, absolute
LOSS_RTOL = 1e-3  # tests/test_torch_train.py: a loss with bf16 activations
_MODULES: dict = {}


def example(name: str):
    """``examples/torch_<name>.py`` as a module (imported once)."""
    if name not in _MODULES:
        spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                      ROOT / "examples" / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[name] = mod
    return _MODULES[name]


@pytest.fixture(autouse=True)
def _reset_port_state():
    telemetry.reset_all()
    autotune.reset_tuner()
    faults.reset_failpoints()
    obs.reset_obs()
    yield
    faults.reset_failpoints()
    obs.reset_obs()


def np_of(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_same_csr(port, ref, values=True) -> None:
    """Structure (and values) bitwise; nnz_cap may differ only past the
    live prefix, so compare the live slots."""
    np.testing.assert_array_equal(np_of(port.indptr), np_of(ref.indptr))
    n = int(np_of(ref.indptr)[-1])
    np.testing.assert_array_equal(np_of(port.indices)[:n], np_of(ref.indices)[:n])
    if values:
        np.testing.assert_array_equal(np_of(port.values)[:n], np_of(ref.values)[:n])


def j_csr(t) -> JCSR:
    return JCSR(indptr=jnp.asarray(t.indptr.numpy()), indices=jnp.asarray(t.indices.numpy()),
                values=jnp.asarray(t.values.numpy()), shape=tuple(t.shape))


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------


def test_quickstart_matches_the_reference():
    qs = example("quickstart")
    r, a, p, ap, rap = qs.galerkin_products("cpu")
    jr, ja, jp = jgen.galerkin_triple(32, 32, agg_size=4)
    for got, want in ((r, jr), (a, ja), (p, jp)):
        assert_same_csr(got, want)
    jap = jcore.spgemm(ja, jp, method="sparse")
    jrap = jcore.spgemm(jr, jap.c)
    assert ap.stats["method"] == jap.stats["method"] == "sparse"
    assert rap.stats["method"] == jrap.stats["method"]
    assert_same_csr(ap.c, jap.c)
    assert_same_csr(rap.c, jrap.c)
    np.testing.assert_allclose(rap.c.to_dense().numpy(), qs.dense_rap(r, a, p),
                               rtol=1e-4, atol=1e-4)
    # 2. the reuse replay and the fresh run
    a2 = qs.new_values(a)
    ja2 = JCSR(ja.indptr, ja.indices, jnp.asarray(a2.values.numpy()), ja.shape)
    reused, fresh = qs.reuse_vs_fresh(a2, p, ap)
    want = np.asarray(jcore.numeric_reuse(jap.plan, ja2.values, jp.values))
    np.testing.assert_array_equal(reused.numpy()[:want.shape[0]], want)
    assert_same_csr(fresh.c, jcore.spgemm(ja2, jp).c)
    # 3. compression
    assert qs.compression(a) == tuple(jcore.compression_decision(ja, ja,
                                                                 jcore.compress_matrix(ja)))
    # 4. the kernel pipeline: the reference's structure and its ELL oracle
    (c_nnz, c_idx, c_val), kernel = qs.kernel_pipeline(a, p)
    assert kernel == jops.resolve_numeric_kernel(ja, jp) == "dense_acc"
    jc = jformats.csr_to_ell(jap.c, r_pad=c_idx.shape[1])
    np.testing.assert_array_equal(c_nnz.numpy(), np.asarray(jc.row_nnz))
    np.testing.assert_array_equal(c_idx.numpy(), np.asarray(jc.indices))
    ea, ep = jformats.csr_to_ell(ja), jformats.csr_to_ell(jp)
    want = jref.spgemm_numeric_ref(ea.indices, ea.values, ep.indices, ep.values, jc.indices,
                                   jc.row_nnz, jp.shape[1])
    np.testing.assert_allclose(c_val.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# multigrid_reuse
# --------------------------------------------------------------------------


def test_multigrid_reuse_matches_the_reference():
    mg = example("multigrid_reuse")
    r, a, p, ap, rap, ex_ap, ex_rap, _ = mg.setup("cpu")
    jr, ja, jp = jgen.galerkin_triple(96, 96, agg_size=4)
    jap = jcore.spgemm(ja, jp, method="sparse")
    jrap = jcore.spgemm(jr, jap.c, method="sparse")
    assert rap.stats["nnz_c"] == jrap.stats["nnz_c"]
    assert_same_csr(rap.c, jrap.c)
    vals = np.random.default_rng(0).standard_normal(a.nnz_cap).astype(np.float32)
    ap_vals, rap_vals = mg.timestep(ex_ap, ex_rap, r, p, torch.from_numpy(vals))
    jex_ap, jex_rap = jcore.ReuseExecutor(jap.plan), jcore.ReuseExecutor(jrap.plan)
    want_ap = jex_ap.apply(jnp.asarray(vals), jp.values)
    np.testing.assert_array_equal(ap_vals.numpy(), np.asarray(want_ap))
    np.testing.assert_array_equal(rap_vals.numpy(),
                                  np.asarray(jex_rap.apply(jr.values, want_ap)))


# --------------------------------------------------------------------------
# accumulator_crossover
# --------------------------------------------------------------------------


def test_accumulator_crossover_matches_the_reference():
    ac = example("accumulator_crossover")
    ops = ac.operands("cpu")
    seeds = {"modest rows": ((64, 64, 3.0, 1), (64, 64, 3.0, 2)),
             "flop-heavy rows": ((4, 32, 16.0, 3), (32, 64, 32.0, 4))}
    for label, (a, b) in ops.items():
        ja, jb = (jgen.random_csr(*s) for s in seeds[label])
        assert_same_csr(a, ja)
        assert_same_csr(b, jb)
        arf, pick, kernel = ac.crossover(a, b)
        fm = jcore.spgemm(ja, jb, method="sparse", plan_cache=jcore.PlanCache()).stats["fm"]
        assert arf == fm / ja.shape[0]
        assert pick == jcore.choose_kernel(ja, jb, {"fm": fm})
        assert kernel == jops.resolve_numeric_kernel(ja, jb)
    heavy_a, heavy_b = ops["flop-heavy rows"]
    got, want, _ = ac.spill(heavy_a, heavy_b)
    ea, eb = jformats.csr_to_ell(j_csr(heavy_a)), jformats.csr_to_ell(j_csr(heavy_b))
    c_idx, c_nnz = (jnp.asarray(x) for x in j_gustavson_ell_structure(j_csr(heavy_a),
                                                                      j_csr(heavy_b)))
    oracle = jref.spgemm_lp_ref(ea.indices, ea.values, ea.row_nnz, eb.indices, eb.values,
                                eb.row_nnz, c_idx, c_nnz, ac.L1_SIZE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    assert torch.equal(got, want)
    assert ac.spill_check(got, want, want.abs()) == (True, "bitwise == accumulator oracle")


# --------------------------------------------------------------------------
# serve_spgemm
# --------------------------------------------------------------------------


def _reference_scene_one():
    """The reference service's scene 1 through "xla": (dispatches, sorted
    group sizes, the dense replies, the fresh dense references)."""
    structures = [(jgen.random_csr(48, 32, 3.0, 1), jgen.random_csr(32, 40, 3.0, 2)),
                  (jgen.random_csr(24, 32, 2.0, 3), jgen.random_csr(32, 16, 2.0, 4))]
    refs = [np.asarray(jcore.spgemm(a, b, method="sparse").c.to_dense()) for a, b in structures]
    svc = JSparseService(backend="xla", max_queue=8, max_batch=4, breaker_threshold=2,
                         breaker_cooldown_s=5.0, clock=lambda: 0.0, sleep=lambda _: None)
    reqs = [svc.submit(*structures[i % 2]) for i in range(6)]
    svc.drain()
    return (svc.counters["group_dispatches"], sorted(r.group_size for r in reqs),
            [np.asarray(r.value.to_dense()) for r in reqs], refs)


@pytest.mark.parametrize("rules", ["cpu", "card"])
def test_serve_spgemm_scenes(rules, tmp_path, monkeypatch):
    """Every scene on the CPU; with ``rules="card"`` the card's routing
    (kernels only: the open breaker routes to "pallas_lp")."""
    if rules == "card":
        monkeypatch.setattr(ladder, "kernels_only", lambda device: True)
    sv = example("serve_spgemm")
    structures, refs, scales = sv.make_structures("cpu")
    dispatches, sizes, j_replies, j_refs = _reference_scene_one()
    for got, want in zip(refs, j_refs):
        np.testing.assert_array_equal(got.numpy(), want)
    clock = sv.Clock()
    svc = sv.make_service(clock)
    reqs = sv.scene_grouped(svc, structures, refs, scales)
    assert svc.counters["group_dispatches"] == dispatches == 4
    assert sorted(r.group_size for r in reqs) == sizes
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.value.to_dense().numpy(), j_refs[i % 2])
        np.testing.assert_array_equal(j_replies[i], j_refs[i % 2])
    burst, rejected = sv.scene_backpressure(svc, structures)
    assert (len(burst), len(rejected)) == (12, 4)
    infeasible, expired, fine = sv.scene_deadlines(svc, structures, clock)
    assert fine.ok and not infeasible.ok and not expired.ok
    window, probe, counts = sv.scene_breaker(svc, structures, refs, scales, clock)
    safe = "pallas_lp" if rules == "card" else "xla"
    assert [(r.backend, r.degraded) for r in window] == \
        [("pallas", True), ("pallas", True), (safe, False), (safe, False)]
    assert counts.get("pallas:open") == 1 and counts.get("pallas:short_circuit") == 2
    for r in window + [probe]:
        np.testing.assert_array_equal(r.value.to_dense().numpy(), j_refs[0])
    assert (probe.backend, probe.degraded) == ("pallas", False)
    assert svc._breakers["pallas"].state == "closed"
    stats, misses0, misses = sv.scene_warming(svc, structures)
    assert stats["built"] == 2 and misses == misses0
    spans, tids, hist, debug = sv.scene_tracing(svc, structures, str(tmp_path / "t.json"))
    assert spans and tids and hist.count >= 1 and (tmp_path / "t.json").exists()
    assert debug["flight_recorder"]["recorded"] >= 1


# --------------------------------------------------------------------------
# dist_multigrid
# --------------------------------------------------------------------------


def test_dist_multigrid_matches_the_reference():
    dm = example("dist_multigrid")
    mesh, r, a, p, ex_ap, ex_rap, _, hashes = dm.setup("cpu")
    assert hashes == 2 and mesh.shape["data"] == dm.SHARDS
    vals = torch.from_numpy(np.random.default_rng(0).standard_normal(a.nnz_cap)
                            .astype(np.float32))
    telemetry.reset_all()
    dm.timestep(ex_ap, ex_rap, r, p, vals)
    assert sum(telemetry.HASH_COUNTS.values()) == 0
    assert telemetry.STAGE_COUNTS["dist_replay"] == 2
    got = ex_ap.merge(ex_ap.apply(vals, p.values))
    _, ja, jp = jgen.galerkin_triple(96, 96, agg_size=4)
    jex = jcore.ReuseExecutor.from_matrices(ja, jp)
    want = jex.to_csr(jex.apply(jnp.asarray(vals.numpy()), jp.values))
    assert_same_csr(got, want)
    single, scale = dm.single_device(a, p, vals)
    n = int(got.indptr[-1])
    assert dm.sharded_matches(got.values[:n], single, scale)
    batch = torch.from_numpy(np.random.default_rng(1).standard_normal((3, a.nnz_cap))
                             .astype(np.float32))
    assert torch.equal(ex_ap.apply_batched(batch, p.values)[-1], ex_ap.apply(batch[-1], p.values))


# --------------------------------------------------------------------------
# serve_lm, train_lm
# --------------------------------------------------------------------------


@torch.no_grad()
def test_serve_lm_tokens_follow_the_reference():
    sl = example("serve_lm")
    arch, steps = "gemma2-9b", 4
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    params = np_params(tcfg, seed=0)
    prompts = sl.prompts_for(tcfg, 4, 16, "cpu")
    got = sl.generate(to_port(params), tcfg, prompts, steps).numpy()
    jp = to_jax(params)
    want = np.asarray(jeng.ServeEngine(jp, jcfg, max_len=16 + steps).generate(
        jnp.asarray(prompts.numpy()), steps))
    assert got.shape == want.shape == (4, steps)
    seq = np.concatenate([prompts.numpy(), got], axis=1)
    logits, _ = jax.jit(lambda p, x: jm.forward(p, {"tokens": x}, jcfg, jm.NO_SHARDING,
                                                remat=False))(jp, jnp.asarray(seq))
    ref = np.asarray(logits, np.float32)[:, 15:-1]  # the logits that predict each token
    chosen = np.take_along_axis(ref, got[..., None].astype(np.int64), -1)[..., 0]
    assert (chosen >= ref.max(-1) - 2 * LOGIT_TOL).all()
    margin = np.sort(ref, -1)[..., -1] - np.sort(ref, -1)[..., -2]
    first = np.argmax(np.concatenate([margin <= 2 * LOGIT_TOL, np.ones((4, 1), bool)], 1), 1)
    for row in range(4):  # up to the first near tie the tokens are the reference's
        np.testing.assert_array_equal(got[row, :first[row]], want[row, :first[row]])
    assert first.sum() > 0


def test_train_lm_matches_the_reference_and_resumes_its_checkpoint(tmp_path, capsys):
    tl = example("train_lm")
    steps, seq, batch = 4, 32, 2
    cfg = tl.CONFIG_100M
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
        "vocab_size", "head_dim", "tie_embeddings")})
    assert round(cfg.param_count() / 1e6, 1) == round(jcfg.param_count() / 1e6, 1) == 41.5
    params = np_params(cfg, seed=0)
    # the reference's four steps
    jdataset = jdata.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch)
    jstep = jax.jit(j_make_train_step(jcfg, jm.NO_SHARDING,
                                      JAdamWConfig(lr=1e-3, warmup_steps=50)))
    jp = to_jax(params)
    jopt = j_adamw_init(jp)
    want = []
    for s in range(steps):
        b = {k: jnp.asarray(v) for k, v in jdataset.get_batch(s).items()}
        jp, jopt, m = jstep(jp, jopt, b)
        want.append(float(m["loss"]))
    # the example's four steps from the same params
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                              device="cpu")
    for s in range(steps):
        np.testing.assert_array_equal(data.get_batch(s)["tokens"].numpy(),
                                      np.asarray(jdataset.get_batch(s)["tokens"]))
    tp = to_port(params)
    _, _, got = tl.train(cfg, tp, adamw_init(tp), data, 0, steps, log=lambda _: None)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    # resume from the reference's checkpoint at step 4
    del tp, params
    jckpt.save(str(tmp_path), steps, (jp, jopt))
    capsys.readouterr()
    assert tl.main(["--steps", str(steps + 1), "--seq", str(seq), "--batch", str(batch),
                    "--ckpt-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["params: 41.5M", f"resumed from step {steps}", "done"]


# --------------------------------------------------------------------------
# every example's main
# --------------------------------------------------------------------------

MAIN_ARGS = {"serve_lm": ["--steps", "4"]}


@pytest.mark.parametrize("name", [e for e in EXAMPLES if e != "train_lm"])
def test_example_main_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    """``--device cpu``: exit 0 and the reference's last line, "OK" (the
    train_lm example's main runs in the test above)."""
    monkeypatch.chdir(tmp_path)  # serve_spgemm writes its trace here
    assert example(name).main(MAIN_ARGS.get(name, []) + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].endswith("OK")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_exits_2_without_a_card(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        example(name).main([])
    assert e.value.code == 2
    assert "pass --device cpu" in capsys.readouterr().err

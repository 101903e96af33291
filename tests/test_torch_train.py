"""The LM substrate's training path (``repro_torch.train``) against the
reference's ``repro.train``.

Params are seeded numpy arrays (``torch_lm_common.np_params``) carried into
both packages. Bounds, each measured on the CPU and stated here:

* ``cross_entropy_loss``, ``global_norm`` and ``adamw_update`` in f32: within
  1e-6 of the reference's scale (max |reference|); with bf16 params the
  updated params within one bf16 ulp.
* Grads of every architecture's step loss, per leaf as a relative Frobenius
  distance: ``GRAD_RTOL_F32`` = 1e-5 with f32 activations (both packages'
  ``model.COMPUTE_DTYPE`` set to f32; worst seen 1.4e-6, mamba2), and
  ``GRAD_RTOL_BF16`` = 0.1 with the default bf16 activations (worst seen
  4.7e-2, the MoE archs; checked on one architecture a layer kind). A
  grad taken with ``remat=False`` on another batch is about 1 away and
  fails both.
* A step's update (params after minus before), per leaf, relative
  Frobenius: ``UPDATE_RTOL`` = 2e-3 in f32 (worst seen 5.4e-4, gemma2 and
  recurrentgemma: Adam divides grads near zero by their own size). The same
  step with weight decay dropped is 1.0e-2 away and fails it.

The reference's grads are computed once per architecture under ``jax.jit``
(a module-scoped fixture). The update writes params and moments in place
(the port's counterpart of the reference's donated buffers), so every test
that steps one state twice clones it first. The SSD's gradient stays finite
where the reference's goes NaN (ROADMAP Queue 3).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.models.model as jmm
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.train import optim as joptim
from repro.train import step as jstep
import repro_torch.models as tm
import repro_torch.models.model as tmm
from repro_torch import _tree, compat
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.mesh import rules_for_mesh
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.train import (AdamWConfig, OptState, adamw_init, adamw_update,
                               cross_entropy_loss, make_train_step, train_step,
                               zero1_shardings)
from repro_torch.train import optim as toptim
from repro_torch.train.step import loss_and_grads

from torch_lm_common import (assert_close, np_batch, np_params, one_rank_mesh, to_jax,
                             to_port)

B, T = 2, 16
GRAD_RTOL_F32 = 1e-5
GRAD_RTOL_BF16 = 0.1
UPDATE_RTOL = 2e-3
STEP_CFG = dict(lr=1e-3, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _activations(dtype: str):
    """Both packages' activation dtype (``model.COMPUTE_DTYPE``) set to
    ``dtype`` for the block."""
    old = jmm.COMPUTE_DTYPE, tmm.COMPUTE_DTYPE
    jmm.COMPUTE_DTYPE, tmm.COMPUTE_DTYPE = getattr(jnp, dtype), getattr(torch, dtype)
    try:
        yield
    finally:
        jmm.COMPUTE_DTYPE, tmm.COMPUTE_DTYPE = old


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _batch(cfg, seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    t = cfg.num_patches + 8 if cfg.frontend == "vision" else T
    batch = np_batch(cfg, rng, b, t)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return batch


def _ref_loss_fn(jcfg, remat=True):
    def loss(p, b):
        logits, _ = jm.forward(p, b, jcfg, jm.NO_SHARDING, remat=remat)
        return jstep.cross_entropy_loss(logits, b["labels"])
    return loss


def _rel_fro(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = np.linalg.norm(w)
    return float(np.linalg.norm(g - w) / n) if n else float(np.abs(g).max(initial=0.0))


def _port_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().numpy()


def _worst_grad(port_grads, ref_grads) -> tuple:
    """(worst relative Frobenius distance, its leaf path) over the leaves;
    a leaf whose reference grad is zero must be zero in the port too."""
    worst, where = 0.0, None
    for (path, g), j in zip(_tree.leaves_with_path(port_grads), jax.tree.leaves(ref_grads)):
        d = _rel_fro(_port_np(g), j)
        if d > worst:
            worst, where = d, "/".join(path)
    return worst, where


def _worst_update(before, port_after, ref_after) -> tuple:
    worst, where = 0.0, None
    for (path, p0), a, b in zip(_tree.leaves_with_path(before), _tree.leaves(port_after),
                                jax.tree.leaves(ref_after)):
        p0 = np.asarray(p0, np.float64)
        d = _rel_fro(_port_np(a) - p0, np.asarray(b, np.float64) - p0)
        if d > worst:
            worst, where = d, "/".join(path)
    return worst, where


# --------------------------------------------------------------------------
# loss, norm, AdamW
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_loss_matches_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 301)) * 4).astype(np.float32)
    labels = rng.integers(0, 301, (3, 7)).astype(np.int32)
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    want = float(jstep.cross_entropy_loss(jl, jnp.asarray(labels)))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    tlab = torch.from_numpy(labels)
    got = cross_entropy_loss(tl, tlab)
    assert got.dtype == torch.float32 and got.shape == ()
    assert tlab.dtype == torch.int32
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_global_norm_matches_reference():
    params = np_params(get_config("llama3.2-1b", smoke=True), seed=3)
    want = float(joptim.global_norm(to_jax(params)))
    got = toptim.global_norm(to_port(params))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * want
    # bf16 leaves: the reference's f32 sum is 1.5e-6 off the float64 one here
    # (reassociated), the port's 7e-9: each held to its own measure
    half = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
    exact = np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum() for x in jax.tree.leaves(half)))
    got = float(toptim.global_norm(to_port(half)))
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(got - float(joptim.global_norm(to_jax(half)))) <= 1e-5 * exact


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.abs(x.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 2.0 ** -133)


def _adamw_case(dtype: str, start: int, clip_fires: bool, seed: int = 5):
    """Numpy params (the llama smoke tree in ``dtype``), grads, moments and
    step: grads normal x 1 (norm far above the clip of 1) or x 1e-4 (below)."""
    cfg = get_config("llama3.2-1b", smoke=True)
    params = np_params(cfg, seed=seed)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
    rng = np.random.default_rng(seed + 1)
    draw = lambda s, scale: jax.tree.map(  # noqa: E731
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32), params)
    grads = draw(0, 1.0 if clip_fires else 1e-4)
    mu = draw(0, 1e-2)
    nu = jax.tree.map(lambda x: np.abs(x), draw(0, 1e-3))
    return params, grads, mu, nu, np.int32(start)


def _run_both(params, grads, mu, nu, step, opt_cfg, port_cfg=None):
    ref = joptim.adamw_update(to_jax(grads),
                              joptim.OptState(to_jax(mu), to_jax(nu), jnp.int32(step)),
                              to_jax(params), joptim.AdamWConfig(**opt_cfg))
    tp = to_port(params)
    state = OptState(to_port(mu), to_port(nu), torch.tensor(step, dtype=torch.int32))
    given = _tree.leaves(tp)
    port = adamw_update(to_port(grads), state, tp, AdamWConfig(**(port_cfg or opt_cfg)))
    assert [x is y for x, y in zip(_tree.leaves(port[0]), given)] == [True] * len(given)
    assert port[1] is state  # written in place
    return ref, port


@pytest.mark.parametrize("clip_fires", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("start", [0, 4, 40], ids=["step0", "warmup", "after_warmup"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, start, clip_fires):
    """Params, moments, step and metrics against the reference's update at
    step 0, in the warmup (10 steps) and after it, with the clip firing and
    not. f32 params within 1e-6 of each leaf's scale, bf16 params within one
    bf16 ulp; moments (f32 either way) within 1e-6."""
    opt_cfg = dict(lr=2e-3, warmup_steps=10, grad_clip=1.0)
    case = _adamw_case(dtype, start, clip_fires)
    (jp, js, jmet), (tp, ts, tmet) = _run_both(*case, opt_cfg)
    assert int(ts.step) == int(js.step) == start + 1 and ts.step.dtype == torch.int32
    assert (float(jmet["grad_norm"]) > 1.0) == clip_fires
    for name in ("grad_norm", "lr"):
        assert abs(float(tmet[name]) - float(jmet[name])) <= 1e-6 * abs(float(jmet[name]))
    for got, want in zip(_tree.leaves(tp), jax.tree.leaves(jp)):
        assert got.dtype == getattr(torch, dtype)
        if dtype == "float32":
            assert_close(got, want, 1e-6, "params")
        else:
            g, w = _port_np(got), np.asarray(want, np.float64)
            assert (np.abs(g - w) <= np.maximum(_bf16_ulp(g), _bf16_ulp(w))).all()
    for tree_t, tree_j in ((ts.mu, js.mu), (ts.nu, js.nu)):
        for got, want in zip(_tree.leaves(tree_t), jax.tree.leaves(tree_j)):
            assert got.dtype == torch.float32
            assert_close(got, want, 1e-6, "moments")


def test_adamw_decays_matrices_only_and_the_bound_sees_it():
    """With zero grads and moments the update is weight decay alone: 1-D
    leaves stay bit for bit, matrices shrink, both as the reference's. The
    same update with weight decay dropped fails the 1e-6 bound."""
    params, grads, mu, nu, _ = _adamw_case("float32", 0, False)
    zeros = jax.tree.map(np.zeros_like, grads)
    opt_cfg = dict(lr=1e-2, warmup_steps=1)
    (jp, _, _), (tp, _, _) = _run_both(params, zeros, zeros, zeros, np.int32(0), opt_cfg)
    for p0, got, want in zip(jax.tree.leaves(params), _tree.leaves(tp), jax.tree.leaves(jp)):
        assert_close(got, want, 1e-6, "decay")
        if p0.ndim >= 2:
            assert not np.array_equal(got.numpy(), p0)
        else:
            assert np.array_equal(got.numpy(), p0)
    (jp, _, _), (tp, _, _) = _run_both(params, grads, mu, nu, np.int32(3), opt_cfg,
                                       port_cfg=dict(opt_cfg, weight_decay=0.0))
    with pytest.raises(AssertionError):
        for got, want in zip(_tree.leaves(tp), jax.tree.leaves(jp)):
            assert_close(got, want, 1e-6, "no decay")


def test_adamw_init_is_f32_zeros_on_the_params_device():
    params = to_port(_adamw_case("bfloat16", 0, False)[0])
    state = adamw_init(params)
    assert state.step.dtype == torch.int32 and state.step.shape == () and int(state.step) == 0
    for p, m, v in zip(_tree.leaves(params), _tree.leaves(state.mu), _tree.leaves(state.nu)):
        for x in (m, v):
            assert x.dtype == torch.float32 and x.shape == p.shape and x.device == p.device
            assert not x.any()


@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")], ids=["data", "pod_data"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_shardings_match_reference(arch, dp_axes):
    """Entry for entry the reference's PartitionSpecs (as tuples), over every
    architecture's published param shardings."""
    mesh = {"data": 2, "model": 4} if dp_axes == ("data",) else {"pod": 2, "data": 4, "model": 4}
    dp_size = int(np.prod([mesh[a] for a in dp_axes]))
    kw = dict(dp_axes=dp_axes, tp_size=4, dp_size=dp_size)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jr, tr = jm.ShardingRules(**kw), tm.ShardingRules(**kw)
    want = joptim.zero1_shardings(jm.param_shardings(jcfg, jr), dp_axes, mesh,
                                  jm.param_specs(jcfg, jr))
    want = jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = zero1_shardings(tm.param_shardings(tcfg, tr), dp_axes, mesh, tm.param_specs(tcfg, tr))
    assert got == want
    assert any(any(s == (dp_axes if len(dp_axes) > 1 else dp_axes[0]) for s in spec)
               for spec in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)))


# --------------------------------------------------------------------------
# grads and steps of every architecture against the reference
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def arch_run(request):
    """Per architecture, with f32 activations: the reference's loss, grads
    and update (``adamw_update`` on those grads), under one ``jax.jit``; the
    port's grads and a ``train_step``."""
    arch = request.param
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    params = np_params(tcfg, seed=0)
    batch = _batch(tcfg, seed=1)
    def ref(p, b):
        loss, grads = jax.value_and_grad(_ref_loss_fn(jcfg))(p, b)
        return loss, grads, joptim.adamw_update(grads, joptim.adamw_init(p), p,
                                                joptim.AdamWConfig(**STEP_CFG))

    with _activations("float32"):
        jl, jg, ref_step = jax.jit(ref)(to_jax(params), to_jax(batch))
        tl, tg = loss_and_grads(to_port(params), _t(batch), tcfg, tm.NO_SHARDING)
        tp = to_port(params)
        given = _tree.leaves(tp)
        port_step = train_step(tp, adamw_init(tp), _t(batch), tcfg, tm.NO_SHARDING,
                               AdamWConfig(**STEP_CFG))
    return {"params": params, "ref": (float(jl), jg), "port": (float(tl), tg),
            "ref_step": ref_step, "port_step": port_step, "given": given}


@pytest.mark.parametrize("arch_run", ARCH_IDS, indirect=True)
def test_grads_match_reference_f32(arch_run):
    """Every leaf's grad, remat'd repeats and all, within GRAD_RTOL_F32."""
    (jl, jg), (tl, tg) = arch_run["ref"], arch_run["port"]
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert [tuple(g.shape) for g in _tree.leaves(tg)] == [x.shape for x in jax.tree.leaves(jg)]
    worst, where = _worst_grad(tg, jg)
    assert worst <= GRAD_RTOL_F32, (where, worst)


# one architecture a layer kind the bf16 bound was measured on: dense
# attention, local/global with softcaps, MoE (the worst, 4.7e-2)
BF16_ARCHS = ("llama3.2-1b", "gemma2-9b", "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_grads_match_reference_bf16(arch):
    """With the default bf16 activations: within GRAD_RTOL_BF16 a leaf."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    params, batch = np_params(tcfg, seed=0), _batch(tcfg, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(_ref_loss_fn(jcfg)))(to_jax(params), to_jax(batch))
    tl, tg = loss_and_grads(to_port(params), _t(batch), tcfg, tm.NO_SHARDING)
    assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl))
    worst, where = _worst_grad(tg, jg)
    assert worst <= GRAD_RTOL_BF16, (where, worst)


@pytest.mark.parametrize("arch_run", ARCH_IDS, indirect=True)
def test_train_step_matches_reference(arch_run):
    """One train_step (f32 activations): loss, grad norm and lr within 1e-6,
    every leaf's update within UPDATE_RTOL, params written in place, the
    step counter at 1, every leaf moved."""
    jp, js, jmet = arch_run["ref_step"]
    tp, ts, tmet = arch_run["port_step"]
    assert [x is y for x, y in zip(_tree.leaves(tp), arch_run["given"])] == \
        [True] * len(arch_run["given"])
    assert int(ts.step) == 1
    for name in ("grad_norm", "lr"):
        assert abs(float(tmet[name]) - float(jmet[name])) <= 1e-6 * float(jmet[name])
    assert abs(float(tmet["loss"]) - arch_run["ref"][0]) <= 1e-6 * float(tmet["loss"])
    worst, where = _worst_update(arch_run["params"], tp, jp)
    assert worst <= UPDATE_RTOL, (where, worst)
    for p0, p1 in zip(jax.tree.leaves(arch_run["params"]), _tree.leaves(tp)):
        assert not np.array_equal(p1.numpy(), p0)


def test_bounds_catch_faults():
    """A grad taken with remat=False on another batch fails both grad
    bounds; a step with weight decay dropped fails UPDATE_RTOL."""
    jcfg, tcfg = j_get_config("llama3.2-1b", smoke=True), get_config("llama3.2-1b", smoke=True)
    params, batch, other = np_params(tcfg, seed=0), _batch(tcfg, 1), _batch(tcfg, 2)
    with _activations("float32"):
        _, jg = jax.jit(jax.value_and_grad(_ref_loss_fn(jcfg)))(to_jax(params), to_jax(batch))
        tp = to_port(params)
        live = [p.requires_grad_(True) for p in _tree.leaves(tp)]
        logits, _ = tm.forward(tp, _t(other), tcfg, tm.NO_SHARDING, remat=False)
        wrong = torch.autograd.grad(cross_entropy_loss(logits, _t(other)["labels"]), live)
        assert _worst_grad(_tree.unflatten(tp, wrong), jg)[0] > GRAD_RTOL_BF16
        jp = to_jax(params)
        jnew = joptim.adamw_update(jg, joptim.adamw_init(jp), jp, joptim.AdamWConfig(**STEP_CFG))[0]
        tp = to_port(params)
        tnew = train_step(tp, adamw_init(tp), _t(batch), tcfg, tm.NO_SHARDING,
                          AdamWConfig(**dict(STEP_CFG, weight_decay=0.0)))[0]
        assert _worst_update(params, tnew, jnew)[0] > UPDATE_RTOL


def test_microbatches_match_reference():
    """num_microbatches=2 against the reference's (its lax.scan), f32
    activations: loss and grad norm within 1e-6, updates within
    UPDATE_RTOL."""
    jcfg, tcfg = j_get_config("llama3.2-1b", smoke=True), get_config("llama3.2-1b", smoke=True)
    params, batch = np_params(tcfg, seed=0), _batch(tcfg, 1, b=4)
    with _activations("float32"):
        step = jax.jit(jstep.make_train_step(jcfg, jm.NO_SHARDING, joptim.AdamWConfig(**STEP_CFG),
                                             num_microbatches=2))
        jp, _, jmet = step(to_jax(params), joptim.adamw_init(to_jax(params)), to_jax(batch))
        tp = to_port(params)
        tp, ts, tmet = make_train_step(tcfg, tm.NO_SHARDING, AdamWConfig(**STEP_CFG),
                                       num_microbatches=2)(tp, adamw_init(tp), _t(batch))
    for name in ("loss", "grad_norm"):
        assert abs(float(tmet[name]) - float(jmet[name])) <= 1e-6 * float(jmet[name])
    worst, where = _worst_update(params, tp, jp)
    assert worst <= UPDATE_RTOL, (where, worst)


def test_mesh_and_enabled_rules_raise_typed_errors(tmp_path):
    """Enabled rules need a data x model mesh and params placed on it (typed
    errors otherwise); on a one-shard mesh the step is the plain one."""
    cfg = get_config("llama3.2-1b", smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _t(_batch(cfg, 1))
    local = compat.make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(SpgemmConfigError, match="mesh"):
        make_train_step(cfg, tm.ShardingRules(), mesh=None)
    with pytest.raises(SpgemmConfigError, match="data x model mesh"):
        make_train_step(cfg, tm.ShardingRules(), mesh=local)
    with pytest.raises(SpgemmConfigError):
        train_step(params, adamw_init(params), batch, cfg, tm.ShardingRules(), AdamWConfig())
    with pytest.raises(SpgemmConfigError, match="data x model mesh"):
        loss_and_grads(params, batch, cfg, tm.ShardingRules(), mesh=object())
    with one_rank_mesh(tmp_path) as mesh:
        rules = rules_for_mesh(mesh)
        with pytest.raises(SpgemmConfigError, match="plain tensor"):
            loss_and_grads(params, batch, cfg, rules, mesh=mesh)
        specs = tm.param_shardings(cfg, rules)
        placed = tm.place(_tree.tree_map(torch.clone, params), specs, mesh)
        zero1 = zero1_shardings(specs, rules.dp_axes, mesh.shape, tm.param_specs(cfg, rules))
        opt = adamw_init(placed, mesh, zero1)
        got, _, gm = make_train_step(cfg, rules, AdamWConfig(), mesh=mesh)(placed, opt, batch)
        want, _, wm = make_train_step(cfg, tm.NO_SHARDING, AdamWConfig())(
            params, adamw_init(params), batch)
        assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-6)
        for a, b in zip(_tree.leaves(got), _tree.leaves(want)):
            torch.testing.assert_close(a.full_tensor(), b, rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# the reference's training scenarios (tests/test_train.py) on the port
# --------------------------------------------------------------------------


def _setup(seed=0):
    cfg = get_config("llama3.2-1b", smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = adamw_init(params)
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                              device="cpu")
    return cfg, params, opt, data


def test_loss_decreases():
    cfg, params, opt, data = _setup()
    step = make_train_step(cfg, tm.NO_SHARDING, AdamWConfig(lr=3e-3, warmup_steps=5))
    first = last = None
    for s in range(30):
        params, opt, m = step(params, opt, data.get_batch(s % 2))
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert np.isfinite(last)
    assert last < first - 0.5, (first, last)


def test_microbatch_equivalence():
    """num_microbatches=2 must give (near-)identical grads/update to 1 (each
    from its own copy of the state: the step writes it in place)."""
    cfg, params, opt, data = _setup()
    batch = data.get_batch(0)
    clone = lambda tree: _tree.tree_map(torch.clone, tree)  # noqa: E731
    p1, _, m1 = make_train_step(cfg, tm.NO_SHARDING, AdamWConfig())(clone(params), clone(opt),
                                                                     batch)
    p2, _, m2 = make_train_step(cfg, tm.NO_SHARDING, AdamWConfig(),
                                num_microbatches=2)(clone(params), clone(opt), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-2)
    l1 = _tree.leaves(p1)[0]
    l2 = _tree.leaves(p2)[0]
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-2, atol=1e-4)


def test_grad_clip_fires():
    cfg, params, opt, _ = _setup()
    big = _tree.tree_map(lambda p: torch.full(p.shape, 100.0), params)
    _, _, m = adamw_update(big, opt, params, AdamWConfig(grad_clip=1.0))
    assert float(m["grad_norm"]) > 1.0  # raw norm reported, update clipped


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    """The reference's test_models.py::test_train_step_smoke on the port:
    finite loss, step 1, and every leaf moved (every leaf drawn: with
    ``init_params``' zero "norm"-role matrices mamba2's SSD and hubert's
    front end add nothing, and their norms get no grad)."""
    cfg = get_config(arch, smoke=True)
    params = to_port(np_params(cfg, seed=0))
    before = [p.clone() for p in _tree.leaves(params)]
    params, opt, metrics = make_train_step(cfg, tm.NO_SHARDING, AdamWConfig(lr=1e-3))(
        params, adamw_init(params), _t(_batch(cfg, 2)))
    assert np.isfinite(float(metrics["loss"])) and int(opt.step) == 1
    moved = [not torch.equal(a, b) for a, b in zip(before, _tree.leaves(params))]
    assert all(moved), [p for (p, _), m in zip(_tree.leaves_with_path(params), moved) if not m]


def test_ssd_grads_stay_finite_where_the_reference_overflows():
    """mamba2 with a strong decay (``a_log`` = 3): the SSD's masked l < s
    entries overflow exp to inf. The reference takes the exp before the
    mask and its grads go NaN; the port masks first: the same loss, finite
    grads (ROADMAP Queue 3). At the usual decay the two agree
    (test_grads_match_reference_f32)."""
    jcfg, tcfg = j_get_config("mamba2-2.7b", smoke=True), get_config("mamba2-2.7b", smoke=True)
    params, batch = np_params(tcfg, seed=0), _batch(tcfg, 1)
    params["blocks"][0]["ssm"]["a_log"][...] = 3.0
    with _activations("float32"):
        jl, jg = jax.jit(jax.value_and_grad(_ref_loss_fn(jcfg)))(to_jax(params), to_jax(batch))
        tl, tg = loss_and_grads(to_port(params), _t(batch), tcfg, tm.NO_SHARDING)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert any(np.isnan(np.asarray(x)).any() for x in jax.tree.leaves(jg))
    assert all(bool(torch.isfinite(g).all()) for g in _tree.leaves(tg))

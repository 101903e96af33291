"""The LM substrate's model zoo (``repro_torch.models``) against the
reference's, architecture by architecture at the smoke configs.

Params are seeded numpy arrays (``torch_lm_common.np_params``) carried into
both packages; activations are bf16 on both sides (``COMPUTE_DTYPE``), so
the two differ by bf16 rounding of differently ordered sums. ``forward``
and ``decode_step`` logits are held to ``LOGIT_TOL`` = 0.03 absolute: the
logits' scale is about 1, the worst difference seen is two bf16 ulps of it
(0.0078), and GQA heads repeated in the wrong order move them by 0.55, which
``test_logit_tolerance_bites`` shows. The reference's own bf16 tolerance is
0.15.
The reference's outputs are computed once per architecture under
``jax.jit`` (module-scoped fixture). The port's own versions of the
reference's model tests (decode equals forward, gemma2's ring buffer, param
counts) keep the reference's 0.15.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models.model import model_template as j_model_template
import repro_torch.models as tm
from repro_torch.configs import get_config
from repro_torch.models import model as tmm

from torch_lm_common import max_err, np_batch, np_params, to_jax, to_port

B, T = 2, 16
LOGIT_TOL = 0.03
REF_TOL = 0.15  # the reference's tests/test_models.py bound
CAUSAL = [a for a in ARCH_IDS if get_config(a, smoke=True).causal]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t_for(cfg):
    return cfg.num_patches + 8 if cfg.frontend == "vision" else T


@pytest.fixture(scope="module")
def pair(request):
    """(arch, reference logits, port logits) of forward and, for causal
    archs, of T decode steps from a zero bf16 cache, on one set of params."""
    arch = request.param
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    params = np_params(tcfg, seed=0)
    jp, tp = to_jax(params), to_port(params)
    rng = np.random.default_rng(1)
    batch = np_batch(tcfg, rng, B, _t_for(tcfg))
    fwd = jax.jit(lambda p, b: jm.forward(p, b, jcfg, jm.NO_SHARDING, remat=False)[0])
    out = {"forward": (fwd(jp, to_jax(batch)),
                       tm.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  tcfg, tm.NO_SHARDING, remat=False)[0])}
    if tcfg.causal:
        toks = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
        dec = jax.jit(lambda p, c, tok, pos: jm.decode_step(p, c, tok, pos, jcfg, jm.NO_SHARDING,
                                                             max_len=T))
        jc = jm.init_cache(jcfg, B, max_len=T)
        tc = tm.init_cache(tcfg, B, max_len=T, device="cpu")
        jl, tl = [], []
        for i in range(T):
            lg, jc = dec(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            jl.append(lg)
            lg, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i, tcfg,
                                    tm.NO_SHARDING, max_len=T)
            tl.append(lg)
        out["decode"] = (jnp.concatenate(jl, axis=1), torch.cat(tl, dim=1))
    return arch, out


@pytest.mark.parametrize("pair", ARCH_IDS, indirect=True)
@torch.no_grad()
def test_forward_matches_reference(pair):
    arch, out = pair
    want, got = out["forward"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    err, scale = max_err(got, want)
    assert scale > 0.1, (arch, scale)  # the logits are not degenerate
    assert err <= LOGIT_TOL, (arch, err, scale)


@pytest.mark.parametrize("pair", CAUSAL, indirect=True)
@torch.no_grad()
def test_decode_matches_reference(pair):
    arch, out = pair
    want, got = out["decode"]
    err, scale = max_err(got, want)
    assert err <= LOGIT_TOL, (arch, err, scale)


@torch.no_grad()
def test_logit_tolerance_bites(monkeypatch):
    """KV heads repeated as blocks instead of each in a row (``Tensor.repeat``
    for ``jnp.repeat``) must fail LOGIT_TOL."""
    from repro_torch.models import layers as tl

    cfg = get_config("llama3.2-1b", smoke=True)
    params = np_params(cfg, seed=0)
    batch = np_batch(cfg, np.random.default_rng(1), B, T)
    want, _ = jm.forward(to_jax(params), to_jax(batch), j_get_config("llama3.2-1b", smoke=True),
                         jm.NO_SHARDING, remat=False)
    monkeypatch.setattr(tl, "repeat_kv", lambda k, g: k if g == 1 else k.repeat(1, 1, g, 1))
    got, _ = tm.forward(to_port(params), {"tokens": torch.from_numpy(batch["tokens"])}, cfg,
                        tm.NO_SHARDING, remat=False)
    assert max_err(got, want)[0] > LOGIT_TOL


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_templates_and_shardings_match_reference(arch, smoke):
    jcfg, tcfg = j_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert tm.model_template(tcfg) == j_model_template(jcfg)
    for kw in ({}, {"tp_size": 4, "dp_size": 2}, {"dp_axes": ("pod", "data"), "dp_size": 8}):
        want = jax.tree.map(tuple, jm.param_shardings(jcfg, jm.ShardingRules(**kw)),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert tm.param_shardings(tcfg, tm.ShardingRules(**kw)) == want
    specs = tm.param_specs(tcfg, tm.NO_SHARDING, dtype=torch.bfloat16)
    want = jm.param_specs(jcfg, jm.NO_SHARDING, dtype=jnp.bfloat16)
    got_leaves = jax.tree.leaves(specs)
    assert [tuple(s.shape) for s in got_leaves] == [s.shape for s in jax.tree.leaves(want)]
    assert all(s.device.type == "meta" and s.dtype == torch.bfloat16 for s in got_leaves)
    if tcfg.causal:
        for lc in (False, True):
            jt = jm.cache_template(jcfg, 3, 40)
            tt = tm.cache_template(tcfg, 3, 40)
            assert [(tuple(s.shape), str(s.dtype).split(".")[-1]) for s in jax.tree.leaves(tt)] \
                == [(s.shape, str(s.dtype)) for s in jax.tree.leaves(jt)]
            js = jm.cache_shardings(jcfg, jm.ShardingRules(), 3, 40, long_context=lc)
            ts = tm.cache_shardings(tcfg, tm.ShardingRules(), 3, 40, long_context=lc)
            is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
            assert [tuple(s) for s in jax.tree.leaves(js, is_leaf=is_spec)] \
                == jax.tree.leaves(ts, is_leaf=lambda x: isinstance(x, tuple)
                                   and not hasattr(x, "_fields"))


def _init(cfg, seed, **kw):
    return tm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
@torch.no_grad()
def test_forward_smoke(arch):
    """The reference's test_forward_smoke: shapes, finite logits."""
    cfg = get_config(arch, smoke=True)
    params = _init(cfg, 0)
    batch = np_batch(cfg, np.random.default_rng(1), B, T)
    logits, _ = tm.forward(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                           tm.NO_SHARDING, remat=False)
    assert logits.shape == (B, T, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()


def test_init_params_draws_from_the_generator():
    cfg = get_config("recurrentgemma-9b", smoke=True)
    a, b, c = _init(cfg, 3), _init(cfg, 3), _init(cfg, 4, dtype=torch.bfloat16)
    la, lb, lc = (jax.tree.leaves(x) for x in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(la[-1], lc[-1].float()) and lc[0].dtype == torch.bfloat16
    tmpl = jax.tree.leaves(tm.model_template(cfg), is_leaf=tmm._is_template_leaf)
    for (shape, role), x in zip(tmpl, la):
        assert tuple(x.shape) == shape and x.device.type == "cpu"
        if role == "norm" or len(shape) == 1:
            assert not x.any()
        elif x.numel() > 1000:
            assert abs(float(x.std()) - 0.02) < 0.002


@pytest.mark.parametrize("arch", CAUSAL)
@torch.no_grad()
def test_decode_matches_forward(arch):
    """The reference's test of the same name, on the port."""
    cfg = get_config(arch, smoke=True)
    params = _init(cfg, 1)
    t = 16
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, t))
                            .astype(np.int32))
    full, _ = tm.forward(params, {"tokens": toks}, cfg, tm.NO_SHARDING, remat=False)
    cache = tm.init_cache(cfg, B, max_len=t, dtype=torch.float32, device="cpu")
    outs = []
    for i in range(t):
        lg, cache = tm.decode_step(params, cache, toks[:, i:i + 1], i, cfg, tm.NO_SHARDING,
                                   max_len=t)
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1).float() - full.float()).abs().max())
    assert err < REF_TOL, err


@torch.no_grad()
def test_gemma2_ring_buffer_beyond_window():
    """Decode past the local window: the ring cache must equal a full one."""
    cfg = get_config("gemma2-9b", smoke=True)  # window 16
    params = _init(cfg, 2)
    t = 3 * cfg.window
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, t))
                            .astype(np.int32))
    full, _ = tm.forward(params, {"tokens": toks}, cfg, tm.NO_SHARDING, remat=False)
    cache = tm.init_cache(cfg, B, max_len=t, dtype=torch.float32, device="cpu")
    outs = []
    for i in range(t):
        lg, cache = tm.decode_step(params, cache, toks[:, i:i + 1], i, cfg, tm.NO_SHARDING,
                                   max_len=t)
        outs.append(lg[:, 0])
    assert cache["blocks"][0].k.shape[2] == cfg.window
    err = float((torch.stack(outs, 1).float() - full.float()).abs().max())
    assert err < REF_TOL, err


def test_param_counts_match_template():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        total = sum(int(np.prod(s.shape)) for s in
                    jax.tree.leaves(tm.param_specs(cfg, tm.NO_SHARDING)))
        est = cfg.param_count()
        assert abs(total - est) / est < 0.12, (arch, total, est)


def test_remat_changes_nothing_but_the_backward():
    cfg = get_config("llama3.2-1b", smoke=True)
    params = jax.tree.map(lambda x: x.requires_grad_(), _init(cfg, 5))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T))
                            .astype(np.int32))
    grads = []
    for remat in (True, False):
        logits, _ = tm.forward(params, {"tokens": toks}, cfg, tm.NO_SHARDING, remat=remat)
        loss = logits.float().square().mean()
        grads.append(torch.autograd.grad(loss, params["blocks"][0]["ffn"]["w1"])[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)

"""The token-serving engine (``repro_torch.serve.engine``) against the
reference's ``repro.serve.engine``, at the smoke configs.

``prefill_to_cache`` only places and rolls, so it is held bitwise on caches
carried across from the reference (``convert.caches_from_numpy``), ring
buffers included. Logits are bf16 on both sides and held to ``LOGIT_TOL``
= 0.03 absolute (``tests/test_torch_models.py`` says why); the engine's own
handoff against pure decode keeps the reference's 0.15. Greedy tokens are
held to the reference's logits: each is the reference's argmax, or within
2 x LOGIT_TOL of it where bf16 rounding can swap a near tie. Sampled tokens
come from a ``torch.Generator`` and are not the reference's (ROADMAP Queue
3); they are held to be repeatable under one seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as j_get_config
from repro.serve import engine as jeng
import repro_torch.models as tm
from repro_torch import compat, convert
from repro_torch.configs import get_config
from repro_torch.launch.mesh import rules_for_mesh
from repro_torch.models import moe as tmoe
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.serve import ServeEngine, prefill_to_cache

from torch_lm_common import max_err, np_params, one_rank_mesh, to_jax, to_port

LOGIT_TOL = 0.03
REF_TOL = 0.15  # the reference's tests/test_serve.py bound
ENGINE_ARCHS = ["llama3.2-1b", "gemma2-9b", "mamba2-2.7b", "recurrentgemma-9b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _pair(arch, seed=0):
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    params = np_params(tcfg, seed)
    return jcfg, tcfg, to_jax(params), to_port(params)


def _bits(tree):
    return jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x).view(np.uint8), tree))


# (arch, prompt length, max_len): gemma2's and recurrentgemma's local layers
# (window 16) become ring buffers past the window
PLACEMENTS = [("gemma2-9b", 21, 40), ("gemma2-9b", 16, 40), ("gemma2-9b", 9, 12),
              ("recurrentgemma-9b", 37, 48), ("llama3.2-1b", 12, 24), ("mamba2-2.7b", 12, 24)]


@pytest.mark.parametrize("arch,t,max_len", PLACEMENTS)
def test_prefill_to_cache_bitwise(arch, t, max_len):
    jcfg, tcfg, jp, _ = _pair(arch)
    toks = jnp.asarray(_tokens(tcfg, 2, t, 1))
    _, jc = jax.jit(lambda p, x: jm.forward(p, {"tokens": x}, jcfg, jm.NO_SHARDING,
                                            return_caches=True, max_len=max_len,
                                            remat=False))(jp, toks)
    want = jeng.prefill_to_cache(jc, jcfg, t, max_len)
    carried = convert.caches_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    got = prefill_to_cache(carried, tcfg, t, max_len)
    back = convert.caches_to_numpy(got, bfloat16=jnp.bfloat16)
    assert [type(c).__name__ for c in back["blocks"] + back["tail"]] == \
        [type(c).__name__ for c in want["blocks"] + want["tail"]]
    assert jax.tree.structure(jax.tree.map(np.asarray, want)).num_leaves == \
        len(jax.tree.leaves(back))
    for g, w in zip(_bits(back), _bits(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
@torch.no_grad()
def test_engine_prefill_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch, seed=2)
    toks = _tokens(tcfg, 2, 20, 3)
    want_last, want_c, want_pos = jeng.ServeEngine(jp, jcfg, max_len=32).prefill(jnp.asarray(toks))
    got_last, got_c, got_pos = ServeEngine(tp, tcfg, max_len=32).prefill(torch.from_numpy(toks))
    assert got_pos == want_pos == 20
    assert max_err(got_last, want_last)[0] <= LOGIT_TOL
    for g, w in zip(jax.tree.leaves(got_c), jax.tree.leaves(want_c)):
        assert tuple(g.shape) == w.shape
        assert max_err(g, w)[0] <= LOGIT_TOL


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
@torch.no_grad()
def test_prefill_decode_equals_pure_decode(arch):
    """The reference's test of the same name, on the port: prefill T tokens
    and decode one must equal feeding all T + 1 through decode_step."""
    cfg = get_config(arch, smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, t, max_len = 2, 12, 24
    toks = torch.from_numpy(_tokens(cfg, b, t, 5))
    eng = ServeEngine(params, cfg, max_len=max_len)
    last_logits, caches, pos = eng.prefill(toks)
    cache2 = tm.init_cache(cfg, b, max_len=max_len, dtype=torch.float32, device="cpu")
    for i in range(t):
        lg2, cache2 = tm.decode_step(params, cache2, toks[:, i:i + 1], i, cfg, tm.NO_SHARDING,
                                     max_len=max_len)
    assert float((last_logits.float() - lg2[:, 0].float()).abs().max()) < REF_TOL
    nxt = torch.zeros((b, 1), dtype=torch.int32)
    lg_a, _ = tm.decode_step(params, caches, nxt, t, cfg, tm.NO_SHARDING, max_len=max_len)
    lg_b, _ = tm.decode_step(params, cache2, nxt, t, cfg, tm.NO_SHARDING, max_len=max_len)
    assert float((lg_a.float() - lg_b.float()).abs().max()) < REF_TOL


@torch.no_grad()
def test_decode_step_writes_the_caches_it_is_given():
    """The port's counterpart of donate_argnums: the caches come back as the
    same tensors, updated; a second path needs a clone taken first."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 20, 6))
    eng = ServeEngine(params, cfg, max_len=24)
    _, caches, pos = eng.prefill(toks)
    kept = jax.tree.map(torch.clone, caches)
    before = jax.tree.leaves(caches)
    nxt = torch.ones((2, 1), dtype=torch.int32)
    lg1, out = tm.decode_step(params, caches, nxt, pos, cfg, tm.NO_SHARDING, max_len=24)
    after = jax.tree.leaves(out)
    assert all(a is b for a, b in zip(after, before))
    assert any(not torch.equal(a, k) for a, k in zip(after, jax.tree.leaves(kept)))
    lg2, _ = tm.decode_step(params, kept, nxt, pos, cfg, tm.NO_SHARDING, max_len=24)
    assert torch.equal(lg1, lg2)


@torch.no_grad()
def test_generate_shapes_and_determinism():
    """The reference's test of the same name, on the port."""
    cfg = get_config("llama3.2-1b", smoke=True)
    eng = ServeEngine(tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
                      max_len=32)
    prompts = torch.from_numpy(_tokens(cfg, 2, 8, 6))
    out1, out2 = eng.generate(prompts, steps=6), eng.generate(prompts, steps=6)
    assert out1.shape == (2, 6) and out1.dtype == torch.int32
    assert torch.equal(out1, out2)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-9b"])
@torch.no_grad()
def test_greedy_tokens_follow_the_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch, seed=7)
    prompts = _tokens(tcfg, 2, 18, 8)
    steps = 6
    got = ServeEngine(tp, tcfg, max_len=32).generate(torch.from_numpy(prompts), steps=steps)
    want = np.asarray(jeng.ServeEngine(jp, jcfg, max_len=32).generate(jnp.asarray(prompts), steps))
    # the reference's logits along the port's tokens (teacher forcing)
    seq = np.concatenate([prompts, got.numpy()], axis=1)
    logits, _ = jax.jit(lambda p, x: jm.forward(p, {"tokens": x}, jcfg, jm.NO_SHARDING,
                                                remat=False))(jp, jnp.asarray(seq))
    ref = np.asarray(logits, np.float32)[:, prompts.shape[1] - 1:-1]  # predicts each token
    chosen = np.take_along_axis(ref, got.numpy()[..., None].astype(np.int64), -1)[..., 0]
    assert (chosen >= ref.max(-1) - 2 * LOGIT_TOL).all()
    margin = np.sort(ref, -1)[..., -1] - np.sort(ref, -1)[..., -2]
    first = np.argmax(np.concatenate([margin <= 2 * LOGIT_TOL, np.ones((2, 1), bool)], 1), 1)
    for row in range(2):  # up to the first near tie the tokens are the reference's
        np.testing.assert_array_equal(got.numpy()[row, :first[row]], want[row, :first[row]])
    assert first.sum() > 0


@torch.no_grad()
def test_sampled_generate_repeats_under_one_generator():
    cfg = get_config("gemma2-9b", smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    eng = ServeEngine(params, cfg, max_len=32)
    prompts = torch.from_numpy(_tokens(cfg, 3, 8, 9))
    runs = [eng.generate(prompts, 12, temperature=1.0, generator=torch.Generator().manual_seed(s))
            for s in (11, 11, 12)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert runs[0].dtype == torch.int32 and int(runs[0].max()) < cfg.vocab_size
    greedy = eng.generate(prompts, 12)
    assert not torch.equal(runs[0], greedy)


def test_mesh_paths_and_enabled_hooks_raise_typed_errors(tmp_path):
    """Enabled rules without a data x model mesh, or with unplaced params,
    raise typed errors; on a one-shard mesh the expert-parallel MoE block,
    forward and the engine give the plain results."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    params["blocks"][0]["moe"]["router"].normal_(0.0, 0.5, generator=torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(cfg, 2, 16, 10))
    local = compat.make_mesh((2,), ("data",), device="cpu")
    p_moe = jax.tree.map(lambda x: x[0], params["blocks"][0]["moe"])
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    with pytest.raises(SpgemmConfigError, match="data x model mesh"):
        tmoe.moe_layer(p_moe, x, cfg, tm.ShardingRules(), mesh=local)
    # without a mesh, or with sharding off, the single-device path runs
    want = tmoe.moe_layer(p_moe, x, cfg, tm.NO_SHARDING, mesh=local)
    assert want.shape == x.shape
    with pytest.raises(SpgemmConfigError, match="mesh"):
        tm.forward(params, {"tokens": toks}, cfg, tm.ShardingRules(), remat=False)
    with pytest.raises(SpgemmConfigError, match="mesh"):
        ServeEngine(params, cfg, rules=tm.ShardingRules(decode=True)).generate(toks, 2)
    cache = tm.init_cache(cfg, 2, 20, device="cpu")
    with pytest.raises(SpgemmConfigError):
        tm.decode_step(params, cache, toks[:, :1], 0, cfg, tm.ShardingRules(), max_len=20)
    with one_rank_mesh(tmp_path) as mesh:
        rules = rules_for_mesh(mesh)
        with pytest.raises(SpgemmConfigError, match="plain"):
            tmoe.moe_layer(p_moe, x, cfg, rules, mesh=mesh)
        with pytest.raises(SpgemmConfigError, match="plain tensor"):
            ServeEngine(params, cfg, rules=rules, mesh=mesh)
        specs = tm.param_shardings(cfg, rules)
        placed = tm.place(params, specs, mesh)
        moe_specs = jax.tree.map(lambda s: s[1:], specs["blocks"][0]["moe"],
                                 is_leaf=lambda s: isinstance(s, tuple))
        got = tmoe.moe_layer(tm.place(p_moe, moe_specs, mesh), mesh.distribute(x, (None,) * 3),
                             cfg, rules, mesh=mesh)
        assert torch.equal(got.full_tensor(), want)
        logits, _ = tm.forward(placed, {"tokens": toks}, cfg, rules, mesh=mesh, remat=False)
        plain, _ = tm.forward(params, {"tokens": toks}, cfg, tm.NO_SHARDING, remat=False)
        assert torch.equal(logits.full_tensor(), plain)
        dec = dataclasses.replace(rules, decode=True)
        got = ServeEngine(placed, cfg, rules=dec, mesh=mesh, max_len=24).generate(toks, 4)
        assert torch.equal(got, ServeEngine(params, cfg, max_len=24).generate(toks, 4))
"""The LM substrate's layers (``repro_torch.models``: sharding, layers, moe,
rglru, ssm) against the reference's, function by function.

Inputs are seeded numpy arrays handed to both packages; activations are
f32, so both compute the same f32 arithmetic up to reassociation. Every
output is held to ``RTOL`` = 1e-5 of its own scale (max |reference|), except
where noted: the routing's ids, slots and keep mask bitwise and its weights
at 1e-6 absolute, ``repeat_kv`` bitwise. Two tests
show that the tolerance bites: with torch's default erf GELU in place of the
tanh form ``ffn_layer`` fails it, and with ``Tensor.repeat`` in place of
``repeat_interleave`` ``attention_layer`` does.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import sharding as jsh
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import sharding as tsh
from repro_torch.models import ssm as tssm
from repro_torch.runtime.validate import SpgemmConfigError

from torch.distributed.tensor import DTensor

from torch_lm_common import assert_close, max_err, np_params, one_rank_mesh

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _layer_params(arch, block: str, seed=0, pos=0):
    """One pattern position's params (repeat 0) of a smoke config, as numpy:
    (reference config, port config, params)."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    tree = np_params(tcfg, seed)["blocks"][pos][block]
    return jcfg, tcfg, {k: v[0] for k, v in tree.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()})


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, (2, 5, 48), 3.0), _rand(rng, (48,), 0.1)
    assert_close(tl.rms_norm(_t(x), _t(s), 1e-5), jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5),
                 RTOL, "rms_norm")


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 16))
    pos = np.arange(7, dtype=np.int32) + 1021
    assert_close(tl.rope(_t(x), _t(pos), theta), jl.rope(jnp.asarray(x), jnp.asarray(pos), theta),
                 RTOL, "rope")


@pytest.mark.parametrize("group", [1, 2, 4])
def test_repeat_kv_bitwise(group):
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    got = tl.repeat_kv(_t(x), group).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.repeat_kv(jnp.asarray(x), group)))


# (causal, window, softcap, q_chunk, k_block): T = 37 is a multiple of no block
ATTN_CASES = [
    (True, None, None, 8, 8),
    (True, 10, None, 8, 8),
    (True, 10, 5.0, 16, 8),
    (False, None, None, 8, 16),
    (True, None, 30.0, 1024, 1024),
]


@pytest.mark.parametrize("causal,window,softcap,q_chunk,k_block", ATTN_CASES)
def test_blockwise_attention(causal, window, softcap, q_chunk, k_block):
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, (2, 37, 4, 16)) for _ in range(3))
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=q_chunk, k_block=k_block)
    got = tl.blockwise_attention(_t(q), _t(k), _t(v), **kw)
    want = jl.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert_close(got, want, RTOL, "blockwise_attention")


@pytest.mark.parametrize("ring,pos,window,softcap", [
    (False, 9, None, None), (False, 15, 6, 50.0), (True, 13, 8, None), (True, 5, 8, 30.0),
    (True, 40, None, None)])
def test_decode_attention(ring, pos, window, softcap):
    rng = np.random.default_rng(3)
    s = 8 if ring else 16
    q, k, v = _rand(rng, (2, 1, 4, 16)), _rand(rng, (2, s, 4, 16)), _rand(rng, (2, s, 4, 16))
    kw = dict(window=window, softcap=softcap, ring=ring)
    got = tl.decode_attention(_t(q), _t(k), _t(v), pos, **kw)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos), **kw)
    assert_close(got, want, RTOL, "decode_attention")


# --------------------------------------------------------------------------
# attention and FFN layers
# --------------------------------------------------------------------------

# (arch, pattern position, window, ring): GQA (llama), bias (qwen2), qk_norm
# (qwen3-moe), softcap and a local window (gemma2), MHA encoder (hubert)
ATTN_LAYERS = [("llama3.2-1b", 0, None, False), ("qwen2-7b", 0, None, False),
               ("qwen3-moe-30b-a3b", 0, None, False), ("gemma2-9b", 0, 16, True),
               ("gemma2-9b", 1, None, False), ("hubert-xlarge", 0, None, False)]


def _attention_pair(arch, pos_i, window, t=19):
    jcfg, tcfg, p = _layer_params(arch, "attn", seed=4, pos=pos_i)
    rng = np.random.default_rng(5)
    x = _rand(rng, (2, t, tcfg.d_model))
    positions = np.arange(t, dtype=np.int32)
    jp, tp = _both(p)
    want, jc = jl.attention_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING, window=window,
                                  positions=jnp.asarray(positions), return_cache=True)

    def port():
        return tl.attention_layer(tp, _t(x), tcfg, tsh.NO_SHARDING, window=window,
                                  positions=_t(positions), return_cache=True)
    return want, jc, port


@pytest.mark.parametrize("arch,pos_i,window,ring", ATTN_LAYERS)
def test_attention_layer_prefill(arch, pos_i, window, ring):
    want, jc, port = _attention_pair(arch, pos_i, window)
    got, tc = port()
    assert_close(got, want, RTOL, "attention_layer")
    assert_close(tc.k, jc.k, RTOL, "k")
    assert_close(tc.v, jc.v, RTOL, "v")


@pytest.mark.parametrize("arch,pos_i,window,ring", [c for c in ATTN_LAYERS if c[0] != "hubert-xlarge"])
@pytest.mark.parametrize("pos", [5, 21])
def test_attention_layer_decode_writes_the_cache(arch, pos_i, window, ring, pos):
    jcfg, tcfg, p = _layer_params(arch, "attn", seed=6, pos=pos_i)
    rng = np.random.default_rng(7)
    s = 8 if ring else 24
    x = _rand(rng, (2, 1, tcfg.d_model))
    k, v = (_rand(rng, (2, s, tcfg.num_kv_heads, tcfg.resolved_head_dim)) for _ in range(2))
    jp, tp = _both(p)
    kw = dict(window=window, pos=pos, ring=ring)
    want, jc = jl.attention_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING,
                                  positions=jnp.asarray([pos], jnp.int32),
                                  cache=jl.AttnCache(jnp.asarray(k), jnp.asarray(v)),
                                  **{**kw, "pos": jnp.int32(pos)})
    cache = tl.AttnCache(_t(k), _t(v))
    got, tc = tl.attention_layer(tp, _t(x), tcfg, tsh.NO_SHARDING,
                                 positions=torch.tensor([pos], dtype=torch.int32), cache=cache, **kw)
    assert_close(got, want, RTOL, "attention_layer decode")
    assert tc.k is cache.k and tc.v is cache.v  # written in place
    assert_close(tc.k, jc.k, RTOL, "k cache")
    assert_close(tc.v, jc.v, RTOL, "v cache")


def test_attention_tolerance_bites_on_tensor_repeat(monkeypatch):
    """GQA's KV heads repeated as blocks (``Tensor.repeat``) instead of each
    head in a row (``jnp.repeat``) must fail RTOL."""
    want, _, port = _attention_pair("llama3.2-1b", 0, None)
    monkeypatch.setattr(tl, "repeat_kv",
                        lambda k, group: k if group == 1 else k.repeat(1, 1, group, 1))
    got, _ = port()
    err, scale = max_err(got, want)
    assert err > RTOL * scale, (err, scale)


FFN_ARCHS = ["llama3.2-1b", "gemma2-9b", "hubert-xlarge"]  # silu, gelu, gelu2


def _ffn_pair(arch):
    jcfg, tcfg, p = _layer_params(arch, "ffn", seed=8)
    x = _rand(np.random.default_rng(9), (2, 11, tcfg.d_model))
    jp, tp = _both(p)
    want = jl.ffn_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING)
    return want, lambda: tl.ffn_layer(tp, _t(x), tcfg, tsh.NO_SHARDING)


@pytest.mark.parametrize("arch", FFN_ARCHS)
def test_ffn_layer(arch):
    want, port = _ffn_pair(arch)
    assert_close(port(), want, RTOL, f"ffn_layer {arch}")


@pytest.mark.parametrize("arch", ["gemma2-9b", "hubert-xlarge"])
def test_ffn_tolerance_bites_on_erf_gelu(arch, monkeypatch):
    """``jax.nn.gelu`` is the tanh form; torch's default erf GELU must fail
    RTOL."""
    want, port = _ffn_pair(arch)
    monkeypatch.setattr(tl, "gelu", F.gelu)
    err, scale = max_err(port(), want)
    assert err > RTOL * scale, (err, scale)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("capacity", [4, 8, 64])
def test_routing_symbolic(tied, capacity):
    """ids, slots and keep bitwise, weights within 1e-6; all-zero logits
    (``init_params``' router) tie every expert."""
    rng = np.random.default_rng(10)
    logits = np.zeros((40, 8), np.float32) if tied else _rand(rng, (40, 8))
    want = jmoe.routing_symbolic(jnp.asarray(logits), 2, capacity, 8)
    got = tmoe.routing_symbolic(_t(logits), 2, capacity, 8)
    for name, g, w in zip(("ids", "slot", "keep"), got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    if capacity == 4:
        assert not got[3].all()  # some assignments drop


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("e_start,e_local", [(0, 8), (2, 4)])
def test_moe_ffn_local_with_drops(act, e_start, e_local):
    rng = np.random.default_rng(11)
    t, d, e, f = 48, 32, 8, 24
    x = _rand(rng, (t, d))
    router = _rand(rng, (d, e), 0.3)
    w1, w3 = _rand(rng, (e_local, d, f), 0.1), _rand(rng, (e_local, d, f), 0.1)
    w2 = _rand(rng, (e_local, f, d), 0.1)
    kw = dict(k=2, capacity=8, num_experts=e, e_start=e_start, act=act)
    want = jmoe.moe_ffn_local(*(jnp.asarray(a) for a in (x, router, w1, w3, w2)), **kw)
    got = tmoe.moe_ffn_local(*(_t(a) for a in (x, router, w1, w3, w2)), **kw)
    keep = tmoe.routing_symbolic(_t(x) @ _t(router), 2, 8, e)[3]
    assert not keep.all()  # capacity 8 against 12 assignments an expert drops some
    assert_close(got, want, RTOL, "moe_ffn_local")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"])
def test_moe_layer(arch):
    jcfg, tcfg, p = _layer_params(arch, "moe", seed=12)
    x = _rand(np.random.default_rng(13), (2, 16, tcfg.d_model))
    jp, tp = _both(p)
    want = jmoe.moe_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING)
    assert_close(tmoe.moe_layer(tp, _t(x), tcfg, tsh.NO_SHARDING), want, RTOL, "moe_layer")


# --------------------------------------------------------------------------
# RG-LRU and SSD
# --------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 13, 64])
def test_linear_scan_equals_the_recurrence(t):
    rng = np.random.default_rng(14)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, t, 6)).astype(np.float64))
    b = torch.from_numpy(rng.standard_normal((2, t, 6)))
    h, want = torch.zeros(2, 6, dtype=torch.float64), []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    torch.testing.assert_close(trg.linear_scan(a, b), torch.stack(want, 1), rtol=1e-12, atol=1e-12)


def _recurrent_case(block, arch, t, seed):
    jcfg, tcfg, p = _layer_params(arch, block, seed=seed)
    x = _rand(np.random.default_rng(seed + 1), (2, t, tcfg.d_model))
    jp, tp = _both(p)
    return jcfg, tcfg, x, jp, tp


@pytest.mark.parametrize("t", [1, 37])
def test_rglru_layer_prefill(t):
    jcfg, tcfg, x, jp, tp = _recurrent_case("rec", "recurrentgemma-9b", t, 15)
    want, jc = jrg.rglru_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING, return_cache=True)
    got, tc = trg.rglru_layer(tp, _t(x), tcfg, tsh.NO_SHARDING, return_cache=True)
    assert_close(got, want, RTOL, "rglru_layer")
    assert_close(tc.state, jc.state, RTOL, "state")
    assert_close(tc.conv, jc.conv, RTOL, "conv")


def test_rglru_layer_decode():
    jcfg, tcfg, x, jp, tp = _recurrent_case("rec", "recurrentgemma-9b", 1, 17)
    rng = np.random.default_rng(18)
    w = tcfg.lru_width
    state, conv = _rand(rng, (2, w)), _rand(rng, (2, tcfg.conv_width - 1, w))
    want, jc = jrg.rglru_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING,
                               cache=jrg.RGLRUCache(jnp.asarray(state), jnp.asarray(conv)))
    got, tc = trg.rglru_layer(tp, _t(x), tcfg, tsh.NO_SHARDING,
                              cache=trg.RGLRUCache(_t(state), _t(conv)))
    assert_close(got, want, RTOL, "rglru_layer decode")
    assert_close(tc.state, jc.state, RTOL, "state")
    assert_close(tc.conv, jc.conv, RTOL, "conv")


@pytest.mark.parametrize("t", [1, 32, 77])  # ssm_chunk 32: one chunk, padded chunks
def test_ssm_layer_prefill(t):
    jcfg, tcfg, x, jp, tp = _recurrent_case("ssm", "mamba2-2.7b", t, 19)
    want, jc = jssm.ssm_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING, return_cache=True)
    got, tc = tssm.ssm_layer(tp, _t(x), tcfg, tsh.NO_SHARDING, return_cache=True)
    assert_close(got, want, RTOL, "ssm_layer")
    assert_close(tc.state, jc.state, RTOL, "state")
    assert_close(tc.conv_x, jc.conv_x, RTOL, "conv_x")
    assert_close(tc.conv_bc, jc.conv_bc, RTOL, "conv_bc")


def test_ssm_layer_decode():
    jcfg, tcfg, x, jp, tp = _recurrent_case("ssm", "mamba2-2.7b", 1, 21)
    rng = np.random.default_rng(22)
    d_in, nh = tssm._dims(tcfg)
    k = tcfg.conv_width - 1
    state = _rand(rng, (2, nh, tcfg.ssm_head_dim, tcfg.ssm_state))
    cx, cbc = _rand(rng, (2, k, d_in)), _rand(rng, (2, k, 2 * tcfg.ssm_state))
    want, jc = jssm.ssm_layer(jp, jnp.asarray(x), jcfg, jsh.NO_SHARDING,
                              cache=jssm.SSMCache(*(jnp.asarray(a) for a in (state, cx, cbc))))
    got, tc = tssm.ssm_layer(tp, _t(x), tcfg, tsh.NO_SHARDING,
                             cache=tssm.SSMCache(_t(state), _t(cx), _t(cbc)))
    assert_close(got, want, RTOL, "ssm_layer decode")
    for name in ("state", "conv_x", "conv_bc"):
        assert_close(getattr(tc, name), getattr(jc, name), RTOL, name)


# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------

RULES = [dict(), dict(dp_axes=("pod", "data"), dp_size=4), dict(tp_size=4, dp_size=2),
         dict(tp_axis=None, tp_size=1), dict(decode=True, long_context=True),
         dict(enabled=False, tp_axis=None, tp_size=1)]

ROLE_SHAPES = {
    "wq": [(64, 16, 8), (64, 28, 8)], "wkv": [(64, 8, 8), (64, 4, 8)],
    "wo": [(16, 8, 64), (28, 8, 64)], "ffn_in": [(64, 128), (64, 96)],
    "ffn_out": [(128, 64), (96, 64)], "moe": [(128, 64, 32), (8, 64, 32), (128, 6, 32)],
    "embed": [(256, 64), (504, 64)], "lm_head": [(64, 256), (64, 504)],
    "conv_ch": [(4, 128), (4, 56)], "conv_ch1": [(128,), (56,)],
    "gate_block": [(16, 8, 8), (6, 8, 8)], "norm": [(64,), (8, 64)],
}


def _spec(s):
    return tuple(s)


@pytest.mark.parametrize("kw", RULES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items())
                         or "default")
def test_sharding_roles_match_the_reference(kw):
    jr, tr = jsh.ShardingRules(**kw), tsh.ShardingRules(**kw)
    assert tr.dp == jr.dp
    for n in (1, 4, 16, 28, 32):
        assert tr._tp_if(n) == jr._tp_if(n)
    for role, shapes in ROLE_SHAPES.items():
        for shape in shapes:
            assert tr.spec_for(role, shape) == _spec(jr.spec_for(role, shape)), (role, shape)
    for name, args in (("embed", (256, 64)), ("lm_head", (64, 256)), ("norm", ()),
                       ("ssm_inproj", (64, 128)), ("ssm_outproj", (128, 64)),
                       ("wq", (64, 28, 8)), ("moe_experts", (128, 64, 32))):
        assert getattr(tr, name)(*args) == _spec(getattr(jr, name)(*args)), name
    for batch, hkv, lc in itertools.product((1, 8), (1, 8), (False, True)):
        assert tr.kv_cache_spec(batch, hkv, long_context=lc) == _spec(
            jr.kv_cache_spec(batch, hkv, long_context=lc))
    with pytest.raises(SpgemmConfigError):
        tr.spec_for("bogus", (1,))
    assert tsh.NO_SHARDING == tsh.ShardingRules(enabled=False, tp_axis=None, tp_size=1)
    assert _fields(tsh.ShardingRules) == _fields(jsh.ShardingRules)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_sharding_hooks_pass_through_when_off_and_raise_when_on(tmp_path):
    """Off, every hook returns its input; on, a plain tensor raises and a
    DTensor on a mesh is placed at the hook's spec."""
    x3, x4 = torch.zeros(2, 32, 8), torch.zeros(2, 32, 4, 8)
    off = tsh.NO_SHARDING
    for got, x in ((off.residual(x3), x3), (off.attn_activations(x4, 4), x4),
                   (off.attn_kv(x4, 4), x4), (off.kv_cache_constraint(x4), x4),
                   (off.logits(x3), x3), (off.constraint(x3, (None,)), x3)):
        assert got is x
    on, dec = tsh.ShardingRules(tp_size=1), tsh.ShardingRules(tp_size=1, decode=True)
    calls = [lambda: on.residual(x3), lambda: on.attn_activations(x4, 16),
             lambda: on.attn_activations(x4, 28), lambda: on.attn_kv(x4, 16),
             lambda: dec.kv_cache_constraint(x4), lambda: on.logits(x3),
             lambda: on.constraint(x3, (None, None, None))]
    for call in calls:
        with pytest.raises(SpgemmConfigError, match="DTensor on a data x model mesh"):
            call()
    # where the reference places nothing, neither does the port
    assert on.kv_cache_constraint(x4) is x4 and on.residual(torch.zeros(3)).ndim == 1
    with one_rank_mesh(tmp_path) as mesh:
        d3, d4 = (mesh.distribute(x, (None,) * x.ndim) for x in (x3, x4))
        for got, spec in ((on.residual(d3), ("data", "model", None)),
                          (on.attn_activations(d4, 1), ("data", None, "model", None)),
                          (on.attn_kv(d4, 1), ("data", None, "model", None)),
                          (dec.attn_activations(d4, 1), ("data", None, None, None)),
                          (dec.kv_cache_constraint(d4), ("data", "model", None, None)),
                          (on.logits(d3), ("data", None, "model"))):
            # one shard an axis: the same layout as Replicate (compat.spec_placements)
            assert isinstance(got, DTensor) and tuple(got.placements) == mesh.placements(spec)
            assert torch.equal(got.full_tensor(), torch.zeros(got.shape))
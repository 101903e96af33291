"""K7 (expert-grouped matmul) and K8 (flash attention) of the port, their
``kernels/ops`` entry points, and the port's configs, against the JAX package.

The plain versions (what the wrappers run on the CPU) are held against the
reference's Pallas kernels in interpret mode over the reference's own sweeps
(tests/test_kernels.py) at its tolerances: K7 2e-4 in f32 and 3e-2 in bf16,
K8 2e-3 in f32 and 5e-2 in bf16 (rtol and atol). The cases include KV tiles
that are fully masked before a row's first live key (window 64 at T 256)
and rows with no live key at all (window 0), which give the mean of V. The
CUDA kernels' card tests are in tests/test_torch_kernels.py.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.grouped_matmul import TM
from repro.kernels.grouped_matmul import grouped_matmul as jgrouped
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.runtime.validate import SpgemmConfigError, SpgemmInputError

# the modules (the package exports functions of the same names)
k7 = importlib.import_module("repro_torch.kernels.grouped_matmul")
k8 = importlib.import_module("repro_torch.kernels.flash_attention")


def _t(x):
    return convert.tensor_from_numpy(np.asarray(x), "cpu")


NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "float16": np.float16}


@pytest.mark.parametrize("e,d,f,blocks", [(4, 256, 256, 6), (8, 128, 384, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "bfloat16xfloat32"])
def test_grouped_matmul_matches_the_reference_kernel(e, d, f, blocks, dtype):
    """x and w in one dtype, or x bf16 and w f32 (a mixed pair: out in x's
    dtype)."""
    rng = np.random.default_rng(e * d + f)
    x_dt, _, w_dt = dtype.partition("x")
    w_dt = w_dt or x_dt
    t = blocks * TM
    be = np.sort(rng.integers(0, e, blocks)).astype(np.int32)
    x = rng.standard_normal((t, d)).astype(np.float32).astype(NP_DTYPES[x_dt])
    w = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32).astype(NP_DTYPES[w_dt])
    want = np.asarray(jgrouped(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                               interpret=True), np.float32)
    launches = k7.LAUNCHES
    got = k7.grouped_matmul(_t(x), _t(w), _t(be))
    assert k7.LAUNCHES == launches  # CPU tensors never reach the kernel
    assert got.dtype == getattr(torch, x_dt)
    tol = 2e-4 if x_dt == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    oracle = np.asarray(jref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                                jnp.repeat(jnp.asarray(be), TM)), np.float32)
    np.testing.assert_allclose(got.float().numpy(), oracle, rtol=tol, atol=tol)


def test_grouped_matmul_variant_follows_the_dtype_pair():
    """"wgmma" (tensor cores) where x and w are both bf16 or both f16, "tf32"
    (tensor cores in split TF32) for every other pair the kernel takes,
    "none" for a dtype it refuses; ``products`` counts 1 on "wgmma" and 1
    more for each f32 operand on "tf32". The card test holds the C
    launcher's choice and count to these."""
    takes = (torch.float32, torch.float16, torch.bfloat16)
    for xd in takes:
        for wd in takes:
            want = "wgmma" if xd == wd and xd != torch.float32 else "tf32"
            assert k7.variant(xd, wd) == want
            n_f32 = (xd == torch.float32) + (wd == torch.float32)
            assert k7.products(xd, wd) == (1 if want == "wgmma" else 1 + n_f32)
    assert k7.products(torch.float32, torch.float32) == 3
    assert k7.products(torch.bfloat16, torch.float16) == 1
    assert k7.variant(torch.float64, torch.float64) == "none"
    assert k7.variant(torch.bfloat16, torch.float64) == "none"
    assert k7.products(torch.float64, torch.float32) == 0


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_expert_matmul_routes_like_the_reference(impl):
    rng = np.random.default_rng(3)
    e, d, f, blocks = 5, 128, 256, 7
    be = np.sort(rng.integers(0, e, blocks)).astype(np.int32)
    x = rng.standard_normal((blocks * TM, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
    want = np.asarray(jops.expert_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                                         impl="xla"))
    got = ops.expert_matmul(_t(x), _t(w), _t(be), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, k7.grouped_matmul_plain(_t(x), _t(w), _t(be)),
                               rtol=0, atol=0)
    with pytest.raises(SpgemmConfigError):
        ops.expert_matmul(_t(x), _t(w), _t(be), impl="triton")


@pytest.mark.parametrize("bad", ["t_not_128", "d_not_128", "f_not_128", "d_mismatch",
                                 "be_length", "be_int64", "f64"])
def test_grouped_matmul_refuses_what_the_kernel_does_not_take(bad):
    x, w, be = torch.randn(256, 128), torch.randn(3, 128, 128), torch.zeros(2, dtype=torch.int32)
    if bad == "t_not_128":
        x, be = torch.randn(192, 128), torch.zeros(1, dtype=torch.int32)
    elif bad == "d_not_128":
        x, w = torch.randn(256, 64), torch.randn(3, 64, 128)
    elif bad == "f_not_128":
        w = torch.randn(3, 128, 96)
    elif bad == "d_mismatch":
        w = torch.randn(3, 256, 128)
    elif bad == "be_length":
        be = torch.zeros(3, dtype=torch.int32)
    elif bad == "be_int64":
        be = be.long()
    elif bad == "f64":
        x = x.double()
    with pytest.raises(SpgemmInputError):
        k7.grouped_matmul(x, w, be)


ATTN_SHAPES = [(4, 2, 256, 64), (8, 8, 128, 32), (4, 1, 256, 64)]
ATTN_KWARGS = [dict(causal=True), dict(causal=True, window=64),
               dict(causal=True, softcap=30.0), dict(causal=False)]


def _qkv(hq, hkv, t, d, seed, dtype=np.float32, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return tuple(rng.standard_normal(s).astype(np.float32).astype(dtype)
                 for s in ((hq, t, d), (hkv, tk, d), (hkv, tk, d)))


@pytest.mark.parametrize("hq,hkv,t,d", ATTN_SHAPES)
@pytest.mark.parametrize("kwargs", ATTN_KWARGS, ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items()))
def test_flash_attention_matches_the_reference_kernel(hq, hkv, t, d, kwargs):
    q, k, v = _qkv(hq, hkv, t, d, hq + t + d)
    want = np.asarray(jflash(*(jnp.asarray(x) for x in (q, k, v)), block_q=64, block_k=64,
                             interpret=True, **kwargs))
    launches = k8.LAUNCHES
    got = k8.flash_attention(_t(q), _t(k), _t(v), block_q=64, block_k=64, **kwargs)
    assert k8.LAUNCHES == launches
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    oracle = np.asarray(jref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), **kwargs))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-3, atol=2e-3)


def test_flash_attention_bf16():
    q, k, v = _qkv(4, 2, 128, 64, 5, ml_dtypes.bfloat16)
    want = np.asarray(jflash(*(jnp.asarray(x) for x in (q, k, v)), block_q=64, block_k=64,
                             interpret=True), np.float32)
    got = k8.flash_attention(_t(q), _t(k), _t(v), block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, -128)])
def test_rows_without_a_live_key_give_the_mean_of_v(causal, window):
    """A window that masks every key (0 when causal; without the causal mask
    keys after the query stay live until the window is -T): the reference's
    kernel and oracle give the mean of V (uniform weights over -1e30 scores),
    not 0; so does the port."""
    q, k, v = _qkv(4, 2, 128, 32, 9)
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    mean_v = np.repeat(v.mean(axis=1, keepdims=True), 2, axis=0)  # GQA: h // 2
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(mean_v, got.shape),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jflash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window,
                             block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_attention_with_segment_pos_takes_the_plain_version():
    """Decode positions: queries at 40..47 over 64 keys, window 5."""
    q, k, v = _qkv(4, 2, 8, 64, 11, tk=64)
    pos = np.arange(40, 48, dtype=np.int32)
    want = np.asarray(jref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), window=5,
                                               segment_pos=jnp.asarray(pos)))
    for impl in ("auto", "pallas", "xla"):
        got = ops.attention(_t(q), _t(k), _t(v), window=5, segment_pos=_t(pos), impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_attention_routes_like_the_reference(impl):
    q, k, v = _qkv(4, 2, 256, 64, 13)
    want = np.asarray(jops.attention(*(jnp.asarray(x) for x in (q, k, v)), window=64,
                                     softcap=50.0, impl="xla"))
    launches = k8.LAUNCHES
    got = ops.attention(_t(q), _t(k), _t(v), window=64, softcap=50.0, impl=impl)
    assert k8.LAUNCHES == launches
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    with pytest.raises(SpgemmConfigError):
        ops.attention(_t(q), _t(k), _t(v), impl="sdpa")


@pytest.mark.parametrize("bad", ["gqa", "head_dim", "dtypes", "block_q", "kv_shape", "softcap0"])
def test_flash_attention_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = torch.randn(4, 128, 64), torch.randn(2, 128, 64), torch.randn(2, 128, 64)
    kw = {}
    if bad == "gqa":
        q = torch.randn(3, 128, 64)
    elif bad == "head_dim":
        q, k, v = torch.randn(4, 128, 48), torch.randn(2, 128, 48), torch.randn(2, 128, 48)
    elif bad == "dtypes":
        k = k.bfloat16()
    elif bad == "block_q":
        kw = dict(block_q=96)
    elif bad == "kv_shape":
        v = torch.randn(2, 64, 64)
    elif bad == "softcap0":
        kw = dict(softcap=0.0)
    with pytest.raises(SpgemmInputError):
        k8.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference_field_by_field(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for smoke in (False, True):
        got = configs.get_config(arch, smoke=smoke)
        want = jconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.resolved_head_dim == want.resolved_head_dim
    for shape in jconfigs.SHAPES:
        assert configs.skip_reason(arch, shape) == jconfigs.skip_reason(arch, shape)
    assert list(configs.all_cells()) == list(jconfigs.all_cells())
    assert {k: dataclasses.asdict(s) for k, s in configs.SHAPES.items()} == {
        k: dataclasses.asdict(s) for k, s in jconfigs.SHAPES.items()}


def test_config_errors_are_the_ports_typed_errors():
    with pytest.raises(SpgemmConfigError):
        configs.ModelConfig(name="x", family="dense", num_layers=3, d_model=8, num_heads=2,
                            num_kv_heads=1, d_ff=8, vocab_size=8, pattern=("local", "global"))

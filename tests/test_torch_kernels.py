"""The replay kernels' wrappers (K1 segsum_reuse, K2 lp_reuse), the build, and
the card tests of every kernel (K3 spgemm_lp, K4 spgemm_numeric and K5
spgemm_symbolic too, their CPU parity tests in tests/test_torch_ops.py; K6
bsr_spgemm, K7 grouped_matmul and K8 flash_attention, theirs in
tests/test_torch_bsr.py and tests/test_torch_attention.py).

On the CPU each wrapper runs its plain version, which is held against the
JAX package's host-loop oracle ``kernels.ref.segsum_reuse_ref`` (the
reference's Pallas kernels cannot run interpreted on this jax). f32 within
rtol/atol 1e-5; f16/bf16 operands against a float64 numpy oracle within
8e-3 * S, S being the sum of |products| of a segment: the plain version adds
in f32 and rounds once to the 8-bit-mantissa type. The tests marked ``cuda``
hold each CUDA kernel against its plain version on the card (K3 with and
without a forced, spilling L1, in every size class and on colliding keys;
K4 with windows past its shared columns) and
skip where there is none. This file imports JAX only inside the test that needs the
reference, so that on a machine with a card and no JAX the ``cuda`` tests
run with ``pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import ctypes
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.kernels import segsum_reuse as k1
from repro_torch.kernels import spgemm_lp as k2
from repro_torch.kernels import spgemm_lp as k3
from repro_torch.kernels import spgemm_numeric as k4
from repro_torch.kernels import spgemm_symbolic as k5
from repro_torch.runtime.validate import KernelFallbackError, SpgemmInputError
from repro_torch.sparse import CSR

WRAPPERS = {
    "segsum_reuse": (k1, k1.segsum_reuse_arrays, k1.segsum_reuse_plain),
    "lp_reuse": (k2, k2.lp_reuse_arrays, k2.lp_reuse_plain),
}
# (fm, nnz_cap, na, nb, tail, long_run): fm not a multiple of either tile,
# a sentinel tail, one segment spanning several tiles, a single product
PLANS = [(1003, 301, 200, 150, 37, 400), (37, 11, 9, 13, 5, 0), (1, 1, 1, 1, 0, 0),
         (640, 5, 7, 7, 0, 600)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


def _plan(fm, nnz_cap, na, nb, tail, long_run, seed):
    """numpy int32 plan arrays: sorted segments with random runs, one run of
    ``long_run`` products, ``tail`` sentinel products; random slots."""
    rng = np.random.default_rng(seed)
    live = fm - tail
    seg = np.sort(rng.integers(0, nnz_cap, live))
    if long_run and live > long_run + 2:
        seg[1:1 + long_run] = seg[1]
        seg = np.sort(seg)
    seg = np.concatenate([seg, np.full(tail, nnz_cap)]).astype(np.int32)
    a_slot = rng.integers(0, na, fm).astype(np.int32)
    b_slot = rng.integers(0, nb, fm).astype(np.int32)
    return a_slot, b_slot, seg


def ell_operands(m, n, k, r_a, r_b, seed):
    """numpy ELL operands with garbage past a_nnz and b_nnz (column ids up to
    3n and 2k, random values), distinct live columns per B row, and C's
    structure (c_idx sorted per row, c_nnz) from the live products. Shared
    with tests/test_torch_ops.py."""
    rng = np.random.default_rng(seed)
    a_nnz = rng.integers(0, r_a + 1, m).astype(np.int32)
    a_nnz[m // 2] = r_a
    a_idx = rng.integers(0, 3 * n, (m, r_a)).astype(np.int32)
    live_a = np.arange(r_a)[None, :] < a_nnz[:, None]
    a_idx[live_a] %= n
    b_nnz = rng.integers(0, r_b + 1, n).astype(np.int32)
    b_idx = rng.integers(0, 2 * k, (n, r_b)).astype(np.int32)
    for j in range(n):
        b_idx[j, :b_nnz[j]] = rng.choice(k, b_nnz[j], replace=False)
    a_val = rng.standard_normal((m, r_a)).astype(np.float32)
    b_val = rng.standard_normal((n, r_b)).astype(np.float32)
    cols = [sorted({int(b_idx[j, t]) for r in range(a_nnz[i]) for j in [a_idx[i, r]]
                    for t in range(b_nnz[j])}) for i in range(m)]
    c_nnz = np.array([len(c) for c in cols], np.int32)
    c_idx = np.zeros((m, max(c_nnz.max(), 1)), np.int32)
    for i, c in enumerate(cols):
        c_idx[i, :len(c)] = c
    return a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz


def bitmask_words(b_idx, b_nnz, k):
    """B's live structure as (n, ceil(k/32)) uint32 words."""
    words = np.zeros((b_idx.shape[0], -(-k // 32)), np.uint32)
    for j in range(b_idx.shape[0]):
        for c in b_idx[j, :b_nnz[j]]:
            words[j, c >> 5] |= np.uint32(1 << (int(c) & 31))
    return words


# ELL cases of the K3/K4/K5 tests: (m, n, k, rA, rB, seed)
ELL_CASES = [(12, 16, 20, 4, 5, 1), (9, 7, 300, 6, 9, 2), (5, 3, 13, 2, 3, 3)]


def _oracle64(a_slot, b_slot, seg, a, b, nnz_cap):
    """float64 sums and sums of |products| per segment (numpy)."""
    live = seg < nnz_cap
    prod = a.astype(np.float64)[a_slot[live]] * b.astype(np.float64)[b_slot[live]]
    out = np.zeros(nnz_cap)
    scale = np.zeros(nnz_cap)
    np.add.at(out, seg[live], prod)
    np.add.at(scale, seg[live], np.abs(prod))
    return out, scale


@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: f"fm{p[0]}")
def test_f32_replay_matches_reference_oracle(name, plan):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    mod, arrays, _ = WRAPPERS[name]
    fm, nnz_cap, na, nb, tail, long_run = plan
    a_slot, b_slot, seg = _plan(*plan, seed=fm)
    rng = np.random.default_rng(1)
    a = rng.standard_normal(na).astype(np.float32)
    b = rng.standard_normal(nb).astype(np.float32)
    want = np.asarray(jref.segsum_reuse_ref(a_slot, b_slot, seg, jnp.asarray(a),
                                            jnp.asarray(b), nnz_cap))
    launches = mod.LAUNCHES
    got = arrays(*(torch.from_numpy(x) for x in (a_slot, b_slot, seg, a, b)),
                 nnz_cap=nnz_cap)
    assert mod.LAUNCHES == launches  # CPU tensors never reach the kernel
    assert got.dtype == torch.float32 and got.shape == (nnz_cap,)
    np.testing.assert_allclose(want, got.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.float16, torch.float16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float16, torch.bfloat16)],
                         ids=["bf16", "f16", "bf16xf32", "f16xbf16"])
def test_half_precision_replay_against_float64(name, dtypes):
    _, arrays, plain = WRAPPERS[name]
    plan = PLANS[0]
    a_slot, b_slot, seg = (torch.from_numpy(x) for x in _plan(*plan, seed=3))
    g = torch.Generator().manual_seed(0)
    a = torch.randn(plan[2], generator=g).to(dtypes[0])
    b = torch.randn(plan[3], generator=g).to(dtypes[1])
    got = arrays(a_slot, b_slot, seg, a, b, nnz_cap=plan[1])
    assert got.dtype == torch.promote_types(*dtypes)
    torch.testing.assert_close(got, plain(a_slot, b_slot, seg, a, b, plan[1]),
                               rtol=0, atol=0)
    want, scale = _oracle64(a_slot.numpy(), b_slot.numpy(), seg.numpy(),
                            a.double().numpy(), b.double().numpy(), plan[1])
    tol = 8e-3 if got.dtype != torch.float32 else 1e-5
    assert np.all(np.abs(got.double().numpy() - want) <= tol * scale + 1e-6)


def test_both_plain_versions_are_one_function():
    a_slot, b_slot, seg = (torch.from_numpy(x) for x in _plan(*PLANS[0], seed=4))
    a = torch.randn(PLANS[0][2])
    b = torch.randn(PLANS[0][3])
    torch.testing.assert_close(k1.segsum_reuse_plain(a_slot, b_slot, seg, a, b, 301),
                               k2.lp_reuse_plain(a_slot, b_slot, seg, a, b, 301),
                               rtol=0, atol=0)


def _good_args():
    a_slot, b_slot, seg = (torch.from_numpy(x) for x in _plan(*PLANS[1], seed=5))
    return [a_slot, b_slot, seg, torch.randn(9), torch.randn(13)]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("bad", [
    ("a_slot_s", lambda t: t.long()),
    ("seg_ids", lambda t: t.float()),
    ("a_values", lambda t: t.double()),
    ("b_values", lambda t: t.to(torch.int32)),
    ("b_slot_s", lambda t: t[:-1]),
    ("a_values", lambda t: t.reshape(1, -1)),
    ("b_values", lambda t: t.repeat(2)[::2]),
    ("a_values", lambda t: t[:0]),
    ("seg_ids", lambda t: t.numpy()),
], ids=lambda b: b[0] if isinstance(b, tuple) else None)
def test_wrappers_refuse_what_the_kernels_do_not_take(name, bad):
    _, arrays, _ = WRAPPERS[name]
    args = _good_args()
    idx = ["a_slot_s", "b_slot_s", "seg_ids", "a_values", "b_values"].index(bad[0])
    args[idx] = bad[1](args[idx])
    with pytest.raises(SpgemmInputError):
        arrays(*args, nnz_cap=11)
    for nnz_cap in (-1, 2**31):  # the kernels keep ids and nnz_cap in int32
        with pytest.raises(SpgemmInputError, match="nnz_cap"):
            arrays(*_good_args(), nnz_cap=nnz_cap)


def test_build_names_libraries_by_content_and_raises_without_nvcc(monkeypatch, tmp_path):
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    for name, path in paths.items():
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", path.name)
        assert path.parent == _build.BUILD_DIR
        assert _build.library_path(name) == path  # deterministic
    assert paths["segsum_reuse"].name.split("-")[1] != paths["lp_reuse"].name.split("-")[1]
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    for flag in ("arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared"):
        assert flag in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "Path", lambda *_: tmp_path / "no-nvcc")
    with pytest.raises(KernelFallbackError, match="nvcc"):
        _build.build()


def test_c_interfaces_match_the_ctypes_signature():
    """Every replay library exports <name>_launch and <name>_launch_batched
    with the argument lists the wrappers declare (workspaces included),
    <name>_workspace_bytes, <name>_workspace_bytes_batched,
    <name>_tile_products and <name>_error_string; every source targets sm_90a
    (the ELL kernels' interface: tests/test_torch_ops.py)."""
    common = (_build.CSRC_DIR / "replay_tile.cuh").read_text()
    api = common[common.index("#define REPLAY_C_API"):].replace("\\\n", "")
    c_types = {"ptr": ctypes.c_void_p, "int64_t": ctypes.c_int64, "int": ctypes.c_int}
    for entry, argtypes in (("launch", k1._ARGTYPES), ("launch_batched", k1._ARGTYPES_BATCHED)):
        params = re.search(rf"NAME##_{entry}\((.*?)\)\s*\{{", api, re.S).group(1)
        declared = ["ptr" if "*" in p else p.split()[0] for p in params.split(",")]
        assert [c_types[t] for t in declared] == argtypes, entry
    assert "NAME##_workspace_bytes(int64_t fm)" in api
    assert "NAME##_workspace_bytes_batched(int64_t fm, int64_t batch)" in api
    assert "NAME##_tile_products()" in api
    for name in WRAPPERS:
        assert re.search(rf"REPLAY_C_API\({name}, \w+, \w+Batched, kTile\)",
                         (_build.CSRC_DIR / f"{name}.cu").read_text())
    for name in _build.SOURCES:
        assert "sm_90a" in (_build.CSRC_DIR / f"{name}.cu").read_text()


# chip_smoke.py's builders of the replay kernels' edge plans (one builder
# serves phase 2 and these tests)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
EDGE_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float16, torch.float16), (torch.bfloat16, torch.float32)]


def _oracle_clamped(a_slot, b_slot, seg, a, b, nnz_cap):
    """float64 sums and sums of |products| per slot, ids outside [0, nnz_cap)
    dropped and slots clamped into the value buffers (numpy)."""
    live = (seg >= 0) & (seg < nnz_cap)
    prod = (a.astype(np.float64)[np.clip(a_slot[live], 0, a.shape[0] - 1)]
            * b.astype(np.float64)[np.clip(b_slot[live], 0, b.shape[0] - 1)])
    out, scale = np.zeros(nnz_cap), np.zeros(nnz_cap)
    np.add.at(out, seg[live], prod)
    np.add.at(scale, seg[live], np.abs(prod))
    return out, scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_libraries_have_the_tiles_the_edge_plans_are_cut_to(cuda, name):
    """K1 takes 2,048 products a tile, K2 1,024 (each .cu's kTile)."""
    assert k1.tile_products(name) == cs.REPLAY_TILES[name]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("case", range(len(cs.EDGE_CASES)), ids=cs.EDGE_CASES)
def test_edge_plans_match_float64(name, case):
    """On the CPU the wrappers take every edge plan (views at offsets too)
    and agree with a float64 oracle in every dtype pair."""
    mod, arrays, _ = WRAPPERS[name]
    g = torch.Generator().manual_seed(1)
    _, a_slot, b_slot, seg, nnz_cap, na, nb = cs.edge_plans(cs.REPLAY_TILES[name], g,
                                                            dev="cpu")[case]
    plan = [x.numpy() for x in (a_slot, b_slot, seg)]
    for adt, bdt in EDGE_DTYPES:
        a = torch.randn(na, generator=g).to(adt)
        b = torch.randn(nb, generator=g).to(bdt)
        launches = mod.LAUNCHES
        got = arrays(a_slot, b_slot, seg, a, b, nnz_cap=nnz_cap)
        assert mod.LAUNCHES == launches
        assert got.dtype == torch.promote_types(adt, bdt) and got.shape == (nnz_cap,)
        want, scale = _oracle_clamped(*plan, a.double().numpy(), b.double().numpy(), nnz_cap)
        tol = 1e-5 if got.dtype == torch.float32 else 8e-3
        assert np.all(np.abs(got.double().numpy() - want) <= tol * scale + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("case", range(len(cs.EDGE_CASES)), ids=cs.EDGE_CASES)
def test_kernel_writes_every_slot_of_edge_plans_on_the_card(cuda, name, case):
    """Each edge plan in every dtype pair, the output handed memory full of
    NaN by the caching allocator: a slot the kernel leaves unwritten shows."""
    mod, arrays, plain = WRAPPERS[name]
    g = torch.Generator(device=cuda).manual_seed(2)
    _, a_slot, b_slot, seg, nnz_cap, na, nb = cs.edge_plans(cs.REPLAY_TILES[name], g,
                                                            dev="cuda")[case]
    for adt, bdt in EDGE_DTYPES:
        a = torch.randn(na, generator=g, device=cuda).to(adt)
        b = torch.randn(nb, generator=g, device=cuda).to(bdt)
        want = plain(a_slot, b_slot, seg, a, b, nnz_cap)
        scale = plain(a_slot, b_slot, seg, a.float().abs(), b.float().abs(), nnz_cap)
        junk = torch.full((nnz_cap,), float("nan"), device=cuda)
        del junk
        launches = mod.LAUNCHES
        got = arrays(a_slot, b_slot, seg, a, b, nnz_cap=nnz_cap)
        torch.cuda.synchronize()
        assert mod.LAUNCHES == launches + 1
        assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
        tol = 1e-4 if want.dtype == torch.float32 else 8e-3
        assert bool(((got.double() - want.double()).abs()
                     <= tol * scale.double() + 1e-6).all())


# the batched launches: (module, batched entry, single entry)
BATCHED = {
    "segsum_reuse": (k1, k1.segsum_reuse_batched_arrays, k1.segsum_reuse_arrays),
    "lp_reuse": (k2, k2.lp_reuse_batched_arrays, k2.lp_reuse_arrays),
}
# how the values are stacked: (rows, A stacked, B stacked, element offset of
# the stacked rows in their buffer)
STACKS = {"batch3": (3, True, True, 0), "a_shared": (3, False, True, 1),
          "b_shared": (3, True, False, 2), "views_3": (3, True, True, 3),
          "stack_of_1": (1, True, True, 0)}


def _stacked(n, rows, stacked, offset, g, dev, dtype=torch.float32):
    """(rows, n) values as a view at ``offset`` elements into a larger
    buffer, or one shared (n,) row."""
    if not stacked:
        return torch.randn(n, generator=g, device=dev).to(dtype)
    buf = torch.randn(offset + rows * n, generator=g, device=dev).to(dtype)
    return buf[offset:].view(rows, n)


def _row(v, i):
    return v[i] if v.ndim == 2 else v


@pytest.mark.parametrize("name", sorted(BATCHED))
@pytest.mark.parametrize("case", range(len(cs.EDGE_CASES)), ids=cs.EDGE_CASES)
def test_batched_edge_plans_match_float64(name, case):
    """On the CPU the batched entry points take every edge plan in every
    stacking (shared operands, rows at offsets, a stack of one), launch
    nothing, and each row agrees with the float64 oracle."""
    mod, batched, _ = BATCHED[name]
    g = torch.Generator().manual_seed(3)
    _, a_slot, b_slot, seg, nnz_cap, na, nb = cs.edge_plans(cs.REPLAY_TILES[name], g,
                                                            dev="cpu")[case]
    plan = [x.numpy() for x in (a_slot, b_slot, seg)]
    for rows, a_st, b_st, off in STACKS.values():
        a = _stacked(na, rows, a_st, off, g, "cpu")
        b = _stacked(nb, rows, b_st, off, g, "cpu")
        launches = mod.BATCHED_LAUNCHES
        got = batched(a_slot, b_slot, seg, a, b, nnz_cap=nnz_cap)
        assert mod.BATCHED_LAUNCHES == launches
        assert got.shape == (rows, nnz_cap) and got.dtype == torch.float32
        for i in range(rows):
            want, scale = _oracle_clamped(*plan, _row(a, i).double().numpy(),
                                          _row(b, i).double().numpy(), nnz_cap)
            assert np.all(np.abs(got[i].double().numpy() - want) <= 1e-5 * scale + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BATCHED))
@pytest.mark.parametrize("case", range(len(cs.EDGE_CASES)), ids=cs.EDGE_CASES)
def test_batched_launch_matches_replay_batched_on_the_card(cuda, name, case):
    """One batched launch per stacking of each edge plan, right after a
    NaN-filled tensor of the output's size is freed, within F32_TOL of the
    executor's plain ``_replay_batched``; K1's rows equal its single launch
    bit for bit (a row's adds do not depend on the batch)."""
    from repro_torch.core import executor as texec

    mod, batched, single = BATCHED[name]
    g = torch.Generator(device=cuda).manual_seed(4)
    _, a_slot, b_slot, seg, nnz_cap, na, nb = cs.edge_plans(cs.REPLAY_TILES[name], g,
                                                            dev="cuda")[case]
    plan = cs.plan_arrays(a_slot, b_slot, seg, nnz_cap)
    for rows, a_st, b_st, off in STACKS.values():
        for bdt in (torch.float32, torch.bfloat16):
            a = _stacked(na, rows, a_st, off, g, cuda)
            b = _stacked(nb, rows, b_st, off, g, cuda, bdt)
            want = texec._replay_batched(plan, a, b)
            scale = texec._replay_batched(plan, a.abs(), b.float().abs())
            junk = torch.full((rows, nnz_cap), float("nan"), device=cuda)
            del junk
            launches = mod.BATCHED_LAUNCHES
            got = batched(a_slot, b_slot, seg, a, b, nnz_cap=nnz_cap)
            torch.cuda.synchronize()
            assert mod.BATCHED_LAUNCHES == launches + 1
            assert got.shape == (rows, nnz_cap) and got.dtype == torch.float32
            assert bool(torch.isfinite(got).all())
            assert bool(((got.double() - want.double()).abs()
                         <= 1e-4 * scale.double() + 1e-6).all())
            if name == "segsum_reuse":
                for i in range(rows):
                    assert torch.equal(got[i], single(a_slot, b_slot, seg, _row(a, i),
                                                      _row(b, i), nnz_cap=nnz_cap))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "pallas_lp"])
def test_apply_batched_is_one_batched_launch_on_the_card(cuda, backend):
    """``ReuseExecutor.apply_batched`` with a kernel backend on the card: one
    batched launch of that kernel, no plain stage, values within F32_TOL of
    ``_replay_batched``."""
    from repro_torch.core import executor as texec
    from repro_torch.core.spgemm import STAGE_COUNTS
    from repro_torch.sparse import generators

    a = generators.random_csr(300, 200, 6.0, 1, device=cuda)
    b = generators.random_csr(200, 250, 6.0, 2, device=cuda)
    ex = texec.ReuseExecutor.from_matrices(a, b, backend=backend, plan_cache=False)
    mod = k1 if backend == "pallas" else k2
    g = torch.Generator(device=cuda).manual_seed(0)
    a_rows = torch.randn(5, a.nnz_cap, generator=g, device=cuda)
    STAGE_COUNTS.clear()
    launches = mod.BATCHED_LAUNCHES
    got = ex.apply_batched(a_rows, b.values)
    torch.cuda.synchronize()
    assert mod.BATCHED_LAUNCHES == launches + 1 and not STAGE_COUNTS
    want = texec._replay_batched(ex.plan, a_rows, b.values)
    scale = texec._replay_batched(ex.plan, a_rows.abs(), b.values.abs())
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16xf32"])
def test_kernel_matches_plain_on_the_card(cuda, name, dtypes):
    mod, arrays, plain = WRAPPERS[name]
    for plan in PLANS + [(200_003, 30_011, 5000, 7000, 77, 5000)]:
        a_slot, b_slot, seg = (torch.from_numpy(x).to(cuda) for x in _plan(*plan, seed=6))
        g = torch.Generator(device=cuda).manual_seed(0)
        a = torch.randn(plan[2], generator=g, device=cuda).to(dtypes[0])
        b = torch.randn(plan[3], generator=g, device=cuda).to(dtypes[1])
        launches = mod.LAUNCHES
        got = arrays(a_slot, b_slot, seg, a, b, nnz_cap=plan[1])
        torch.cuda.synchronize()
        assert mod.LAUNCHES == launches + 1
        want = plain(a_slot, b_slot, seg, a, b, plan[1])
        scale = plain(a_slot, b_slot, seg, a.float().abs(), b.float().abs(), plan[1])
        tol = 1e-4 if want.dtype == torch.float32 else 8e-3
        assert got.dtype == want.dtype
        assert bool(((got.double() - want.double()).abs()
                     <= tol * scale.double() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_refuses_f64_and_mixed_devices_on_the_card(cuda, name):
    _, arrays, _ = WRAPPERS[name]
    args = [t.to(cuda) for t in _good_args()]
    with pytest.raises(SpgemmInputError):
        arrays(*args[:3], args[3].double(), args[4], nnz_cap=11)
    with pytest.raises(SpgemmInputError):
        arrays(*args[:3], args[3].cpu(), args[4], nnz_cap=11)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16xf32"])
@pytest.mark.parametrize("l1_size", [None, 4])
def test_kernels_match_plain_on_the_card(cuda, dtypes, l1_size):
    for case in ELL_CASES + [(60, 80, 70_001, 90, 200, 4)]:
        a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = (
            torch.from_numpy(x).to(cuda) for x in ell_operands(*case))
        k = case[2]
        a_val, b_val = a_val.to(dtypes[0]), b_val.to(dtypes[1])
        b_val0 = torch.where(torch.arange(b_idx.shape[1], device=cuda)[None, :]
                             < b_nnz[:, None], b_val, 0).to(dtypes[1])
        words = convert.bitmask_from_numpy(bitmask_words(*(x.cpu().numpy() for x in
                                                      (b_idx, b_nnz)), k), cuda)
        launches = (k5.LAUNCHES, k4.LAUNCHES, k3.NUMERIC_LAUNCHES)
        sizes = k5.spgemm_symbolic(a_idx, a_nnz, words)
        got4 = k4.spgemm_numeric(a_idx, a_val, a_nnz, b_idx, b_val0, c_idx, c_nnz, k=k)
        got3 = k3.spgemm_lp(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                            l1_size=l1_size, k=k)
        torch.cuda.synchronize()
        assert (k5.LAUNCHES, k4.LAUNCHES, k3.NUMERIC_LAUNCHES) == tuple(
            n + 1 for n in launches)
        assert torch.equal(sizes, c_nnz)
        assert torch.equal(sizes, k5.spgemm_symbolic_plain(a_idx, a_nnz, words))
        for got, plain, bv in (
                (got4, lambda av, bv: k4.spgemm_numeric_plain(
                    a_idx, av, a_nnz, b_idx, bv, c_idx, c_nnz, k=k), b_val0),
                (got3, lambda av, bv: k3.spgemm_lp_plain(
                    a_idx, av, a_nnz, b_idx, bv, b_nnz, c_idx, c_nnz, k=k), b_val)):
            want = plain(a_val, bv)
            scale = plain(a_val.float().abs(), bv.float().abs())
            tol = 1e-4 if want.dtype == torch.float32 else 8e-3
            assert got.dtype == want.dtype
            assert bool(((got.double() - want.double()).abs()
                         <= tol * scale.double() + 1e-6).all())


def _log_widths(rng, count, top):
    """Widths in [0, top], log-uniform: as many in [1, 2] as in [top/2, top]."""
    return np.minimum(np.floor(np.exp(rng.random(count) * np.log(top + 1))) - 1,
                      top).astype(np.int32)


def _ell_with_structure(a_idx, a_nnz, b_idx, b_nnz, k, seed):
    """Values and C's structure (vectorised) for numpy ELL index arrays."""
    rng = np.random.default_rng(seed)
    m, r_a = a_idx.shape
    rows, rs = np.nonzero(np.arange(r_a)[None, :] < a_nnz[:, None])
    j = a_idx[rows, rs]
    ok = np.arange(b_idx.shape[1])[None, :] < b_nnz[j][:, None]
    keys = np.unique((rows[:, None].astype(np.int64) * k + b_idx[j])[ok])
    c_rows = keys // k
    c_nnz = np.bincount(c_rows, minlength=m).astype(np.int32)
    start = np.concatenate([[0], np.cumsum(c_nnz)[:-1]])
    c_idx = np.zeros((m, max(int(c_nnz.max()), 1)), np.int32)
    c_idx[c_rows, np.arange(keys.shape[0]) - start[c_rows]] = keys % k
    a_val = rng.standard_normal(a_idx.shape).astype(np.float32)
    b_val = rng.standard_normal(b_idx.shape).astype(np.float32)
    return (a_idx.astype(np.int32), a_val, a_nnz, b_idx.astype(np.int32), b_val, b_nnz,
            c_idx, c_nnz)


def lp_class_operands(m, n, k, r_a, r_b, seed, stride=1):
    """ELL operands with log-uniform A and B widths, so C's rows reach every
    K3 size class and some rows have no product; garbage past a_nnz and
    b_nnz; distinct live columns per B row, times ``stride`` (k then
    k * stride)."""
    rng = np.random.default_rng(seed)
    a_nnz = _log_widths(rng, m, r_a)
    a_nnz[m // 2] = r_a
    a_idx = rng.integers(0, 3 * n, (m, r_a))
    live = np.arange(r_a)[None, :] < a_nnz[:, None]
    a_idx[live] %= n
    b_nnz = _log_widths(rng, n, r_b)
    base = rng.integers(0, k, (n, 1))
    step = rng.integers(1, k // r_b + 1, (n, 1))
    cols = (base + step * np.arange(r_b)[None, :]) % k
    b_live = np.arange(r_b)[None, :] < b_nnz[:, None]
    b_idx = np.where(b_live, cols, rng.integers(0, 2 * k, (n, r_b))) * stride
    return _ell_with_structure(a_idx, a_nnz, b_idx, b_nnz, k * stride, seed)


def lp_collision_operands(k, counts, seed):
    """Row i has one A entry, B row i, whose counts[i] keys all share home
    slot 0 of the row's per-row table under K3's multiplicative hash (found
    by brute force over [0, k)); a last row has no product."""
    cand = np.arange(k, dtype=np.int64)
    r_b = max(counts)
    b_idx = np.full((len(counts), r_b), k, np.int64)
    for i, c in enumerate(counts):
        size = 1 << max(2 * c - 1, 7).bit_length()  # the row's table: >= max(2c, 8)
        keys = cand[k3.lp_home_slot(torch.from_numpy(cand), size).numpy() == 0][:c]
        assert keys.shape[0] == c
        b_idx[i, :c] = keys
    m = len(counts) + 1
    a_idx = np.concatenate([np.arange(m - 1), [0]])[:, None]
    a_nnz = np.ones(m, np.int32)
    a_nnz[-1] = 0
    return _ell_with_structure(a_idx, a_nnz, b_idx, np.array(counts, np.int32), k, seed)


# K3 cases over its size classes: name -> a function that makes the operands
LP_CLASS_CASES = {
    "every class": lambda: lp_class_operands(600, 600, 70_001, 160, 400, seed=21),
    "one home slot": lambda: lp_collision_operands(
        1 << 24, [1, 3, 4, 7, 15, 31, 63, 127, 255, 511, 1023, 2047], seed=22),
    "multiples of 2^16": lambda: lp_class_operands(600, 600, 4096, 24, 48, seed=23,
                                                   stride=1 << 16),
    "k < 32": lambda: lp_class_operands(40, 30, 13, 6, 9, seed=24),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16xf32"])
@pytest.mark.parametrize("l1_size", [None, 4])
@pytest.mark.parametrize("case", sorted(LP_CLASS_CASES))
def test_lp_kernel_matches_plain_in_every_size_class_on_the_card(cuda, case, l1_size,
                                                                 dtypes):
    """K3 (tables binned into size classes) against its plain version: rows of
    every class (the widest with tables in device memory), spilling
    (l1_size 4) or not, rows of no product, keys on one home slot, keys that
    are multiples of 2^16, k < 32."""
    arrays = LP_CLASS_CASES[case]()
    k = {"every class": 70_001, "one home slot": 1 << 24, "multiples of 2^16": 4096 << 16,
         "k < 32": 13}[case]
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = (
        torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in arrays)
    a_val, b_val = a_val.to(dtypes[0]), b_val.to(dtypes[1])
    cls = k3.lp_row_class(c_nnz, l1_size)
    assert bool((cls == -1).any())  # rows of no product
    if case == "every class":
        assert set(cls.tolist()) == set(range(-1, len(k3.CLASS_SLOTS) + 1))
    launches = k3.NUMERIC_LAUNCHES
    got = k3.spgemm_lp(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                       l1_size=l1_size, k=k)
    torch.cuda.synchronize()
    assert k3.NUMERIC_LAUNCHES == launches + 1
    want = k3.spgemm_lp_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                              l1_size=l1_size, k=k)
    scale = k3.spgemm_lp_plain(a_idx, a_val.float().abs(), a_nnz, b_idx,
                               b_val.float().abs(), b_nnz, c_idx, c_nnz, k=k)
    tol = 1e-4 if want.dtype == torch.float32 else 8e-3
    assert got.dtype == want.dtype
    assert bool(((got.double() - want.double()).abs()
                 <= tol * scale.double() + 1e-6).all())


def lp_lost_product_operands():
    """ELL operands whose C structure lists fewer columns than some rows'
    products reach, so that K3's tables, sized from c_nnz, fill: row 0 is
    one A entry whose B row has columns 0-8 (values 1-9) with c_nnz 1 and
    column 8 listed (the plain sum is 9); row 1 lists 3 of 40 columns, the
    last three, which arrive after a 16-slot table (L1 4 + L2 8 at l1_size
    4, 8 slots otherwise) is full; row 2 has its full structure; row 3 no
    product; row 4 lists every 30th of 3,000 columns (a 256-slot table);
    row 5 has three A entries whose B rows give 120 columns, 5 listed."""
    b_rows = [np.arange(9), np.arange(40), np.array([3, 5, 7]), np.arange(3000),
              np.arange(0, 120, 3), np.arange(1, 120, 3), np.arange(2, 120, 3)]
    r_b = max(len(r) for r in b_rows)
    b_idx = np.full((len(b_rows), r_b), 5000, np.int32)  # padded slots: column 5000
    b_val = np.full((len(b_rows), r_b), 1e6, np.float32)  # never read: masked
    for j, cols in enumerate(b_rows):
        b_idx[j, :len(cols)] = cols
        b_val[j, :len(cols)] = np.arange(len(cols)) % 17 + 1  # row 0: 1-9
    b_nnz = np.array([len(r) for r in b_rows], np.int32)
    a_idx = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 0, 0], [3, 0, 0], [4, 5, 6]],
                     np.int32)
    a_nnz = np.array([1, 1, 1, 0, 1, 3], np.int32)
    a_val = np.ones(a_idx.shape, np.float32)
    a_val[5] = [0.5, -2.0, 3.0]
    c_lists = [[8], [37, 38, 39], [3, 5, 7], [], list(range(0, 3000, 30)),
               [0, 1, 2, 60, 119]]
    c_idx = np.zeros((len(c_lists), 100), np.int32)
    for i, cols in enumerate(c_lists):
        c_idx[i, :len(cols)] = cols
    c_nnz = np.array([len(c) for c in c_lists], np.int32)
    return a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16xf32"])
@pytest.mark.parametrize("l1_size", [None, 4])
def test_lp_kernel_loses_no_product_when_the_structure_is_short(cuda, l1_size, dtypes):
    """Rows whose products reach more columns than c_nnz lists fill K3's
    tables; the kernel lists them and the wrapper runs them again (a second
    launch) in tables sized by their products: every listed column gets all
    its products, as in the plain version."""
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = (
        torch.from_numpy(x).to(cuda) for x in lp_lost_product_operands())
    a_val, b_val = a_val.to(dtypes[0]), b_val.to(dtypes[1])
    launches = k3.NUMERIC_LAUNCHES
    got = k3.spgemm_lp(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                       l1_size=l1_size, k=5000)
    torch.cuda.synchronize()
    assert k3.NUMERIC_LAUNCHES == launches + 2  # the rows that lost a product, again
    want = k3.spgemm_lp_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                              l1_size=l1_size, k=5000)
    scale = k3.spgemm_lp_plain(a_idx, a_val.float().abs(), a_nnz, b_idx,
                               b_val.float().abs(), b_nnz, c_idx, c_nnz, k=5000)
    assert float(want[0, 0]) == 9.0 and float(got[0, 0]) == 9.0
    tol = 1e-4 if want.dtype == torch.float32 else 8e-3
    assert got.dtype == want.dtype
    assert bool(((got.double() - want.double()).abs()
                 <= tol * scale.double() + 1e-6).all())


@pytest.mark.cuda
def test_ops_path_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import ops
    from repro_torch.sparse.generators import random_csr

    ta = random_csr(4, 32, 16.0, 11, device="cpu")
    tb = random_csr(32, 64, 32.0, 111, device="cpu")
    want = ops.pallas_spgemm(ta, tb)
    tac = CSR(*(x.to(cuda) for x in (ta.indptr, ta.indices, ta.values)), ta.shape)
    tbc = CSR(*(x.to(cuda) for x in (tb.indptr, tb.indices, tb.values)), tb.shape)
    got = ops.pallas_spgemm(tac, tbc)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5, atol=1e-5)
    with pytest.raises(SpgemmInputError):
        k5.spgemm_symbolic(torch.zeros(2, 2, dtype=torch.int32, device=cuda),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, 2, dtype=torch.int32, device=cuda))


# ---------------------------------------------------------------------------
# K6 bsr_spgemm, K7 grouped_matmul, K8 flash_attention (their CPU parity
# tests: tests/test_torch_bsr.py and tests/test_torch_attention.py)
# ---------------------------------------------------------------------------

def _c_launch_argtypes(name):
    """The ctypes types of ``<name>_launch``'s C parameters in csrc/<name>.cu."""
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    params = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*\{{', src, re.S).group(1)
    c_types = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else c_types[p.split()[0]]
            for p in params.split(",")]


@pytest.mark.parametrize("name", ["bsr_spgemm", "grouped_matmul", "flash_attention",
                                  "plan_columns"])
def test_new_c_interfaces_match_their_ctypes_signatures(name):
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    assert _c_launch_argtypes(name) == mod._ARGTYPES
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    assert f'extern "C" const char* {name}_error_string(int code)' in src
    assert name in _build.SOURCES


def test_k7_comparison_build_is_never_the_ports():
    """scripts/k7_variants.py builds K7 with every pair on "fma" through a
    macro that the port's flags never set."""
    src = (_build.CSRC_DIR / "grouped_matmul.cu").read_text()
    assert "defined(GROUPED_MATMUL_FORCE_VARIANT)" in src
    assert not any("GROUPED_MATMUL_FORCE_VARIANT" in flag for flag in _build.NVCC_FLAGS)


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values, emulated on their int32 view:
    round the 13 low mantissa bits to nearest, ties away from zero (adding
    half a TF32 ulp to the magnitude bits), then clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split(v: torch.Tensor) -> tuple:
    """(big, small) as the "tf32" variant of K7 splits an f32 operand; a
    16-bit operand is exact in TF32 and has no small part."""
    if v.dtype != torch.float32:
        return v.float(), None
    big = _tf32_rna(v)
    return big, _tf32_rna(v - big)


def _grouped_f64(x, w, be) -> torch.Tensor:
    """y[t] = x[t] @ w[be[t // 128]] in f64, block by block."""
    e = w.shape[0]
    rows = [x[i * 128:(i + 1) * 128].double() @ w[int(ex)].double()
            for i, ex in enumerate(be.clamp(0, e - 1).tolist())]
    return torch.cat(rows)


def _split_tf32_product(x, w, be, passes: str = "split") -> torch.Tensor:
    """K7's "tf32" arithmetic on the CPU: each product of TF32 parts exact
    (in f64), the small terms first, xs @ ws dropped; ``passes="one"`` is a
    single TF32 product of the big parts. Returns f64."""
    (xb, xs), (wb, ws) = _tf32_split(x), _tf32_split(w)
    terms = [(xb, wb)] if passes == "one" else \
        [(p, q) for p, q in ((xs, wb), (xb, ws), (xb, wb)) if p is not None and q is not None]
    return sum(_grouped_f64(p, q, be) for p, q in terms)


def test_tf32_emulation_rounds_to_nearest_ties_away():
    """The emulated ``cvt.rna.tf32.f32``: below half a TF32 ulp rounds down,
    a tie rounds away from zero in either sign, above rounds up; the 13 low
    bits come out clear and the error is at most half a TF32 ulp."""
    ulp = 2.0 ** -10  # TF32 keeps 10 explicit mantissa bits
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + ulp / 2 + 2.0 ** -23, 1 + 1.5 * ulp, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + 2 * ulp, 3.0, -0.0])
    got = _tf32_rna(v)
    assert torch.equal(got, want) and torch.equal(got.view(torch.int32) & 0x1FFF,
                                                  torch.zeros(7, dtype=torch.int32))
    r = torch.randn(100_000, generator=torch.Generator().manual_seed(0)) * 1e3
    big = _tf32_rna(r)
    assert bool(((r - big).abs() <= r.abs() * 2.0 ** -11).all())
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    small = _tf32_rna(r - big)  # the split's second part: at most 2^-11 of big
    assert bool((small.abs() <= big.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("pair", ["f32", "f32xbf16", "f32xf16", "bf16xf32", "bf16xf16"])
def test_split_tf32_keeps_the_f32_bound_where_one_pass_does_not(pair):
    """K7's "tf32" arithmetic emulated on the CPU at narrow MoE widths: the
    split's 3 (f32 x f32) or 2 (one f32 operand) exact TF32 products, or 1
    (bf16 x f16), stay within K7_FRO[f32] of the f64 product of the
    operands as given; one pass of TF32 over f32 operands misses it by two
    orders of magnitude, so the bound tells the two designs apart. The
    products counted are ``products``'s."""
    import importlib

    k7 = importlib.import_module("repro_torch.kernels.grouped_matmul")
    xd, wd = K7_PAIRS[pair]
    g = torch.Generator().manual_seed(len(pair))
    e, d, f, blocks = 4, 512, 256, 5
    be = torch.randint(0, e, (blocks,), generator=g, dtype=torch.int32)
    x = torch.randn(blocks * 128, d, generator=g).to(xd)
    w = (torch.randn(e, d, f, generator=g) * 0.05).to(wd)
    exact = _grouped_f64(x, w, be)
    split = _split_tf32_product(x, w, be)
    n_terms = 1 + (xd == torch.float32) + (wd == torch.float32)
    assert k7.products(xd, wd) == n_terms

    def rel(y):
        return float((y - exact).norm() / exact.norm())

    assert rel(split) <= K7_FRO[torch.float32] / 10
    if torch.float32 in (xd, wd):
        assert rel(_split_tf32_product(x, w, be, passes="one")) > 10 * K7_FRO[torch.float32]
    else:  # two 16-bit operands: one pass is the exact product
        assert rel(split) == 0.0


def _split_tf32_attention(q, k, v, *, softcap, block_k, passes: str = "split"):
    """K8's "tf32" arithmetic on the CPU, causal: per key stage of
    ``block_k`` keys S = Q K^T as the split's three exact TF32 products (the
    small terms first, qs @ ks dropped), the softcap and the masks, the
    online softmax, P (rounded to f32, as the kernel holds it) @ V as three
    exact TF32 products, folded as O = alpha O + P V. Everything but the
    TF32 operands is f64, so that only the split's error shows;
    ``passes="one"``: one TF32 product of the big parts instead."""
    def product(a, b):
        (ab, as_), (bb, bs) = _tf32_split(a), _tf32_split(b)
        terms = [(ab, bb)] if passes == "one" else [(as_, bb), (ab, bs), (ab, bb)]
        return sum(x.double() @ y.double() for x, y in terms)

    hq, t, d = q.shape
    group = hq // k.shape[0]
    live = torch.arange(t)[:, None] >= torch.arange(t)[None, :]
    out = []
    for h in range(hq):
        kh, vh = k[h // group], v[h // group]
        m = torch.full((t, 1), -1e30, dtype=torch.float64)
        l = torch.zeros(t, 1, dtype=torch.float64)
        o = torch.zeros(t, d, dtype=torch.float64)
        for k0 in range(0, t, block_k):
            s = product(q[h], kh[k0:k0 + block_k].T) / math.sqrt(d)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(live[:, k0:k0 + block_k], s, -1e30)
            m_new = torch.maximum(m, s.amax(1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = l * alpha + p.sum(1, keepdim=True)
            o = o * alpha + product(p.float(), vh[k0:k0 + block_k])
            m = m_new
        out.append(o / l)
    return torch.stack(out)


@pytest.mark.parametrize("d,block_k", [(64, 64), (256, 32)], ids=["d64", "d256"])
@pytest.mark.parametrize("softcap", [50.0, None], ids=["saturated_softcap", "no_cap"])
def test_split_tf32_attention_keeps_the_f32_bound_where_one_pass_does_not(d, block_k, softcap):
    """K8's "tf32" arithmetic emulated on the CPU (the kernel's key stages
    at each D) with q and k scaled by 8: scores in the hundreds, so a
    softcap saturates and, without one, the softmax is near one-hot. The
    split stays within K8_FRO[f32] / 10 of an f64 attention of the same
    operands; one pass of TF32 over them misses K8_FRO[f32]."""
    g = torch.Generator().manual_seed(d)
    q = torch.randn(2, 256, d, generator=g) * 8
    k = torch.randn(1, 256, d, generator=g) * 8
    v = torch.randn(1, 256, d, generator=g)
    scores = q.double() @ k[0].double().T / math.sqrt(d)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(torch.ones(256, 256, dtype=torch.bool).tril(), scores, -1e30)
    exact = torch.softmax(scores, -1) @ v[0].double()

    def rel(y):
        return float((y - exact).norm() / exact.norm())

    bound = _K8_FRO[torch.float32]
    assert rel(_split_tf32_attention(q, k, v, softcap=softcap, block_k=block_k)) <= bound / 10
    assert rel(_split_tf32_attention(q, k, v, softcap=softcap, block_k=block_k,
                                     passes="one")) > bound


def _synthetic_bsr_plan(nnzb_a, nnzb_b, nnzb_c, t_max, seed, device):
    """Random plan arrays whose live slots never name block 0 and whose
    padded slots all do (as plan_bsr_numeric pads them)."""
    g = torch.Generator().manual_seed(seed)
    n = torch.randint(0, t_max + 1, (nnzb_c,), generator=g, dtype=torch.int32)
    live = torch.arange(t_max)[None, :] < n[:, None]
    ca = torch.where(live, torch.randint(1, nnzb_a, (nnzb_c, t_max), generator=g), 0)
    cb = torch.where(live, torch.randint(1, nnzb_b, (nnzb_c, t_max), generator=g), 0)
    return (ca.to(torch.int32).to(device), cb.to(torch.int32).to(device), n.to(device))


K6_PAIRS = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
            "bf16xf32": (torch.bfloat16, torch.float32), "f16": (torch.float16, torch.float16),
            "f16xbf16": (torch.float16, torch.bfloat16)}


def test_bsr_tile_constants_mirror_the_source():
    """TILE_BLOCKS and A_SPAN_BLOCKS (the tile_a_spans rule) are kTile and
    kASpan of csrc/bsr_spgemm.cu at each block size."""
    from repro_torch.kernels import bsr_spgemm as k6

    src = (_build.CSRC_DIR / "bsr_spgemm.cu").read_text()
    for name, mirror in (("kTile", k6.TILE_BLOCKS), ("kASpan", k6.A_SPAN_BLOCKS)):
        at8, at16 = re.search(rf"static constexpr int {name} = BS == 8 \? (\d+) : (\d+);",
                              src).groups()
        assert mirror == {8: int(at8), 16: int(at16)}, name
    assert set(k6.TILE_BLOCKS) == set(k6.A_SPAN_BLOCKS) == set(k6.BLOCK_SIZES)


def _edge_bsr_plans(bs, device):
    """(name, nnzb_a, nnzb_b, contrib_a, contrib_b, contrib_n) of K6's edge
    plans at block size ``bs``: a plan of plan_bsr_numeric (every tile's A
    span staged), random plans over many A blocks (spans too wide: A read
    from device memory), nnzb_c of 1, of the tile size +- 1 and not a
    multiple of it, T_max 1 and 33 (a plan too wide to stage), counts below
    0 and above T_max, and blocks with no live slot. Live slots never name
    block 0; padded slots all do."""
    from repro_torch import sparse as rt_sparse
    from repro_torch.kernels import bsr_spgemm as k6

    tile = k6.TILE_BLOCKS[bs]
    _, a, _ = rt_sparse.galerkin_triple(32, 32, agg_size=4, device=device)
    nnzb = int(a.indptr[-1])
    ip, ix = a.indptr, a.indices[:nnzb].contiguous()
    c_ip, c_ix, ca, cb, cn = k6.plan_bsr_numeric(ip, ix, ip, ix)
    # shift every slot by one so that block 0 is only named by padded slots
    live = torch.arange(ca.shape[1], device=device)[None, :] < cn[:, None]
    plans = [("plan_bsr_numeric", nnzb + 1, nnzb + 1, torch.where(live, ca + 1, 0),
              torch.where(live, cb + 1, 0), cn)]
    g = torch.Generator().manual_seed(bs)
    for name, nnzb_a, nnzb_b, nnzb_c, t_max, n_lo, n_hi in (
            ("random, wide spans", 5000, 3000, 3 * tile + 7, 5, 0, 5),
            ("nnzb_c 1", 40, 30, 1, 3, 1, 3),
            ("tile - 1", 50, 60, tile - 1, 4, 0, 4),
            ("tile + 1", 50, 60, tile + 1, 4, 0, 4),
            ("T_max 1", 9, 7, 2 * tile + 3, 1, 0, 1),
            ("T_max 33", 500, 400, tile + 5, 33, 0, 33),
            ("counts outside [0, T_max]", 60, 70, 2 * tile, 6, -4, 11)):
        n = torch.randint(n_lo, n_hi + 1, (nnzb_c,), generator=g, dtype=torch.int32)
        n[0] = min(max(n_hi, 0), t_max)
        keep = torch.arange(t_max)[None, :] < n.clamp(0, t_max)[:, None]
        ca = torch.where(keep, torch.randint(1, nnzb_a, (nnzb_c, t_max), generator=g), 0)
        cb = torch.where(keep, torch.randint(1, nnzb_b, (nnzb_c, t_max), generator=g), 0)
        plans.append((name, nnzb_a, nnzb_b, ca.to(torch.int32).to(device),
                      cb.to(torch.int32).to(device), n.to(device)))
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16])
def test_bsr_kernel_writes_every_block_of_edge_plans_on_the_card(cuda, bs):
    """Each edge plan in every dtype pair, A's and B's block 0 NaN (only
    padded slots name it) and the output handed memory full of NaN by the
    caching allocator: a C block left unwritten or a padded slot read shows.
    Both tile paths run: the plan of plan_bsr_numeric stages every tile's A
    span, the wide random plan stages none."""
    from repro_torch.kernels import bsr_spgemm as k6

    g = torch.Generator(device=cuda).manual_seed(3)
    for name, nnzb_a, nnzb_b, ca, cb, cn in _edge_bsr_plans(bs, cuda):
        spans = k6.tile_a_spans(ca, cn, bs, nnzb_a)
        if name == "plan_bsr_numeric":
            assert bool((spans <= k6.A_SPAN_BLOCKS[bs]).all()), name
        if name == "random, wide spans":
            assert bool((spans > k6.A_SPAN_BLOCKS[bs]).all()), name
        for pair, (adt, bdt) in K6_PAIRS.items():
            a = torch.randn(nnzb_a, bs, bs, generator=g, device=cuda).to(adt)
            b = torch.randn(nnzb_b, bs, bs, generator=g, device=cuda).to(bdt)
            a[0] = b[0] = 0
            scale = k6.bsr_spgemm_plain(a.float().abs(), b.float().abs(), ca, cb, cn)
            a[0] = b[0] = float("nan")
            want = k6.bsr_spgemm_plain(a, b, ca, cb, cn)
            junk = torch.full((ca.shape[0], bs, bs), float("nan"), dtype=adt, device=cuda)
            del junk
            launches = k6.LAUNCHES
            got = k6.bsr_spgemm_numeric(a, b, ca, cb, cn)
            torch.cuda.synchronize()
            assert k6.LAUNCHES == launches + 1
            assert got.dtype == want.dtype == adt and got.shape == want.shape
            assert bool(torch.isfinite(got.float()).all()), f"{name} {pair}"
            tol = 1e-4 if adt == torch.float32 else 8e-3
            assert bool(((got.double() - want.double()).abs()
                         <= tol * scale.double() + 1e-6).all()), f"{name} {pair}"
            assert bool((got[cn <= 0] == 0).all()), f"{name} {pair}"
    # views that do not start on 16 bytes (the kernel's loads need it) are
    # copied by the wrapper
    name, nnzb_a, nnzb_b, ca, cb, cn = _edge_bsr_plans(bs, cuda)[1]
    a = torch.randn(nnzb_a * bs * bs + 1, generator=g, device=cuda)[1:].view(nnzb_a, bs, bs)
    b = torch.randn(nnzb_b, bs, bs, generator=g, device=cuda)
    ca_view = torch.cat([ca.new_zeros(1), ca.flatten()])[1:].view(ca.shape)
    assert a.data_ptr() % 16 and ca_view.data_ptr() % 16
    got = k6.bsr_spgemm_numeric(a, b, ca_view, cb, cn)
    torch.testing.assert_close(got, k6.bsr_spgemm_plain(a, b, ca, cb, cn), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtypes", list(K6_PAIRS.values()), ids=list(K6_PAIRS))
def test_bsr_kernel_matches_plain_on_the_card(cuda, bs, dtypes):
    from repro_torch.kernels import bsr_spgemm as k6

    for nnzb_a, nnzb_b, nnzb_c, t_max in ((40, 50, 300, 5), (3, 2, 1, 1), (500, 700, 20_011, 9)):
        ca, cb, cn = _synthetic_bsr_plan(nnzb_a, nnzb_b, nnzb_c, t_max, nnzb_c, cuda)
        g = torch.Generator(device=cuda).manual_seed(bs)
        a = torch.randn(nnzb_a, bs, bs, generator=g, device=cuda).to(dtypes[0])
        b = torch.randn(nnzb_b, bs, bs, generator=g, device=cuda).to(dtypes[1])
        a[0] = float("nan")  # only padded slots name block 0: nothing may leak
        b[0] = float("nan")
        launches = k6.LAUNCHES
        got = k6.bsr_spgemm_numeric(a, b, ca, cb, cn)
        torch.cuda.synchronize()
        assert k6.LAUNCHES == launches + 1
        want = k6.bsr_spgemm_plain(a, b, ca, cb, cn)
        assert got.dtype == want.dtype == dtypes[0]
        assert bool(torch.isfinite(got.float()).all())
        tol = 1e-4 if dtypes[0] == torch.float32 else 3e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(SpgemmInputError):
        k6.bsr_spgemm_numeric(torch.zeros(2, 4, 4, device=cuda), torch.zeros(2, 4, 4, device=cuda),
                              *_synthetic_bsr_plan(2, 2, 1, 1, 0, cuda))


# K7's tolerance per x dtype (the reference's tests) and its relative
# Frobenius bound (chip_smoke.py's K7_FRO)
K7_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2, torch.float16: 3e-2}
K7_FRO = {torch.float32: 5e-6, torch.bfloat16: 6e-4, torch.float16: 3e-4}
K7_PAIRS = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
            "f16": (torch.float16, torch.float16), "bf16xf32": (torch.bfloat16, torch.float32),
            "f16xbf16": (torch.float16, torch.bfloat16), "f32xbf16": (torch.float32, torch.bfloat16),
            "f32xf16": (torch.float32, torch.float16), "f16xf32": (torch.float16, torch.float32),
            "bf16xf16": (torch.bfloat16, torch.float16)}


def _k7_check(k7, x, w, be):
    """One launch of K7 against its plain version: the launch count, the
    dtype, K7_TOL and K7_FRO."""
    launches = k7.LAUNCHES
    got = k7.grouped_matmul(x, w, be)
    torch.cuda.synchronize()
    assert k7.LAUNCHES == launches + 1
    want = k7.grouped_matmul_plain(x, w, be)
    tol = K7_TOL[x.dtype]
    assert got.dtype == x.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _rel_fro(got, want) <= K7_FRO[x.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(K7_PAIRS), ids=list(K7_PAIRS))
def test_grouped_matmul_kernel_matches_plain_on_the_card(cuda, dtype):
    """Each variant ("wgmma" for bf16 and f16 pairs, "tf32" for the others) on
    several widths, the MoE projections' (d, f) = (768, 2048) and (2048,
    768) among them, and one token block; the library names the variant
    that ``variant`` names and counts the products that ``products``
    counts."""
    import importlib

    k7 = importlib.import_module("repro_torch.kernels.grouped_matmul")

    xd, wd = K7_PAIRS[dtype]
    lib = _build.load("grouped_matmul")
    fn, n_products = lib.grouped_matmul_variant, lib.grouped_matmul_products
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_char_p
    n_products.argtypes, n_products.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    codes = (k1.DTYPE_CODES[xd], k1.DTYPE_CODES[wd])
    assert fn(*codes).decode() == k7.variant(xd, wd)
    assert n_products(*codes) == k7.products(xd, wd)
    for e, d, f, blocks in ((4, 256, 256, 6), (8, 128, 384, 4), (16, 512, 128, 9),
                            (3, 768, 2048, 5), (3, 2048, 768, 5), (2, 256, 128, 1)):
        g = torch.Generator(device=cuda).manual_seed(d + f)
        be = torch.sort(torch.randint(0, e, (blocks,), generator=g, device=cuda)).values
        x = torch.randn(blocks * 128, d, generator=g, device=cuda).to(xd)
        w = (torch.randn(e, d, f, generator=g, device=cuda) * 0.1).to(wd)
        _k7_check(k7, x, w, be.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(K7_PAIRS), ids=list(K7_PAIRS))
def test_grouped_matmul_kernel_clamps_expert_ids_on_the_card(cuda, dtype):
    """Expert ids below 0 and past E clamp into [0, E), unsorted; expert 2 of
    4 owns no block."""
    import importlib

    k7 = importlib.import_module("repro_torch.kernels.grouped_matmul")
    xd, wd = K7_PAIRS[dtype]
    g = torch.Generator(device=cuda).manual_seed(7)
    be = torch.tensor([3, -5, 0, 9, 1, 4, -1, 3], dtype=torch.int32, device=cuda)
    x = torch.randn(be.shape[0] * 128, 256, generator=g, device=cuda).to(xd)
    w = (torch.randn(4, 256, 384, generator=g, device=cuda) * 0.1).to(wd)
    _k7_check(k7, x, w, be)
    clamped = k7.grouped_matmul(x, w, be.clamp(0, 3))
    assert torch.equal(k7.grouped_matmul(x, w, be), clamped)
    assert 2 not in be.clamp(0, 3).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(4, 2, 256, 256, 64), (8, 8, 128, 128, 32),
                                   (2, 1, 96, 96, 256), (2, 2, 128, 192, 128),
                                   (2, 1, 64, 320, 16), (2, 1, 136, 200, 256),
                                   (2, 1, 64, 40, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_kernel_matches_plain_on_the_card(cuda, dtype, shape):
    import importlib

    k8 = importlib.import_module("repro_torch.kernels.flash_attention")

    hq, hkv, tq, tk, d = shape
    g = torch.Generator(device=cuda).manual_seed(tq + d)
    q = torch.randn(hq, tq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(hkv, tk, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(hkv, tk, d, generator=g, device=cuda).to(dtype)
    tol = 2e-3 if dtype == torch.float32 else 5e-2
    if dtype == torch.float32:
        assert k8.variant(dtype, d) == ("tf32" if d >= 64 else "fma")
    else:
        assert k8.variant(dtype, d) == ("wgmma" if d >= 64 else "mma")
    for kw in (dict(causal=True), dict(causal=True, window=64), dict(causal=False),
               dict(causal=True, softcap=30.0), dict(causal=True, window=0),
               dict(causal=False, window=3), dict(causal=True, softcap=50.0)):
        launches = k8.LAUNCHES
        got = k8.flash_attention(q, k, v, block_q=math.gcd(tq, 128),
                                 block_k=math.gcd(tk, 128), **kw)
        torch.cuda.synchronize()
        assert k8.LAUNCHES == launches + 1
        want = k8.flash_attention_plain(q, k, v, **kw)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{kw}: {m}")
        assert _rel_fro(got, want) <= _K8_FRO[dtype], kw


# ||kernel - plain||_F / ||plain||_F bounds of K8, as in chip_smoke.py
_K8_FRO = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _rel_fro(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(2, 1, 136, 200, 256), (4, 2, 192, 192, 256),
                                   (4, 1, 128, 192, 128), (2, 1, 256, 256, 32),
                                   (4, 2, 128, 200, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_kernel_holds_a_saturated_softcap_on_the_card(cuda, dtype, shape):
    """q and k scaled by 8: scores in the hundreds, so tanh saturates and the
    softcap decides the output; the same output without the softcap fails
    the check."""
    import importlib

    k8 = importlib.import_module("repro_torch.kernels.flash_attention")

    hq, hkv, tq, tk, d = shape
    g = torch.Generator(device=cuda).manual_seed(tq + d + 8)
    q = (torch.randn(hq, tq, d, generator=g, device=cuda) * 8).to(dtype)
    k = (torch.randn(hkv, tk, d, generator=g, device=cuda) * 8).to(dtype)
    v = torch.randn(hkv, tk, d, generator=g, device=cuda).to(dtype)
    tol = 2e-3 if dtype == torch.float32 else 5e-2
    for kw in (dict(causal=True, softcap=50.0), dict(causal=False, softcap=30.0)):
        got = k8.flash_attention(q, k, v, block_q=math.gcd(tq, 128),
                                 block_k=math.gcd(tk, 128), **kw)
        want = k8.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{kw}: {m}")
        assert _rel_fro(got, want) <= _K8_FRO[dtype], kw
        uncapped = k8.flash_attention_plain(q, k, v, causal=kw["causal"])
        assert _rel_fro(uncapped, want) > _K8_FRO[dtype], kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_flash_attention_kernel_takes_operands_off_16_byte_alignment(cuda, dtype):
    import importlib

    k8 = importlib.import_module("repro_torch.kernels.flash_attention")

    g = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn(1 + 2 * 128 * 64, generator=g, device=cuda).to(dtype)
    q = base[1:].view(2, 128, 64)  # one element past an aligned address
    k = torch.randn(1, 128, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, 128, 64, generator=g, device=cuda).to(dtype)
    assert q.data_ptr() % 16 != 0
    got = k8.flash_attention(q, k, v, causal=True, block_q=128, block_k=128)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), k8.flash_attention_plain(q, k, v).float(),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# a fresh multiply's numeric phase: K1 on the card (core.spgemm.fresh_values)
# --------------------------------------------------------------------------

FRESH_DTYPES = {  # (A, B) value dtypes -> what sums them on the card, and its dtype key
    "f32": ((torch.float32, torch.float32), "pallas", None),
    "bf16xf32": ((torch.bfloat16, torch.float32), "pallas", None),
    "bf16xf16": ((torch.bfloat16, torch.float16), "pallas", None),
    "bf16": ((torch.bfloat16, torch.bfloat16), "xla", None),
    "f16": ((torch.float16, torch.float16), "xla", None),
    "f64": ((torch.float64, torch.float64), "xla", "dtype:fresh->xla"),
    "int32": ((torch.int32, torch.int32), "xla", "dtype:fresh->xla"),
}


def _fresh_operands(device, dtypes=(torch.float32, torch.float32)):
    from repro_torch.sparse import generators

    a = generators.random_csr(120, 90, 5.0, 3, device=device)
    b = generators.random_csr(90, 110, 5.0, 4, device=device)
    g = torch.Generator(device=device).manual_seed(5)
    vals = [(torch.randn(x.nnz_cap, generator=g, device=device) * 4).to(dt)
            for x, dt in zip((a, b), dtypes)]
    return (CSR(a.indptr, a.indices, vals[0], a.shape),
            CSR(b.indptr, b.indices, vals[1], b.shape))


def _fresh(a, b):
    """A fresh sparse multiply, the K1 and K2 launches it made, and the
    FALLBACK_COUNTS it left."""
    from repro_torch.core import spgemm
    from repro_torch.core.telemetry import FALLBACK_COUNTS

    FALLBACK_COUNTS.clear()
    before = (k1.LAUNCHES, k2.LAUNCHES)
    res = spgemm(a, b, method="sparse", plan_cache=False)
    if a.values.device.type == "cuda":
        torch.cuda.synchronize()
    return res, (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]), dict(FALLBACK_COUNTS)


@pytest.mark.parametrize("case", sorted(FRESH_DTYPES))
def test_fresh_multiply_routes_by_dtype_under_the_card_rules(case, monkeypatch):
    """On the CPU with the card's rules forced (``ladder.kernels_only``): the
    route of ``FRESH_DTYPES``, values bitwise the plain ``numeric_reuse``
    (the K1 wrapper runs its plain version on CPU tensors), the dtype key
    only where the dtype guard refuses the kernels."""
    from repro_torch.core import numeric_reuse
    from repro_torch.core.spgemm import fresh_backend
    from repro_torch.runtime import ladder

    dtypes, backend, key = FRESH_DTYPES[case]
    a, b = _fresh_operands("cpu", dtypes)
    assert fresh_backend(a.values, b.values) == "xla"  # the CPU's own rule
    monkeypatch.setattr(ladder, "kernels_only", lambda device: True)
    res, _, fallbacks = _fresh(a, b)
    assert res.stats["replay_backend"] == backend
    assert fallbacks == ({key: 1} if key else {})
    assert res.c.values.dtype == torch.promote_types(*dtypes)
    assert torch.equal(res.c.values, numeric_reuse(res.plan, a.values, b.values))


def test_fresh_multiply_steps_k1_to_k2_under_the_card_rules(monkeypatch):
    """An armed ``kernel:pallas`` steps the fresh multiply to K2 (one
    ``fault:pallas->pallas_lp``), never to the plain version; both armed
    raise ``KernelFallbackError``."""
    from repro_torch.core import spgemm
    from repro_torch.runtime import faults, ladder

    monkeypatch.setattr(ladder, "kernels_only", lambda device: True)
    a, b = _fresh_operands("cpu")
    try:
        with faults.failpoint("kernel:pallas"):
            res, _, fallbacks = _fresh(a, b)
        assert res.stats["replay_backend"] == "pallas_lp"
        assert fallbacks == {"fault:pallas->pallas_lp": 1}
        with faults.failpoint("kernel:pallas"), faults.failpoint("kernel:pallas_lp"):
            with pytest.raises(KernelFallbackError):
                spgemm(a, b, method="sparse", plan_cache=False)
    finally:
        faults.reset_failpoints()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FRESH_DTYPES))
def test_fresh_multiply_routes_by_dtype_on_the_card(cuda, case):
    """f32-summed pairs through one K1 launch ("pallas", no plain stage),
    within F32_TOL of the plain ``numeric_reuse``; bf16 x bf16 and f16 x f16
    (the reference sums them in their own dtype), f64 and int32 through the
    plain path, the last two counted under ``dtype:fresh->xla``."""
    from repro_torch.core import numeric_reuse
    from repro_torch.core.spgemm import STAGE_COUNTS

    dtypes, backend, key = FRESH_DTYPES[case]
    a, b = _fresh_operands(cuda, dtypes)
    STAGE_COUNTS.clear()
    res, launches, fallbacks = _fresh(a, b)
    assert res.stats["replay_backend"] == backend
    assert launches == ((1, 0) if backend == "pallas" else (0, 0))
    assert fallbacks == ({key: 1} if key else {})
    assert (STAGE_COUNTS["numeric_reuse"] == 0) == (backend == "pallas")
    if backend == "pallas":
        want = numeric_reuse(res.plan, a.values.float(), b.values.float())
        scale = numeric_reuse(res.plan, a.values.float().abs(), b.values.float().abs())
        assert res.c.values.dtype == torch.float32
        assert bool(((res.c.values.double() - want.double()).abs()
                     <= 1e-4 * scale.double() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["multigrid A*P", "rmat A*A"])
def test_fresh_multiply_repeats_bit_for_bit_on_the_card(cuda, shape):
    """Two fresh multiplies (no plan cache) give the same bits: K1 adds in a
    fixed order, where the plain ``index_add_``'s atomics do not. One K1
    launch each; values within F32_TOL of the plain version; the traced
    ``numeric.dispatch`` span says "pallas"."""
    from repro_torch import obs
    from repro_torch.core import numeric_fresh, numeric_reuse
    from repro_torch.sparse import generators

    if shape == "multigrid A*P":
        _, a, b = generators.galerkin_triple(256, 256, agg_size=4, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(8)
        a = CSR(a.indptr, a.indices, torch.randn(a.nnz_cap, generator=g, device=cuda), a.shape)
    else:
        a = b = generators.rmat_csr(12, 8, seed=0, device=cuda)
    obs.reset_obs()
    with obs.trace_scope("on"):
        first, launches, fallbacks = _fresh(a, b)
    kinds = [e["args"].get("kernel") for e in obs.events() if e["name"] == "numeric.dispatch"]
    obs.reset_obs()
    second, again, _ = _fresh(a, b)
    assert launches == again == (1, 0) and fallbacks == {}
    assert kinds == ["pallas"] and first.stats["replay_backend"] == "pallas"
    assert torch.equal(first.c.values, second.c.values)
    want = numeric_reuse(first.plan, a.values, b.values)
    scale = numeric_reuse(first.plan, a.values.abs(), b.values.abs())
    assert bool(((first.c.values.double() - want.double()).abs()
                 <= 1e-4 * scale.double() + 1e-6).all())
    c, _ = numeric_fresh(a, b, first.stats["fm_cap"], first.stats["nnz_cap"])
    assert torch.equal(c.values, first.c.values)


@pytest.mark.cuda
def test_default_replay_runs_k1_and_repeats_bit_for_bit_on_the_card(cuda):
    """``ReuseExecutor(plan)`` ("auto") on the card: an f32 A*P replay is one
    K1 launch (no K2, no plain ``numeric_reuse``), two replays are bitwise
    equal and within F32_TOL of the plain version; ``apply_batched`` is one
    batched K1 launch whose rows are the single launch's bits; bf16 x bf16
    takes the plain replay (the reference sums it in bf16) with no launch
    and no key."""
    from repro_torch.core import ReuseExecutor, numeric_reuse, spgemm
    from repro_torch.core.spgemm import STAGE_COUNTS
    from repro_torch.core.telemetry import FALLBACK_COUNTS
    from repro_torch.sparse import generators

    _, a, p = generators.galerkin_triple(256, 256, agg_size=4, device=cuda)
    ex = ReuseExecutor(spgemm(a, p, method="sparse", plan_cache=False).plan)
    g = torch.Generator(device=cuda).manual_seed(9)
    av = torch.randn(a.nnz_cap, generator=g, device=cuda)
    FALLBACK_COUNTS.clear()
    before = (k1.LAUNCHES, k2.LAUNCHES, k1.BATCHED_LAUNCHES, STAGE_COUNTS["numeric_reuse"])
    first, second = ex.apply(av, p.values), ex.apply(av, p.values)
    batched = ex.apply_batched(torch.stack([av, -av]), p.values)
    torch.cuda.synchronize()
    after = (k1.LAUNCHES, k2.LAUNCHES, k1.BATCHED_LAUNCHES, STAGE_COUNTS["numeric_reuse"])
    assert [y - x for x, y in zip(before, after)] == [2, 0, 1, 0]
    assert ex.last_backend == "pallas" and not FALLBACK_COUNTS
    assert torch.equal(first, second) and torch.equal(batched[0], first)
    want = numeric_reuse(ex.plan, av, p.values)
    scale = numeric_reuse(ex.plan, av.abs(), p.values.abs())
    assert bool(((first.double() - want.double()).abs() <= 1e-4 * scale.double() + 1e-6).all())
    launches = k1.LAUNCHES
    got = ex.apply(av.bfloat16(), p.values.bfloat16())
    torch.cuda.synchronize()
    assert k1.LAUNCHES == launches and ex.last_backend == "xla" and not FALLBACK_COUNTS
    assert got.dtype == torch.bfloat16  # summed in bf16 by index_add_, in any order
    assert bool(((got.double() - want.double()).abs() <= 2e-2 * scale.double() + 1e-2).all())

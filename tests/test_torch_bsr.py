"""K6, the block-sparse (BSR) SpGEMM of the port, against the JAX package.

``repro_torch.kernels.plan_bsr_numeric`` (vectorised on the device) must
return the reference's host-loop plan bit for bit: C's block structure and
the contributions of every C block in the reference's order, T_max 1 for an
empty C. The numeric phase's plain version (what the wrapper runs on the
CPU) is held against the reference's Pallas kernel in interpret mode and its
numpy oracle ``bsr_spgemm_ref``: f32 within 1e-4 (rtol and atol, the
reference's own test), bf16 within 8e-3 * S, one bf16 rounding of the f32
sum, S being the sum of |products| of the block entry. The CUDA kernel's
card tests are in tests/test_torch_kernels.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.kernels import bsr_spgemm as jbsr
from repro_torch import convert
from repro_torch.kernels import bsr_spgemm as k6
from repro_torch.kernels import bsr_spgemm_numeric, plan_bsr_numeric
from repro_torch.runtime.validate import SpgemmInputError


def _structure(mb, kb, max_per_row, seed, empty_rows=()):
    """numpy BSR structure: 0..max_per_row distinct sorted columns per block
    row (the rows in ``empty_rows`` have none)."""
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(kb, rng.integers(0, min(max_per_row, kb) + 1), replace=False))
            if i not in empty_rows else np.zeros(0, np.int64) for i in range(mb)]
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])]).astype(np.int32)
    return indptr, np.concatenate(cols + [np.zeros(0)]).astype(np.int32)


def _blocks(nnzb, bs, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nnzb, bs, bs)).astype(np.float32).astype(dtype)


# (mb, nb, kb, max blocks per row, empty A rows, empty B rows, seed)
STRUCTURES = [
    (6, 5, 7, 3, (), (), 1),
    (9, 8, 12, 4, (0, 4), (2,), 2),
    (1, 1, 1, 1, (), (), 3),
    (40, 30, 50, 5, (7, 8, 39), (0, 29), 4),
    (5, 4, 6, 3, (0, 1, 2, 3, 4), (), 5),  # A has no blocks: C is empty
    (4, 3, 5, 2, (), (0, 1, 2), 6),  # B has no blocks: C is empty
]


def _operands(case):
    mb, nb, kb, per_row, empty_a, empty_b, seed = case
    a_ip, a_ix = _structure(mb, nb, per_row, seed, empty_a)
    b_ip, b_ix = _structure(nb, kb, per_row, seed + 50, empty_b)
    return a_ip, a_ix, b_ip, b_ix


@pytest.mark.parametrize("case", STRUCTURES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}s{c[6]}")
def test_plan_equals_the_reference_bitwise(case):
    a_ip, a_ix, b_ip, b_ix = _operands(case)
    want = jbsr.plan_bsr_numeric(a_ip, a_ix, b_ip, b_ix)
    got = plan_bsr_numeric(*(torch.from_numpy(x) for x in (a_ip, a_ix, b_ip, b_ix)))
    for name, w, g in zip(("c_indptr", "c_indices", "contrib_a", "contrib_b", "contrib_n"),
                          want, got):
        assert g.dtype == torch.int32 and w.dtype == np.int32, name
        assert tuple(g.shape) == w.shape, name
        assert np.array_equal(g.numpy(), w), name
    if case[6] in (5, 6):
        assert got[2].shape == (0, 1)  # empty C: T_max defaults to 1


def test_plan_takes_int64_structure_and_a_padded_index_array():
    a_ip, a_ix, b_ip, b_ix = _operands(STRUCTURES[1])
    want = jbsr.plan_bsr_numeric(a_ip, a_ix, b_ip, b_ix)
    padded = np.concatenate([a_ix, np.full(5, 10**6, np.int32)])  # slots past indptr[-1]
    got = plan_bsr_numeric(torch.from_numpy(a_ip.astype(np.int64)), torch.from_numpy(padded),
                           torch.from_numpy(b_ip.astype(np.int64)),
                           torch.from_numpy(b_ix.astype(np.int64)))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), w)


def _scale(a_bl, b_bl, plan):
    return k6.bsr_spgemm_plain(a_bl.float().abs(), b_bl.float().abs(), *plan[2:])


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", STRUCTURES[:4], ids=lambda c: f"s{c[6]}")
def test_plain_numeric_matches_the_reference_kernel_and_oracle(case, bs, dtype):
    a_ip, a_ix, b_ip, b_ix = _operands(case)
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    a_bl = _blocks(len(a_ix), bs, case[6], np_dtype)
    b_bl = _blocks(len(b_ix), bs, case[6] + 7, np_dtype)
    plan = jbsr.plan_bsr_numeric(a_ip, a_ix, b_ip, b_ix)
    want = np.asarray(jbsr.bsr_spgemm_numeric(
        jnp.asarray(a_bl), jnp.asarray(b_bl), *(jnp.asarray(x) for x in plan[2:]),
        interpret=True)).astype(np.float32)
    oracle = jbsr.bsr_spgemm_ref(a_bl.astype(np.float32), a_ip, a_ix, b_bl.astype(np.float32),
                                 b_ip, b_ix, plan[0], plan[1])
    tplan = convert.bsr_plan_from_numpy(*plan, device="cpu")
    ta, tb = (convert.tensor_from_numpy(x, "cpu") for x in (a_bl, b_bl))
    launches = k6.LAUNCHES
    got = bsr_spgemm_numeric(ta, tb, *tplan[2:])
    assert k6.LAUNCHES == launches  # CPU tensors never reach the kernel
    assert got.dtype == ta.dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)
    else:
        bound = 8e-3 * _scale(ta, tb, tplan).numpy() + 1e-6
        assert np.all(np.abs(got - want) <= bound)
        assert np.all(np.abs(got - oracle) <= bound)


def test_densified_product_equals_scipy_bsr_in_float64():
    bs = 8
    a_ip, a_ix, b_ip, b_ix = _operands(STRUCTURES[3])
    mb, nb, kb = STRUCTURES[3][:3]
    a_bl, b_bl = _blocks(len(a_ix), bs, 11), _blocks(len(b_ix), bs, 12)
    c_ip, c_ix, ca, cb, cn = plan_bsr_numeric(*(torch.from_numpy(x)
                                                for x in (a_ip, a_ix, b_ip, b_ix)))
    got = bsr_spgemm_numeric(torch.from_numpy(a_bl), torch.from_numpy(b_bl), ca, cb, cn)
    sa = sp.bsr_matrix((a_bl.astype(np.float64), a_ix, a_ip), shape=(mb * bs, nb * bs))
    sb = sp.bsr_matrix((b_bl.astype(np.float64), b_ix, b_ip), shape=(nb * bs, kb * bs))
    sc = sp.bsr_matrix((got.double().numpy(), c_ix.numpy(), c_ip.numpy()),
                       shape=(mb * bs, kb * bs))
    np.testing.assert_allclose(sc.toarray(), (sa @ sb).toarray(), rtol=1e-4, atol=1e-4)


def test_reuse_same_plan_new_values():
    """One plan, two numeric phases with new block values: the Reuse case at
    block granularity, each against the reference's kernel."""
    bs = 8
    a_ip, a_ix, b_ip, b_ix = _operands(STRUCTURES[1])
    plan = plan_bsr_numeric(*(torch.from_numpy(x) for x in (a_ip, a_ix, b_ip, b_ix)))
    jplan = [jnp.asarray(x.numpy()) for x in plan]
    for step in range(3):
        a_bl, b_bl = _blocks(len(a_ix), bs, 20 + step), _blocks(len(b_ix), bs, 30 + step)
        got = bsr_spgemm_numeric(torch.from_numpy(a_bl), torch.from_numpy(b_bl), *plan[2:])
        want = jbsr.bsr_spgemm_numeric(jnp.asarray(a_bl), jnp.asarray(b_bl), *jplan[2:],
                                       interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_padded_slots_are_skipped_so_a_nan_in_block_0_does_not_leak():
    """Padded contribution slots name block 0. With A's and B's block 0 NaN
    and no live slot naming them, C stays finite, as in the reference's
    kernel (which selects, not multiplies by 0)."""
    rng = np.random.default_rng(7)
    nnzb_a, nnzb_b, nnzb_c, t_max, bs = 12, 9, 30, 4, 8
    cn = rng.integers(0, t_max + 1, nnzb_c).astype(np.int32)
    cn[0] = t_max
    live = np.arange(t_max)[None, :] < cn[:, None]
    ca = np.where(live, rng.integers(1, nnzb_a, (nnzb_c, t_max)), 0).astype(np.int32)
    cb = np.where(live, rng.integers(1, nnzb_b, (nnzb_c, t_max)), 0).astype(np.int32)
    a_bl, b_bl = _blocks(nnzb_a, bs, 8), _blocks(nnzb_b, bs, 9)
    a_bl[0] = np.nan
    b_bl[0] = np.nan
    got = bsr_spgemm_numeric(*(torch.from_numpy(x) for x in (a_bl, b_bl, ca, cb, cn)))
    assert bool(torch.isfinite(got).all())
    want = jbsr.bsr_spgemm_numeric(*(jnp.asarray(x) for x in (a_bl, b_bl, ca, cb, cn)),
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert np.all(got.numpy()[cn == 0] == 0)


def _galerkin_plans():
    """The 5-point block operator of galerkin_triple(64, 64, 4), squared: the
    reference's plan (numpy) and the port's."""
    from repro.sparse import galerkin_triple

    _, a, _ = galerkin_triple(64, 64, agg_size=4)
    nnzb = int(a.indptr[-1])
    ip, ix = np.asarray(a.indptr).astype(np.int32), np.asarray(a.indices)[:nnzb].astype(np.int32)
    return ip, ix, ip, ix


@pytest.mark.parametrize("bs", k6.BLOCK_SIZES)
@pytest.mark.parametrize("case", STRUCTURES + ["galerkin 64^2"],
                         ids=lambda c: c if isinstance(c, str) else f"s{c[6]}")
def test_tiles_of_plans_fit_the_a_staging_buffer(case, bs):
    """The CUDA kernel stages a tile's A blocks in shared memory when the
    live A slots of its TILE_BLOCKS[bs] consecutive C blocks span at most
    A_SPAN_BLOCKS[bs] blocks. In the reference's plans (and the port's, bit
    for bit the same) every tile's span fits: consecutive C blocks come in
    block-row order with their A slots ascending."""
    ops = _galerkin_plans() if isinstance(case, str) else _operands(case)
    want = jbsr.plan_bsr_numeric(*ops)
    got = plan_bsr_numeric(*(torch.from_numpy(x) for x in ops))
    assert np.array_equal(got[2].numpy(), want[2]) and np.array_equal(got[4].numpy(), want[4])
    nnzb_a = max(int(ops[0][-1]), 1)
    spans = k6.tile_a_spans(got[2], got[4], bs, nnzb_a)
    assert spans.shape == (-(-got[2].shape[0] // k6.TILE_BLOCKS[bs]),)
    assert bool((spans <= k6.A_SPAN_BLOCKS[bs]).all())


def test_tile_a_spans_matches_a_loop_over_the_tiles():
    """tile_a_spans against the rule written out: per tile, max - min + 1 of
    the live slots (t < clamp(contrib_n, 0, T_max)), ids clamped into the
    block array; 0 for a tile with no live slot."""
    rng = np.random.default_rng(5)
    nnzb_a, t_max = 300, 4
    for bs in k6.BLOCK_SIZES:
        tile = k6.TILE_BLOCKS[bs]
        nnzb_c = 2 * tile + 9
        cn = rng.integers(-2, t_max + 3, nnzb_c).astype(np.int32)
        cn[tile:2 * tile] = 0  # a tile with no live slot
        ca = rng.integers(-5, nnzb_a + 5, (nnzb_c, t_max)).astype(np.int32)
        got = k6.tile_a_spans(torch.from_numpy(ca), torch.from_numpy(cn), bs, nnzb_a).tolist()
        want = []
        for s0 in range(0, nnzb_c, tile):
            live = [min(max(int(ca[s, t]), 0), nnzb_a - 1) for s in range(s0, min(s0 + tile, nnzb_c))
                    for t in range(min(max(int(cn[s]), 0), t_max))]
            want.append(max(live) - min(live) + 1 if live else 0)
        assert got == want and want[1] == 0


@pytest.mark.parametrize("bad", ["bs4", "bs_mismatch", "not_square", "int64_plan",
                                 "f64_blocks", "plan_shapes", "no_a_blocks"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a = torch.randn(4, 8, 8)
    b = torch.randn(3, 8, 8)
    ca = torch.zeros(5, 2, dtype=torch.int32)
    cb = torch.zeros(5, 2, dtype=torch.int32)
    cn = torch.ones(5, dtype=torch.int32)
    if bad == "bs4":
        a, b = torch.randn(4, 4, 4), torch.randn(3, 4, 4)
    elif bad == "bs_mismatch":
        b = torch.randn(3, 16, 16)
    elif bad == "not_square":
        a = torch.randn(4, 8, 16)
    elif bad == "int64_plan":
        ca = ca.long()
    elif bad == "f64_blocks":
        a = a.double()
    elif bad == "plan_shapes":
        cn = cn[:4]
    elif bad == "no_a_blocks":
        a = a[:0]
    with pytest.raises(SpgemmInputError):
        bsr_spgemm_numeric(a, b, ca, cb, cn)


def test_bsr_carried_across_from_numpy():
    a_ip, a_ix, b_ip, b_ix = _operands(STRUCTURES[0])
    blocks = _blocks(len(a_ix), 8, 1, ml_dtypes.bfloat16)
    ip, ix, bl = convert.bsr_from_numpy(a_ip, a_ix.astype(np.int64), blocks, device="cpu")
    assert ip.dtype == ix.dtype == torch.int32 and bl.dtype == torch.bfloat16
    assert np.array_equal(bl.float().numpy(), blocks.astype(np.float32))

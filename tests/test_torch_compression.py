"""repro_torch's symbolic-phase building blocks against the JAX package:
core.utils, core.compression, core.accumulators, the ELL format and the
row sizes of every symbolic path.

The same numpy-seeded operands go through both packages. Everything here is
integer or bit work, or f32 adds in the reference's own order, so it must
match bitwise. The port keeps bitmasks in int32 tensors; they are compared
with JAX's uint32 arrays through ``ndarray.view(np.uint32)``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accumulators as jacc
from repro.core import compression as jcomp
from repro.core import utils as jutils
from repro.sparse import formats as jfmt
from repro.sparse import generators as jgen
from repro_torch import convert
from repro_torch.core import accumulators as tacc
from repro_torch.core import compression as tcomp
from repro_torch.core import utils as tutils
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.sparse import formats as tfmt

jsp = importlib.import_module("repro.core.spgemm")
tsp = importlib.import_module("repro_torch.core.spgemm")

# (m, n, k, avg nnz per row of A, of B): k not a multiple of 32, and k < 32
SHAPES = [(12, 16, 20, 3.0, 2.5), (40, 50, 300, 4.0, 6.0), (25, 30, 97, 2.0, 9.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jm):
    return convert.csr_from_numpy(jm.indptr, jm.indices, jm.values, jm.shape, device="cpu")


def _pair(m, n, k, da, db, seed):
    ja = jgen.random_csr(m, n, da, seed)
    jb = jgen.random_csr(n, k, db, seed + 100)
    return ja, jb, _port(ja), _port(jb)


def _u32(t: torch.Tensor) -> np.ndarray:
    return convert.bitmask_to_numpy(t)


# --------------------------------------------------------------------------
# core.utils
# --------------------------------------------------------------------------


_jscan = jax.jit(jutils.segmented_scan, static_argnums=2)


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (64, 2), (1000, 3)])
def test_segmented_or_and_add_scans_match_bitwise(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    heads = rng.random(n) < 0.2
    heads[0] = True
    got = tutils.segmented_scan(torch.from_numpy(words.view(np.int32).copy()),
                                torch.from_numpy(heads), torch.bitwise_or)
    want = _jscan(jnp.asarray(words), jnp.asarray(heads), jnp.bitwise_or)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    ints = rng.integers(-50, 50, n).astype(np.int32)
    got = tutils.segmented_scan(torch.from_numpy(ints), torch.from_numpy(heads), torch.add)
    want = _jscan(jnp.asarray(ints), jnp.asarray(heads), jnp.add)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tutils.segment_ends(torch.from_numpy(heads)).numpy(),
                                  np.asarray(jutils.segment_ends(jnp.asarray(heads))))


def test_popcount_and_exclusive_cumsum_match_bitwise():
    rng = np.random.default_rng(7)
    words = np.concatenate([rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32),
                            np.array([0, 1, 2**31, 2**32 - 1, 0x80000001], np.uint32)])
    got = tutils.popcount(convert.bitmask_from_numpy(words, "cpu"))
    want = jutils.popcount(jnp.asarray(words))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    assert got.dtype == torch.int32
    x = rng.integers(0, 9, 33).astype(np.int32)
    np.testing.assert_array_equal(tutils.exclusive_cumsum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jutils.exclusive_cumsum(jnp.asarray(x))))
    assert tutils.round_up(17, 8) == jutils.round_up(17, 8) == 24
    assert tutils.ceil_div(17, 8) == jutils.ceil_div(17, 8) == 3


# --------------------------------------------------------------------------
# core.compression
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"k{s[2]}")
def test_compress_matrix_bitmask_rows_and_decision_match_bitwise(shape):
    m, n, k, da, db = shape
    ja, jb, ta, tb = _pair(m, n, k, da, db, seed=k)
    jc, tc = jcomp.compress_matrix(jb), tcomp.compress_matrix(tb)
    np.testing.assert_array_equal(np.asarray(jc.indptr), tc.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(jc.csi), tc.csi.numpy())
    np.testing.assert_array_equal(np.asarray(jc.cs), _u32(tc.cs))
    assert tc.k_compressed == jc.k_compressed and tc.shape == jc.shape
    np.testing.assert_array_equal(np.asarray(jc.row_nnz()), tc.row_nnz().numpy())
    bm = tcomp.bitmask_rows(tb)
    assert bm.dtype == torch.int32 and bm.shape == (n, -(-k // 32))
    np.testing.assert_array_equal(np.asarray(jcomp.bitmask_rows(jb)), _u32(bm))
    assert tcomp.compression_decision(ta, tb, tc) == jcomp.compression_decision(ja, jb, jc)
    assert tcomp.COMPRESSION_CF_CUTOFF == jcomp.COMPRESSION_CF_CUTOFF == 0.85


def test_bit_31_and_padded_slots_survive_compression():
    """Columns 31 and 63 set the sign bit of an int32 word; the capacity
    holds padding past nnz with garbage column ids."""
    indptr = np.array([0, 3, 3, 5], np.int32)
    indices = np.array([31, 0, 63, 31, 32, 7, 9], np.int32)
    values = np.ones(7, np.float32)
    jb = jfmt.CSR.from_arrays(indptr, indices, values, (3, 64))
    tb = _port(jb)
    np.testing.assert_array_equal(np.asarray(jcomp.bitmask_rows(jb)),
                                  _u32(tcomp.bitmask_rows(tb)))
    jc, tc = jcomp.compress_matrix(jb), tcomp.compress_matrix(tb)
    np.testing.assert_array_equal(np.asarray(jc.cs), _u32(tc.cs))
    np.testing.assert_array_equal(np.asarray(jc.csi), tc.csi.numpy())


# --------------------------------------------------------------------------
# core.accumulators
# --------------------------------------------------------------------------


def _stream(seed, n, key_range):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    return keys, vals, valid


@pytest.mark.parametrize("kind,l1_hash,l1_cap,l2_cap", [
    ("lp", 16, 16, 80), ("lp", 4, 4, 80), ("lp", 64, 64, 80),
    ("ll", 8, 6, 80), ("ll", 4, 40, 80)])
def test_accumulate_row_matches_the_reference_bitwise(kind, l1_hash, l1_cap, l2_cap):
    keys, vals, valid = _stream(11, 60, 30)
    jl1, jl2, jsp_ = jacc.accumulate_row(jnp.asarray(keys), jnp.asarray(vals),
                                         jnp.asarray(valid), l1_hash, l1_cap, l2_cap, kind)
    tl1, tl2, tsp_ = tacc.accumulate_row(torch.from_numpy(keys), torch.from_numpy(vals),
                                         torch.from_numpy(valid), l1_hash, l1_cap, l2_cap,
                                         kind)
    for jstate, tstate in ((jl1, tl1), (jl2, tl2)):
        for field in jstate._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jstate, field)),
                                          getattr(tstate, field).numpy(), err_msg=field)
    assert bool(jsp_) == bool(tsp_)


def test_lp_insert_cutoff_is_clamped_and_validated():
    """A table filled to its clamped cutoff rejects a new key and keeps one
    empty slot; existing keys still accumulate. As in the reference."""
    for max_occ in (1.0, 0.5):
        js, ts = jacc.lp_init(4), tacc.lp_init(4)
        for key in range(6):
            js, jok = jacc.lp_insert(js, jnp.int32(key), jnp.float32(1.0), max_occ)
            ts, tok = tacc.lp_insert(ts, key, torch.tensor(1.0), max_occ)
            assert bool(jok) == tok
        ts, tok = tacc.lp_insert(ts, 0, torch.tensor(2.0), max_occ)
        js, jok = jacc.lp_insert(js, jnp.int32(0), jnp.float32(2.0), max_occ)
        assert tok and bool(jok)
        np.testing.assert_array_equal(np.asarray(js.ids), ts.ids.numpy())
        np.testing.assert_array_equal(np.asarray(js.values), ts.values.numpy())
        assert int(ts.used) == int(js.used) == tacc.lp_cutoff(4, max_occ)
    for bad in (0.0, 1.5):
        with pytest.raises(SpgemmConfigError):
            tacc.lp_insert(tacc.lp_init(4), 1, torch.tensor(1.0), bad)
    with pytest.raises(SpgemmConfigError):
        tacc.lp_init(6)
    with pytest.raises(SpgemmConfigError):
        tacc.accumulate_row(torch.zeros(1, dtype=torch.int32), torch.zeros(1),
                            torch.ones(1, dtype=torch.bool), 4, 4, 4, "dense")
    assert tacc.MAX_OCCUPANCY == jacc.MAX_OCCUPANCY == 0.5


def test_extract_sorted_matches():
    ids = np.array([5, -1, 2, 9, -1], np.int32)
    vals = np.arange(5, dtype=np.float32)
    live = ids >= 0
    want = jacc.extract_sorted(jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(live))
    got = tacc.extract_sorted(torch.from_numpy(ids), torch.from_numpy(vals),
                              torch.from_numpy(live))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# --------------------------------------------------------------------------
# ELL
# --------------------------------------------------------------------------


@pytest.mark.parametrize("r_pad", [None, 2, 9])
def test_csr_to_ell_and_back_match_bitwise(r_pad):
    ja = jgen.random_csr(30, 40, 4.0, 5)
    ta = _port(ja)
    je, te = jfmt.csr_to_ell(ja, r_pad), tfmt.csr_to_ell(ta, r_pad)
    for field in ("indices", "values", "row_nnz"):
        np.testing.assert_array_equal(np.asarray(getattr(je, field)),
                                      getattr(te, field).numpy(), err_msg=field)
    assert te.shape == je.shape and te.r_pad == je.r_pad
    np.testing.assert_array_equal(np.asarray(je.valid_mask()), te.valid_mask().numpy())
    if r_pad != 2:  # rows wider than 2 are cut: no way back
        np.testing.assert_array_equal(np.asarray(je.to_dense()), te.to_dense().numpy())
        jc, tc = jfmt.ell_to_csr(je), tfmt.ell_to_csr(te)
        for field in ("indptr", "indices", "values"):
            np.testing.assert_array_equal(np.asarray(getattr(jc, field)),
                                          getattr(tc, field).numpy(), err_msg=field)


# --------------------------------------------------------------------------
# symbolic row sizes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"k{s[2]}")
def test_every_symbolic_path_gives_the_reference_row_sizes(shape):
    m, n, k, da, db = shape
    ja, jb, ta, tb = _pair(m, n, k, da, db, seed=m)
    want = None
    for compress in ("auto", "always", "never"):
        js, jstats = jsp.symbolic(ja, jb, compress=compress)
        ts, tstats = tsp.symbolic(ta, tb, compress=compress)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        assert tstats == jstats
        want = np.asarray(js)
    fm = int(jcomp.flops_stats(ja, jb.row_nnz())[0])
    cap = max(1 << (fm - 1).bit_length(), 8)
    np.testing.assert_array_equal(tsp.symbolic_plain(ta, tb, cap).numpy(), want)
    jc, tc = jcomp.compress_matrix(jb), tcomp.compress_matrix(tb)
    np.testing.assert_array_equal(
        tsp.symbolic_compressed(ta, tc, m, cap, key_bound=None).numpy(),
        np.asarray(jsp.symbolic_compressed(ja, jc, m, cap, key_bound=-(-k // 32))))
    je = jfmt.csr_to_ell(ja)
    bm = jcomp.bitmask_rows(jb)
    got = tsp.symbolic_dense_bitmask(tfmt.csr_to_ell(ta), tcomp.bitmask_rows(tb),
                                     block_rows=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsp.symbolic_dense_bitmask(je, bm)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_symbolic_row_sizes_hold_at_the_packed_key_boundary():
    """(m+1) * k past 2^31: the reference sorts with its fused two-key path,
    the port with its int64 key; the row sizes agree."""
    ja = jgen.random_csr(70, 40, 2.0, 3)
    jb = jgen.random_csr(40, 40_000_000, 3.0, 4)
    ta, tb = _port(ja), _port(jb)
    assert (ja.m + 1) * jb.k > 2**31
    js, _ = jsp.symbolic(ja, jb, compress="never")
    ts, _ = tsp.symbolic(ta, tb, compress="never")
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    jax.clear_caches()

"""The kernel-backed two-phase path (repro_torch.kernels.ops) and its three
kernels' wrappers — K5 spgemm_symbolic, K4 spgemm_numeric, K3 spgemm_lp —
against the JAX package.

On the CPU each wrapper runs its plain version. What holds:

* K5's plain version equals ``ref.spgemm_symbolic_ref`` and the Pallas
  ``spgemm_symbolic`` (interpret mode) bitwise.
* K3's plain version equals ``ref.spgemm_lp_ref`` and the Pallas
  ``spgemm_lp_bucketed`` (interpret mode) **bitwise**: it adds each key's
  f32 products in the order of the insert stream, as both do, whether or
  not a row spills.
* K4's plain version is held against ``ref.spgemm_numeric_ref`` within
  rtol/atol 1e-4, the tolerance of the reference's own ELL numeric tests.
  Not against the Pallas kernel: its interpret run fails on ``pl.load`` on
  this jax, and the reference's ``numeric_values`` ladder hides that by
  running "xla".
* ``pallas_spgemm``: C's ``c_nnz`` and ``c_idx`` bitwise; values bitwise on
  the K3 path, within 1e-4 of the reference's "xla" values on the K4 path.

The ``cuda``-marked tests of these kernels are in tests/test_torch_kernels.py,
which runs on a card without JAX.
"""
import ctypes
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.telemetry import FALLBACK_COUNTS as J_FALLBACK_COUNTS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.spgemm_lp import spgemm_lp_bucketed as j_lp_bucketed
from repro.kernels.spgemm_symbolic import spgemm_symbolic as j_symbolic
from repro.kernels.spgemm_symbolic import spgemm_symbolic_bucketed as j_symbolic_bucketed
from repro.sparse import CSR as JCSR
from repro.sparse import generators as jgen
from repro.sparse.oracle import gustavson_ell_structure
from repro_torch import convert
from repro_torch.core import telemetry as ttelemetry
from repro_torch.kernels import _build, ops
from repro_torch.kernels import spgemm_lp as k3
from repro_torch.kernels import spgemm_numeric as k4
from repro_torch.kernels import spgemm_symbolic as k5
from repro_torch.runtime.validate import (KernelFallbackError, SpgemmConfigError,
                                          SpgemmInputError)
from test_torch_kernels import ELL_CASES
from test_torch_kernels import bitmask_words as _bitmask
from test_torch_kernels import ell_operands as _ell

jsp = importlib.import_module("repro.core.spgemm")
tsp = importlib.import_module("repro_torch.core.spgemm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    ttelemetry.reset_all()
    yield


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _port(jm, values=None):
    vals = jm.values if values is None else values
    return convert.csr_from_numpy(jm.indptr, jm.indices, vals, jm.shape, device="cpu")


def _spills(a_idx, a_nnz, b_idx, b_nnz, l1_size):
    """Whether some row has more distinct keys than L1's cutoff."""
    return any(len({int(b_idx[a_idx[i, r], t]) for r in range(a_nnz[i])
                    for t in range(b_nnz[a_idx[i, r]])}) > min(l1_size // 2, l1_size - 1)
               for i in range(a_idx.shape[0]))




# --------------------------------------------------------------------------
# K5 spgemm_symbolic
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ELL_CASES, ids=lambda c: f"m{c[0]}k{c[2]}")
def test_symbolic_plain_matches_ref_and_pallas_bitwise(case):
    m, n, k, r_a, r_b, seed = case
    a_idx, _, a_nnz, b_idx, _, b_nnz, _, c_nnz = _ell(*case)
    words = _bitmask(b_idx, b_nnz, k)
    got = k5.spgemm_symbolic(_t(a_idx), _t(a_nnz), convert.bitmask_from_numpy(words, "cpu"))
    assert got.dtype == torch.int32 and k5.LAUNCHES == 0
    want = jref.spgemm_symbolic_ref(jnp.asarray(a_idx), jnp.asarray(a_nnz), jnp.asarray(words))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), c_nnz)
    padded = np.pad(words, ((0, 0), (0, (-words.shape[1]) % 128)))  # the TPU's k32 % 128
    pallas = j_symbolic(jnp.asarray(a_idx), jnp.asarray(a_nnz), jnp.asarray(padded),
                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    bucketed = k5.spgemm_symbolic_bucketed(_t(a_idx), _t(a_nnz),
                                           convert.bitmask_from_numpy(words, "cpu"))
    np.testing.assert_array_equal(bucketed.numpy(), np.asarray(j_symbolic_bucketed(
        jnp.asarray(a_idx), jnp.asarray(a_nnz), jnp.asarray(padded), interpret=True)))


# --------------------------------------------------------------------------
# K3 spgemm_lp
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ELL_CASES[:2], ids=lambda c: f"m{c[0]}k{c[2]}")
@pytest.mark.parametrize("l1_size", [4, 16, None])
def test_lp_plain_is_bitwise_the_ref_and_the_pallas_kernel(case, l1_size):
    """Spilling rows included (l1_size 4: cutoff 2)."""
    arrays = _ell(*case)
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = arrays
    if l1_size == 4:
        assert _spills(a_idx, a_nnz, b_idx, b_nnz, l1_size)
    got = k3.spgemm_lp(*(_t(x) for x in arrays), l1_size=l1_size, k=case[2])
    assert got.dtype == torch.float32 and k3.NUMERIC_LAUNCHES == 0
    eff_l1 = k3.default_l1_size(c_idx.shape[1]) if l1_size is None else l1_size
    want = jref.spgemm_lp_ref(*(jnp.asarray(x) for x in arrays), eff_l1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = j_lp_bucketed(*(jnp.asarray(x) for x in arrays), l1_size=l1_size,
                           interpret=True)
    bucketed = k3.spgemm_lp_bucketed(*(_t(x) for x in arrays), l1_size=l1_size)
    np.testing.assert_array_equal(bucketed.numpy(), np.asarray(pallas))
    assert k3.default_l1_size(c_idx.shape[1]) == importlib.import_module(
        "repro.kernels.spgemm_lp").default_l1_size(c_idx.shape[1])


def test_lp_table_slots_follow_the_kernel_formula():
    c_nnz = torch.tensor([0, 1, 4, 5, 1024, 1025, 8192, 8193], dtype=torch.int32)
    per_row = k3.lp_table_slots(c_nnz, 10_000, None)
    np.testing.assert_array_equal(per_row.numpy(),
                                  [0, 8, 8, 16, 2048, 4096, 16384, 32768])
    forced = k3.lp_table_slots(c_nnz, 10_000, 16)
    # L1 16 slots (cutoff 8) and an L2 of the per-row size where c_nnz > 8;
    # the per-row table alone where the forced L1 could not spill
    np.testing.assert_array_equal(forced.numpy(),
                                  [0, 8, 8, 16, 16 + 2048, 16 + 4096, 16 + 16384,
                                   16 + 32768])
    for bad in (3, 1, 0, 2**30):
        with pytest.raises(SpgemmConfigError):
            k3.spgemm_lp_plain(*(_t(x) for x in _ell(*ELL_CASES[2])), l1_size=bad)


# --------------------------------------------------------------------------
# K4 spgemm_numeric
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ELL_CASES, ids=lambda c: f"m{c[0]}k{c[2]}")
def test_numeric_plain_matches_ref_within_1e4(case):
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = _ell(*case)
    k = case[2]
    b_val0 = np.where(np.arange(b_idx.shape[1])[None, :] < b_nnz[:, None], b_val, 0)
    b_val0 = b_val0.astype(np.float32)
    a_val0 = np.where(np.arange(a_idx.shape[1])[None, :] < a_nnz[:, None], a_val, 0)
    a_val0 = a_val0.astype(np.float32)
    # the reference's contract: padded A and B slots carry 0 (A's ids are clamped)
    want = np.asarray(jref.spgemm_numeric_ref(
        jnp.asarray(a_idx), jnp.asarray(a_val0), jnp.asarray(b_idx % k),
        jnp.asarray(b_val0), jnp.asarray(c_idx), jnp.asarray(c_nnz), k))
    for b_nnz_arg in (None, _t(b_nnz)):
        got = k4.spgemm_numeric(_t(a_idx), _t(a_val), _t(a_nnz), _t(b_idx), _t(b_val0),
                                _t(c_idx), _t(c_nnz), k=k, b_nnz=b_nnz_arg)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    bucketed = k4.spgemm_numeric_bucketed(_t(a_idx), _t(a_val), _t(a_nnz), _t(b_idx),
                                          _t(b_val0), _t(c_idx), _t(c_nnz), k=k)
    assert bucketed.shape == c_idx.shape
    np.testing.assert_allclose(bucketed.numpy(), want, rtol=1e-4, atol=1e-4)
    assert k4.LAUNCHES == 0


def test_numeric_keeps_a_dtype_where_lp_promotes():
    """K4 returns A's dtype (spgemm_numeric.py:110), K3 promote_types(a, b)."""
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = (
        _t(x) for x in _ell(*ELL_CASES[0]))
    a_bf = a_val.to(torch.bfloat16)
    k4_out = k4.spgemm_numeric(a_idx, a_bf, a_nnz, b_idx, b_val, c_idx, c_nnz, k=20,
                               b_nnz=b_nnz)
    k3_out = k3.spgemm_lp(a_idx, a_bf, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, k=20)
    assert k4_out.dtype == torch.bfloat16
    assert k3_out.dtype == torch.float32
    # the same f32 sums, rounded once to bf16 by K4
    torch.testing.assert_close(k4_out, k3_out.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    ("a_idx", lambda t: t.long()), ("a_val", lambda t: t.double()),
    ("b_val", lambda t: t.to(torch.int32)), ("c_idx", lambda t: t[:, ::2]),
    ("a_nnz", lambda t: t[:-1]), ("b_idx", lambda t: t.numpy()),
    ("c_nnz", lambda t: t.reshape(1, -1))], ids=lambda b: b[0])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    names = ["a_idx", "a_val", "a_nnz", "b_idx", "b_val", "b_nnz", "c_idx", "c_nnz"]
    args = [_t(x) for x in _ell(*ELL_CASES[0])]
    args[names.index(bad[0])] = bad[1](args[names.index(bad[0])])
    with pytest.raises(SpgemmInputError):
        k3.spgemm_lp(*args, k=20)
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz = args
    with pytest.raises(SpgemmInputError):
        k4.spgemm_numeric(a_idx, a_val, a_nnz, b_idx, b_val, c_idx, c_nnz, k=20)
    good = [_t(x) for x in _ell(*ELL_CASES[0])]
    with pytest.raises(SpgemmInputError):
        k3.spgemm_lp(*good[:5], None, *good[6:], k=20)  # K3 masks B by b_nnz
    with pytest.raises(SpgemmInputError):
        k4.spgemm_numeric(*good[:5], good[6], good[7], k=0)
    with pytest.raises(SpgemmInputError):
        k5.spgemm_symbolic(good[0], good[2], torch.zeros(0, 1, dtype=torch.int32))
    with pytest.raises(SpgemmInputError):
        k5.spgemm_symbolic(good[0], good[2], torch.zeros(3, 1, dtype=torch.int64))


# --------------------------------------------------------------------------
# kernels/ops: routing, numeric_values, pallas_spgemm
# --------------------------------------------------------------------------


def _csr_pair(m, n, k, da, db, seed):
    ja, jb = jgen.random_csr(m, n, da, seed), jgen.random_csr(n, k, db, seed + 100)
    return ja, jb, _port(ja), _port(jb)


def _tie_pair():
    """avg row flops exactly 256: 4 rows of A, each meeting 16 B rows of 16."""
    m, n, k = 4, 16, 64
    a = np.ones((m, n), np.float32)
    b = np.zeros((n, k), np.float32)
    for j in range(n):
        b[j, (np.arange(16) * 3 + j) % k] = 1.0
    return JCSR.from_dense(a), JCSR.from_dense(b)


def test_resolve_numeric_kernel_routes_as_the_reference():
    ja, jb = _tie_pair()
    ta, tb = _port(ja), _port(jb)
    assert jops.resolve_numeric_kernel(ja, jb) == ops.resolve_numeric_kernel(ta, tb) == "flat_lp"
    ja, jb, ta, tb = _csr_pair(24, 30, 20, 3.0, 2.0, 7)
    assert jops.resolve_numeric_kernel(ja, jb) == ops.resolve_numeric_kernel(ta, tb) == "dense_acc"
    for name in ("dense_acc", "flat_lp", "xla"):
        assert ops.resolve_numeric_kernel(ta, tb, name) == name
    for dtype in (np.float64, np.int32):
        ti = _port(ja, np.asarray(ja.values).astype(dtype))
        assert ops.resolve_numeric_kernel(ti, tb) == "xla"
        for explicit in ("flat_lp", "dense_acc"):
            with pytest.raises(SpgemmConfigError, match="accumulates in f32"):
                ops.resolve_numeric_kernel(ti, tb, explicit)
    with pytest.raises(SpgemmConfigError, match="unknown kernel"):
        ops.resolve_numeric_kernel(ta, tb, "cuda")
    assert ops.NUMERIC_KERNELS == jops.NUMERIC_KERNELS


def test_numeric_values_counts_dispatches_and_the_dtype_guard():
    ja, jb, ta, tb = _csr_pair(24, 30, 20, 3.0, 2.0, 7)
    c_idx, c_nnz = (_t(x) for x in gustavson_ell_structure(ja, jb))
    ops.numeric_values(ta, tb, c_idx, c_nnz)
    ops.numeric_values(ta, tb, c_idx, c_nnz, kernel="flat_lp")
    ops.numeric_values(ta, tb, c_idx, c_nnz, kernel="xla")
    assert dict(ops.KERNEL_COUNTS) == {"dense_acc": 1, "flat_lp": 1, "xla": 1}
    assert ttelemetry.snapshot()["kernel"] == {"dense_acc": 1, "flat_lp": 1, "xla": 1}
    ti = _port(ja, np.ones(ja.nnz_cap, np.int32))
    tbi = _port(jb, np.ones(jb.nnz_cap, np.int32))
    out = ops.numeric_values(ti, tbi, c_idx, c_nnz)
    assert out.dtype == torch.int32 and ops.KERNEL_COUNTS["xla"] == 2
    assert ttelemetry.FALLBACK_COUNTS["dtype:numeric_auto->xla"] == 1
    # the reference counts the same dtype event at the same site
    jai = JCSR(ja.indptr, ja.indices, jnp.ones(ja.nnz_cap, jnp.int32), ja.shape)
    jbi = JCSR(jb.indptr, jb.indices, jnp.ones(jb.nnz_cap, jnp.int32), jb.shape)
    want = jops.numeric_values(jai, jbi, jnp.asarray(c_idx.numpy()), jnp.asarray(c_nnz.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert J_FALLBACK_COUNTS["dtype:numeric_auto->xla"] == 1


def test_numeric_values_has_no_ladder_and_no_tuner_yet():
    ja, jb, ta, tb = _csr_pair(10, 12, 14, 2.0, 2.0, 3)
    c_idx, c_nnz = (_t(x) for x in gustavson_ell_structure(ja, jb))
    with pytest.raises(SpgemmConfigError, match="runtime"):
        ops.numeric_values(ta, tb, c_idx, c_nnz, on_kernel_failure="fallback")
    with pytest.raises(SpgemmConfigError):
        ops.numeric_values(ta, tb, c_idx, c_nnz, on_kernel_failure="retry")
    with pytest.raises(SpgemmConfigError, match="autotune"):
        ops.numeric_values(ta, tb, c_idx, c_nnz, tune="measure")
    assert not ops.KERNEL_COUNTS


def test_numeric_values_wraps_an_untyped_kernel_failure(monkeypatch):
    ja, jb, ta, tb = _csr_pair(10, 12, 14, 2.0, 2.0, 3)
    c_idx, c_nnz = (_t(x) for x in gustavson_ell_structure(ja, jb))

    def boom(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ops, "spgemm_numeric_bucketed", boom)
    with pytest.raises(KernelFallbackError) as info:
        ops.numeric_values(ta, tb, c_idx, c_nnz, kernel="dense_acc")
    assert isinstance(info.value.__cause__, RuntimeError)
    assert not ops.KERNEL_COUNTS


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_numeric_values_xla_matches_the_reference(dtype):
    ja, jb, ta, tb = _csr_pair(20, 25, 30, 3.0, 3.0, 5)
    ta = _port(ja, (np.asarray(ja.values) * 4).astype(dtype))
    tb = _port(jb, (np.asarray(jb.values) * 4).astype(dtype))
    c_idx, c_nnz = gustavson_ell_structure(ja, jb)
    got = ops.numeric_values(ta, tb, _t(c_idx), _t(c_nnz), kernel="xla")
    assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    a_d = ta.to_dense().double().numpy()
    b_d = tb.to_dense().double().numpy()
    want = a_d @ b_d  # float64 (the reference runs with x64 off)
    rows = np.repeat(np.arange(c_idx.shape[0]), c_idx.shape[1]).reshape(c_idx.shape)
    live = np.arange(c_idx.shape[1])[None, :] < c_nnz[:, None]
    exp = np.where(live, want[rows, c_idx], 0)
    np.testing.assert_allclose(got.double().numpy(), exp, rtol=1e-5, atol=1e-4)
    if dtype == np.float32:
        ref = jops.numeric_values(ja, jb, jnp.asarray(c_idx), jnp.asarray(c_nnz), kernel="xla")
        got = ops.numeric_values(_port(ja), _port(jb), _t(c_idx), _t(c_nnz), kernel="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 20, 24, 3.0, 2.5), (4, 32, 64, 16.0, 32.0)],
                         ids=["dense_acc", "flat_lp"])
def test_pallas_spgemm_matches_the_reference(shape):
    """C's structure bitwise; K3 values bitwise (both add in stream order);
    K4 values within 1e-4 of the reference's "xla" values."""
    ja, jb, ta, tb = _csr_pair(*shape, seed=11)
    want_nnz, want_idx, want_lp = jops.pallas_spgemm(ja, jb, kernel="flat_lp")
    got_nnz, got_idx, got_lp = ops.pallas_spgemm(ta, tb, kernel="flat_lp")
    np.testing.assert_array_equal(got_nnz.numpy(), np.asarray(want_nnz))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_lp.numpy(), np.asarray(want_lp))
    _, _, got_auto = ops.pallas_spgemm(ta, tb)
    picked = ops.resolve_numeric_kernel(ta, tb)
    assert picked == jops.resolve_numeric_kernel(ja, jb) == shape_kernel(shape)
    want_xla = jops.numeric_values(ja, jb, want_idx, want_nnz, kernel="xla")
    np.testing.assert_allclose(got_auto.numpy(), np.asarray(want_xla), rtol=1e-4, atol=1e-4)
    assert ops.KERNEL_COUNTS == {"flat_lp": 1 + (picked == "flat_lp"),
                                 **({"dense_acc": 1} if picked == "dense_acc" else {})}
    sizes = ops.symbolic_rowsizes(ta, tb)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jops.symbolic_rowsizes(ja, jb)))


def shape_kernel(shape):
    return "dense_acc" if shape[0] == 16 else "flat_lp"


# --------------------------------------------------------------------------
# the build and the card
# --------------------------------------------------------------------------


def test_ell_c_interface_matches_the_ctypes_signature():
    common = (_build.CSRC_DIR / "ell_common.cuh").read_text()
    api = common[common.index("#define ELL_C_API"):]
    params = re.search(r"NAME##_launch\((.*?)\)\s*\{", api.replace("\\\n", ""),
                       re.S).group(1)
    c_types = {"ptr": ctypes.c_void_p, "int64_t": ctypes.c_int64, "int": ctypes.c_int}
    declared = ["ptr" if "*" in p else p.split()[0] for p in params.split(",")]
    assert [c_types[t] for t in declared] == k4._ARGTYPES
    for name in ("spgemm_numeric", "spgemm_lp"):
        assert re.search(rf"ELL_C_API\({name},", (_build.CSRC_DIR / f"{name}.cu").read_text())
    src = (_build.CSRC_DIR / "spgemm_symbolic.cu").read_text()
    params = re.search(r'extern "C" int spgemm_symbolic_launch\((.*?)\)\s*\{', src,
                       re.S).group(1)
    declared = ["ptr" if "*" in p else p.split()[0] for p in params.split(",")]
    assert [c_types[t] for t in declared] == k5._ARGTYPES
    assert {"spgemm_symbolic", "spgemm_numeric", "spgemm_lp"} <= set(_build.SOURCES)

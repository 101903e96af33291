"""repro_torch formats, generators and error taxonomy against the JAX package.

The same generator arguments go through both packages; the port must build
byte-identical operands (indptr, indices, values) and the same CSR helpers'
results, on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import validate as jvalidate
from repro.sparse import formats as jformats
from repro.sparse import generators as jgen
from repro_torch.runtime import validate as tvalidate
from repro_torch.sparse import formats as tformats
from repro_torch.sparse import generators as tgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_csr(j, t, exact_values=True):
    assert tuple(j.shape) == tuple(t.shape)
    assert t.indptr.dtype == t.indices.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j.indptr), t.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(j.indices), t.indices.numpy())
    if exact_values:
        assert np.asarray(j.values).tobytes() == t.values.numpy().tobytes()


GENERATORS = {
    "random": lambda g, **kw: g.random_csr(40, 50, 3.0, 1, **kw),
    "random_f16": lambda g, **kw: g.random_csr(30, 20, 2.0, 7, dtype=np.float16, **kw),
    "banded": lambda g, **kw: g.banded_csr(64, 3, 1, **kw),
    "rmat8": lambda g, **kw: g.rmat_csr(8, 8, 0, **kw),
    "stencil": lambda g, **kw: g.stencil2d_csr(7, 5, **kw),
    "prolongator": lambda g, **kw: g.aggregation_prolongator(37, 4, **kw),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_are_byte_identical(name):
    make = GENERATORS[name]
    _assert_same_csr(make(jgen), make(tgen, device="cpu"))


@pytest.mark.parametrize("nx,ny,agg", [(16, 16, 4), (6, 5, 4), (9, 3, 2)])
def test_galerkin_triple_sparse_transpose_is_bitwise(nx, ny, agg):
    """The port transposes P sparsely; the reference through a dense P."""
    for j, t in zip(jgen.galerkin_triple(nx, ny, agg), tgen.galerkin_triple(nx, ny, agg, device="cpu")):
        _assert_same_csr(j, t)


def test_float64_generators_keep_f64_where_the_reference_rounds_to_f32():
    """JAX runs with x64 off and stores f64 values as f32; the port keeps
    f64, and its values round to exactly the reference's."""
    j = jgen.random_csr(30, 30, 4.0, 3, dtype=np.float64)
    t = tgen.random_csr(30, 30, 4.0, 3, dtype=np.float64, device="cpu")
    assert t.values.dtype == torch.float64
    _assert_same_csr(j, t, exact_values=False)
    np.testing.assert_array_equal(np.asarray(j.values), t.values.float().numpy())


def test_generators_accept_torch_dtypes_and_refuse_bf16():
    t = tgen.random_csr(10, 10, 2.0, 0, dtype=torch.float32, device="cpu")
    assert t.values.dtype == torch.float32
    with pytest.raises(tvalidate.SpgemmConfigError):
        tgen.random_csr(10, 10, 2.0, 0, dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("indptr,nnz_cap", [
    ([0, 2, 2, 5], 5),        # an empty row, no padding
    ([0, 2, 2, 5], 9),        # padding past nnz: indptr[-1] < nnz_cap
    ([0, 0, 0, 0], 4),        # all rows empty
    ([0, 3, 3, 3], 3),        # trailing empty rows hit the index nnz_cap
])
def test_csr_row_ids_matches_reference(indptr, nnz_cap):
    ip = np.asarray(indptr, np.int32)
    want = np.asarray(jformats.csr_row_ids(jnp.asarray(ip), nnz_cap))
    got = tformats.csr_row_ids(torch.from_numpy(ip), nnz_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_csr_helpers_match_reference():
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((7, 9)).astype(np.float32)
    dense[rng.random((7, 9)) < 0.6] = 0.0
    dense[3] = 0.0  # an empty row
    j = jformats.CSR.from_dense(dense, nnz_cap=48)
    t = tformats.CSR.from_dense(dense, nnz_cap=48, device="cpu")
    _assert_same_csr(j, t)
    assert (t.m, t.k, t.nnz_cap, t.dtype) == (7, 9, 48, torch.float32)
    assert int(t.nnz()) == int(j.nnz())
    np.testing.assert_array_equal(np.asarray(j.row_nnz()), t.row_nnz().numpy())
    np.testing.assert_array_equal(np.asarray(j.valid_mask()), t.valid_mask().numpy())
    np.testing.assert_array_equal(np.asarray(j.to_dense()), t.to_dense().numpy())
    np.testing.assert_array_equal(dense, t.to_dense().numpy())
    # a tensor input gives the same matrix
    _assert_same_csr(j, tformats.CSR.from_dense(torch.from_numpy(dense), nnz_cap=48,
                                                device="cpu"))


def test_from_dense_refuses_a_capacity_below_nnz():
    with pytest.raises(tvalidate.CapacityOverflowError):
        tformats.CSR.from_dense(np.eye(4, dtype=np.float32), nnz_cap=3, device="cpu")


def test_from_arrays_checks_shapes_like_the_reference():
    ok = tformats.CSR.from_arrays(np.array([0, 1, 2]), np.array([0, 1]),
                                  np.array([1.0, 2.0], np.float32), (2, 2), device="cpu")
    assert ok.indptr.dtype == torch.int32 and ok.device.type == "cpu"
    bad = [
        (np.array([0, 1]), np.array([0, 1]), np.ones(2, np.float32), (2, 2)),  # indptr
        (np.array([0, 1, 2]), np.array([0, 1]), np.ones(3, np.float32), (2, 2)),  # lengths
        (np.array([0, 1, 2]), np.array([0, 1]), np.ones(2, np.float32), (2, -1)),  # shape
    ]
    for args in bad:
        with pytest.raises(jvalidate.SpgemmInputError):
            jformats.CSR.from_arrays(*args)
        with pytest.raises(tvalidate.SpgemmInputError):
            tformats.CSR.from_arrays(*args, device="cpu")
    # tensors stay where they are when no device is given
    kept = tformats.CSR.from_arrays(ok.indptr, ok.indices, ok.values, ok.shape)
    assert kept.values.device.type == "cpu"


@pytest.mark.parametrize("name", [
    "SpgemmError", "SpgemmInputError", "CapacityOverflowError",
    "PlanMismatchError", "KernelFallbackError", "SpgemmConfigError",
])
def test_error_taxonomy_has_the_reference_names_and_bases(name):
    j, t = getattr(jvalidate, name), getattr(tvalidate, name)
    assert [c.__name__ for c in j.__mro__] == [c.__name__ for c in t.__mro__]

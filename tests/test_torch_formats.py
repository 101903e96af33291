"""repro_torch formats, generators, oracles and error taxonomy against the
JAX package.

The same generator arguments go through both packages; the port must build
byte-identical operands (indptr, indices, values) and the same CSR helpers'
results, on the CPU. ``BSR`` (``mb``, ``kb``, ``to_dense``), the numpy
oracles and ``estimate_ars`` are held bitwise against the reference's. The
last tests hold the port's public names to the reference's and check that
no module of the port imports ``jax`` or ``repro``.
"""
import ast
import importlib
import pathlib
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import meta as jmeta
from repro.runtime import validate as jvalidate
from repro.sparse import formats as jformats
from repro.sparse import generators as jgen
from repro.sparse import oracle as joracle
from repro_torch import convert
from repro_torch.core import meta as tmeta
from repro_torch.runtime import validate as tvalidate
from repro_torch.sparse import formats as tformats
from repro_torch.sparse import generators as tgen
from repro_torch.sparse import oracle as toracle


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
    "AdmissionRejected", "DeadlineExceeded", "TrainingDivergedError",
])
def test_error_taxonomy_has_the_reference_names_and_bases(name):
    j, t = getattr(jvalidate, name), getattr(tvalidate, name)
    assert [c.__name__ for c in j.__mro__] == [c.__name__ for c in t.__mro__]


def _bsr_arrays(mb, kb, bs, seed, dtype=np.float32, pad=0):
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(kb, rng.integers(0, kb + 1), replace=False)) for _ in range(mb)]
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])]).astype(np.int32)
    indices = np.concatenate(cols + [np.zeros(pad, np.int64)]).astype(np.int32)
    blocks = rng.standard_normal((len(indices), bs, bs)).astype(np.float32).astype(dtype)
    return indptr, indices, blocks


@pytest.mark.parametrize("mb,kb,bs,dtype,pad", [
    (5, 4, 8, np.float32, 0), (3, 6, 16, np.float32, 3), (4, 4, 8, ml_dtypes.bfloat16, 2),
    (1, 1, 8, np.float32, 0)])
def test_bsr_matches_the_reference(mb, kb, bs, dtype, pad):
    ip, ix, bl = _bsr_arrays(mb, kb, bs, mb + kb, dtype, pad)
    shape = (mb * bs, kb * bs)
    j = jformats.BSR(jnp.asarray(ip), jnp.asarray(ix), jnp.asarray(bl), shape, (bs, bs))
    t = convert.bsr_from_numpy(ip, ix, bl, shape=shape, device="cpu")
    assert isinstance(t, tformats.BSR)
    assert (t.mb, t.kb, t.block_shape) == (j.mb, j.kb, j.block_shape)
    got = convert.tensor_to_numpy(t.to_dense())
    assert got.tobytes() == np.asarray(j.to_dense()).astype(got.dtype).tobytes()
    ip2, ix2, bl2 = t  # still the triple of the raw-tensor calls
    assert ip2.dtype == ix2.dtype == torch.int32 and bl2.shape == bl.shape
    if pad == 0 and ix.size:  # the default shape holds every live block
        assert convert.bsr_from_numpy(ip, ix, bl, device="cpu").shape[0] == shape[0]


ORACLE_CASES = {
    "random": lambda g, **kw: (g.random_csr(20, 15, 3.0, 1, **kw), g.random_csr(15, 18, 2.0, 2, **kw)),
    "rmat": lambda g, **kw: (g.rmat_csr(6, 4, 3, **kw), g.rmat_csr(6, 4, 4, **kw)),
    "galerkin_ap": lambda g, **kw: g.galerkin_triple(6, 5, 2, **kw)[1:],
    "f64": lambda g, **kw: (g.random_csr(9, 9, 3.0, 5, dtype=np.float64, **kw),
                            g.random_csr(9, 7, 3.0, 6, dtype=np.float64, **kw)),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracles_match_the_reference_bitwise(case):
    ja, jb = ORACLE_CASES[case](jgen)
    ta, tb = ORACLE_CASES[case](tgen, device="cpu")
    if case == "f64":  # the reference holds f32 (x64 off): feed the port the same values
        ta = tformats.CSR(ta.indptr, ta.indices, torch.from_numpy(np.array(ja.values)), ta.shape)
        tb = tformats.CSR(tb.indptr, tb.indices, torch.from_numpy(np.array(jb.values)), tb.shape)
    for got, want in zip(toracle.gustavson_numpy(ta, tb), joracle.gustavson_numpy(ja, jb)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for got, want in zip(toracle.gustavson_ell_structure(ta, tb),
                         joracle.gustavson_ell_structure(ja, jb)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    got = toracle.dense_spgemm_oracle(ta, tb)
    want = joracle.dense_spgemm_oracle(ja, jb)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_estimate_ars_matches_the_reference():
    assert tmeta.ARS_REDUCTION_GUESS == jmeta.ARS_REDUCTION_GUESS == 8
    for fm in (0, 1, 7, 8, 9, 255, 256, 1 << 20, 10**12 + 3):
        assert tmeta.estimate_ars(fm) == jmeta.estimate_ars(fm)


def test_the_port_exports_the_references_public_names():
    """Every name of ``repro.runtime`` and ``repro.obs``, and every autotune,
    meta and telemetry name of ``repro.core`` (the distributed/memory-pool
    names come with the dist/ slice; TRACE_COUNTS is STAGE_COUNTS)."""
    for pkg in ("runtime", "obs"):
        ref = importlib.import_module(f"repro.{pkg}")
        port = importlib.import_module(f"repro_torch.{pkg}")
        assert set(ref.__all__) <= set(port.__all__), set(ref.__all__) - set(port.__all__)
        assert all(hasattr(port, name) for name in port.__all__)
    jcore = importlib.import_module("repro.core")
    tcore = importlib.import_module("repro_torch.core")
    wanted = {name for name in jcore.__all__
              if getattr(getattr(jcore, name), "__module__", "repro.core.meta").rsplit(".", 1)[-1]
              in ("autotune", "meta", "telemetry")}
    wanted |= {name for name in jcore.__all__ if name in vars(jmeta)}
    assert "fit_thresholds" in wanted and "estimate_ars" in wanted
    assert wanted <= set(tcore.__all__), wanted - set(tcore.__all__)
    for mod in ("autotune", "telemetry", "meta"):
        ref = importlib.import_module(f"repro.core.{mod}")
        port = importlib.import_module(f"repro_torch.core.{mod}")
        public = {n for n, v in vars(ref).items() if not n.startswith("_")
                  and not isinstance(v, types.ModuleType)
                  and getattr(v, "__module__", ref.__name__) == ref.__name__}
        public -= {"TRACE_COUNTS", "reset_trace_counts"}  # STAGE_COUNTS in the port
        assert public <= set(vars(port)), public - set(vars(port))


def test_no_module_of_the_port_imports_jax_or_the_reference():
    root = pathlib.Path(tformats.__file__).resolve().parents[1]
    files = sorted(root.rglob("*.py")) + [root.parents[1] / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"

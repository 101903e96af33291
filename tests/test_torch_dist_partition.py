"""The partitioning layer (``core/distributed.py``), the memory pool
(``core/memory_pool.py``), the compressed collectives and the pipeline of
the port against the JAX package, in one process.

The reference's host functions and ``concat_csr_shards`` need no mesh, so
both packages take the same seeded operands here: every integer array is
held bitwise, values bitwise too (they are only moved). The cases are the
reference's degenerate layouts: indivisible m, more shards than rows (empty
shards), a single row, empty rows and an empty tail block. The sharded
phases run on the port's single-process mesh (S = 8) against the reference's
single-device phases. ``compressed_psum`` is held against the exact mean
at the reference test's atol 3e-2 and against the mean of the reference's
own dequantized operands at 1e-6; ``pipeline_forward`` at 4 stages against
the serial loop at the reference test's rtol 1e-4 / atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import memory_pool as jpool
from repro.core.spgemm import symbolic_plain as j_symbolic_plain
from repro.dist import collectives as jcoll
from repro.sparse import CSR as JCSR
from repro.sparse import generators as jgen
from repro_torch import compat
from repro_torch.core import distributed as tdist
from repro_torch.core import memory_pool as tpool
from repro_torch.core.meta import round_capacity
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import pipeline_forward
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.sparse import CSR as TCSR
from repro_torch.sparse import generators as tgen

# (m, shards): divisible, m % S != 0, several padded rows, S > m, one row
SHAPES = [(96, 8), (97, 8), (91, 8), (5, 8), (1, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random(m, k, nnz, seed):
    return jgen.random_csr(m, k, nnz, seed), tgen.random_csr(m, k, nnz, seed, device="cpu")


def _with_empty_rows(m, k, seed):
    """Even rows empty, plus an empty tail block."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, k)).astype(np.float32)
    dense[::2] = 0.0
    dense[m - max(m // 4, 1):] = 0.0
    return JCSR.from_dense(dense), TCSR.from_dense(dense, device="cpu")


def _cases():
    for m, shards in SHAPES:
        yield f"m{m}_S{shards}", _random(m, 40, 3.0, m + shards), shards
    yield "empty_rows_S6", _with_empty_rows(37, 23, 3), 6
    yield "empty_rows_S8", _with_empty_rows(10, 12, 9), 8


CASES = {name: (pair, shards) for name, pair, shards in _cases()}


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("policy", ["pow2", "exact8"])
@pytest.mark.parametrize("case", CASES)
def test_partition_rows_and_maps_are_bitwise_the_references(case, policy):
    (ja, ta), shards = CASES[case]
    _same(tdist.row_block_bounds(ta, shards), jdist.row_block_bounds(ja, shards))
    assert tdist.shard_cap(ta, shards, policy) == jdist.shard_cap(ja, shards, policy)
    t_sh, j_sh = tdist.partition_rows(ta, shards, policy), jdist.partition_rows(ja, shards, policy)
    for f in ("indptr", "indices", "values"):
        _same(getattr(t_sh, f), getattr(j_sh, f))
    assert t_sh.shape == j_sh.shape and t_sh.m_loc == j_sh.m_loc
    _same(tdist.partition_value_map(ta, shards, policy),
          jdist.partition_value_map(ja, shards, policy))
    _same(tdist.allgather_value_perm(t_sh), jdist.allgather_value_perm(j_sh))
    jb, tb = _random(ta.k, 30, 2.0, 77)
    assert tdist.shard_fm_cap(t_sh, tb, policy) == jdist.shard_fm_cap(j_sh, jb, policy)


@pytest.mark.parametrize("case", CASES)
def test_merge_shards_round_trips_as_the_reference(case):
    (ja, ta), shards = CASES[case]
    back = tdist.merge_shards(tdist.partition_rows(ta, shards), ta.m)
    want = jdist.merge_shards(jdist.partition_rows(ja, shards), ja.m)
    for f in ("indptr", "indices", "values"):
        _same(getattr(back, f), getattr(want, f))
    assert torch.equal(back.to_dense(), ta.to_dense())


@pytest.mark.parametrize("case", CASES)
def test_concat_csr_shards_is_bitwise_the_references(case):
    (ja, ta), shards = CASES[case]
    t_sh, j_sh = tdist.partition_rows(ta, shards), jdist.partition_rows(ja, shards)
    got = tdist.concat_csr_shards(t_sh.indptr, t_sh.indices, t_sh.values, ta.k)
    want = jdist.concat_csr_shards(j_sh.indptr, j_sh.indices, j_sh.values, ja.k)
    assert got.shape == want.shape == (shards * t_sh.m_loc, ta.k)
    for f in ("indptr", "indices", "values"):
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("placement", ["replicated", "allgather"])
@pytest.mark.parametrize("case", ["m96_S8", "m91_S8", "m5_S8", "empty_rows_S6"])
def test_sharded_phases_match_the_single_device_ones(case, placement):
    """dist_symbolic's row sizes are the reference's single-device symbolic
    sizes; dist_numeric's merged C is distributed_spgemm's."""
    (ja, ta), shards = CASES[case]
    jb, tb = _random(ta.k, 30, 2.0, 77)
    mesh = compat.make_mesh((shards,), ("data",), device="cpu")
    a_sh = tdist.partition_rows(ta, shards)
    b_in = tb if placement == "replicated" else tdist.partition_rows(tb, shards)
    fm_cap = tdist.shard_fm_cap(a_sh, tb)
    sizes = tdist.dist_symbolic(a_sh, b_in, mesh, "data", fm_cap)
    assert sizes.shape == (shards, a_sh.m_loc)
    want = np.asarray(j_symbolic_plain(ja, jb, 1 << 12))
    _same(sizes.reshape(-1)[:ta.m], want)
    assert not sizes.reshape(-1)[ta.m:].any()
    nnz_cap = round_capacity(int(sizes.sum(1).max()))
    c_sh = tdist.dist_numeric(a_sh, b_in, mesh, "data", fm_cap, nnz_cap)
    got = tdist.merge_shards(c_sh, ta.m)
    c = tdist.distributed_spgemm(ta, tb, mesh, b_placement=placement)
    for f in ("indptr", "indices", "values"):
        assert torch.equal(getattr(got, f), getattr(c, f)), f


def test_unknown_placement_raises_a_config_error():
    (_, ta), shards = CASES["m96_S8"]
    mesh = compat.make_mesh((shards,), ("data",), device="cpu")
    with pytest.raises(SpgemmConfigError):
        tdist.distributed_spgemm(ta, ta, mesh, b_placement="bogus")


# --------------------------------------------------------------------------
# The memory pool
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["one2one", "many2many"])
@pytest.mark.parametrize("budget", [None, 1, 100, 4096, 1 << 20])
def test_size_pool_and_chunk_for_step_match_the_reference(mode, budget):
    for maxrf, conc in ((0, 0), (1, 1), (37, 64), (1024, 5000)):
        got = tpool.size_pool(maxrf, conc, mode, bytes_budget=budget)
        want = jpool.size_pool(maxrf, conc, mode, bytes_budget=budget)
        assert (got.num_chunks, got.chunk_size, got.mode, got.total_entries) == (
            want.num_chunks, want.chunk_size, want.mode, want.total_entries)
        steps = np.arange(0, 300, 7, dtype=np.int32)
        _same(tpool.chunk_for_step(got, torch.from_numpy(steps)),
              jpool.chunk_for_step(want, jnp.asarray(steps)))
        assert tpool.chunk_for_step(got, 123) == jpool.chunk_for_step(want, 123)


@pytest.mark.parametrize("num_chunks", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_acquire_release_sim_matches_the_reference(num_chunks, seed):
    rng = np.random.default_rng(seed)
    tids = rng.integers(0, 50, 60).astype(np.int32)
    holds = rng.integers(0, 6, 60).astype(np.int32)
    got = tpool.acquire_release_sim(torch.from_numpy(tids), torch.from_numpy(holds), num_chunks)
    want = jpool.acquire_release_sim(jnp.asarray(tids), jnp.asarray(holds), num_chunks)
    _same(got, want)


# --------------------------------------------------------------------------
# Compressed collectives and the pipeline on the single-process mesh
# --------------------------------------------------------------------------


def _x():
    return np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)


def test_quantize_and_topk_are_bitwise_the_references():
    x = _x()
    q, s = tcoll.quantize_int8(torch.from_numpy(x))
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    _same(q, jq)
    _same(s, js)
    _same(tcoll.dequantize_int8(q, s, x.shape), jcoll.dequantize_int8(jq, js, x.shape))
    np.testing.assert_allclose(tcoll.dequantize_int8(q, s, x.shape).numpy(), x, atol=2e-2)
    v, i, r = tcoll.topk_compress(torch.from_numpy(x), 64)
    jv, ji, jr = jcoll.topk_compress(jnp.asarray(x), 64)
    _same(v, jv)
    _same(i.to(torch.int32), ji)
    _same(r, jr)
    dec = tcoll.topk_decompress(v, i, x.shape)
    _same(dec, jcoll.topk_decompress(jv, ji, x.shape))
    np.testing.assert_allclose((dec + r).numpy(), x, atol=1e-6)


def test_compressed_psum_is_the_mean_of_the_dequantized_operands():
    x = _x()
    mesh = compat.make_mesh((8,), ("data",), device="cpu")
    got = tcoll.compressed_psum(torch.from_numpy(x), mesh, "data")
    assert got.shape == x.shape
    want = np.broadcast_to(x.mean(0, keepdims=True), x.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2)
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    deq = np.asarray(jcoll.dequantize_int8(jq, js, x.shape))
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(deq.mean(0), x.shape),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stages", [4, 1])
def test_pipeline_forward_matches_the_serial_loop(stages):
    rng = np.random.default_rng(0)
    d = 16
    ws = torch.from_numpy((rng.standard_normal((stages, d, d)) * 0.3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 4, d)).astype(np.float32))

    def layer(w, h):
        return torch.tanh(h @ w)

    want = x
    for i in range(stages):
        want = layer(ws[i], want)
    mesh = compat.make_mesh((stages,), ("pipe",), device="cpu")
    got = pipeline_forward(layer, ws, x, mesh, axis="pipe")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_mesh_primitives_and_use_mesh():
    mesh = compat.make_mesh((2, 4), ("pipe", "data"), device="cpu")
    assert mesh.shape == {"pipe": 2, "data": 4} and mesh.axis_shapes == (2, 4)
    x = torch.arange(12.0).view(4, 3)
    assert torch.equal(mesh.all_gather(x, "data"), x)
    assert torch.equal(mesh.psum(x, "data"), x.sum(0).expand(4, 3))
    assert torch.equal(mesh.ppermute(x, 1, "data"), x[[3, 0, 1, 2]])
    assert torch.equal(mesh.local(x, "data"), x)
    assert compat.current_mesh() is None
    with compat.use_mesh(mesh) as bound:
        assert bound is mesh and compat.current_mesh() is mesh
    assert compat.current_mesh() is None
    for bad in (lambda: mesh.all_gather(x[:3], "data"), lambda: mesh.psum(x, "model"),
                lambda: compat.make_mesh((0,), ("data",), device="cpu"),
                lambda: compat.make_mesh((2,), ("a", "b"), device="cpu")):
        with pytest.raises(SpgemmConfigError):
            bad()

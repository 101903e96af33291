"""The yardstick: K1's bound counted by hand, the float64 reference against
a dense product, the trace reader on a made-up trace, and the frozen input
generators against the port's generators and the smoothed-aggregation rule
they copy."""
from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pb_yardstick
from pb_core import Csr, load_module, HERE, reference
import pb_trace
from pb_trace import TraceData

poisson = load_module(HERE / "inputs" / "poisson2d_sa.py", "pb_inputs_poisson2d_sa")
rmat = load_module(HERE / "inputs" / "rmat_graph500.py", "pb_inputs_rmat_graph500")
ref = reference("spgemm")


def csr(dense) -> Csr:
    m = sp.csr_matrix(np.asarray(dense, np.float32))
    return Csr(indptr=torch.from_numpy(m.indptr.astype(np.int32)),
               indices=torch.from_numpy(m.indices.astype(np.int32)),
               values=torch.from_numpy(m.data), shape=m.shape)


def test_numeric_phase_bytes_by_hand():
    # A 2x3 with 3 entries, B 3x2 with 4 entries, C = A·B 2x2 with 3 entries:
    # row 0 takes 2 + 1 products into columns {0, 1}, row 1 one into {1}
    a = csr([[1, 0, 2], [0, 3, 0]])
    b = csr([[1, 1], [0, 5], [7, 0]])
    c = ref.compute(a, b)
    assert c.nnz == 3 and ref.count_products(a, b) == 4
    nbytes, flops = pb_yardstick.numeric_phase_work(2, 3, 3, 4, 2, c.nnz, 4)
    # A: (3 + 3) ints + 3 floats; B: (4 + 4) ints + 4 floats; C: (3 + 3) ints
    # read + 3 floats written
    assert nbytes == 4 * (6 + 3) + 4 * (8 + 4) + 4 * 6 + 4 * 3 == 120
    assert flops == 8
    assert ref.work(a, b, c) == (nbytes, flops)
    # two value sets in one call: the structures once, the values twice
    assert ref.work(a, b, c, 2) == (nbytes + 4 * (3 + 4 + 3), 2 * flops)
    t, what = pb_yardstick.bound_s(nbytes, flops)
    assert what == "bytes" and t == pytest.approx(120 / 3.35e12)
    assert pb_yardstick.bound_s(8, 10**9)[1] == "flops"


def test_reference_matches_a_dense_product_and_keeps_cancelled_entries():
    rng = np.random.default_rng(5)
    da = rng.standard_normal((40, 30)) * (rng.random((40, 30)) < 0.2)
    db = rng.standard_normal((30, 50)) * (rng.random((30, 50)) < 0.2)
    da[0, :], db[:2, :] = 0, 0
    da[0, :2] = 1
    db[0, 7], db[1, 7] = 1, -1  # C[0, 7] cancels to 0 but is a structural entry
    a, b = csr(da.astype(np.float32)), csr(db.astype(np.float32))
    c = ref.compute(a, b, block_products=17)  # several row blocks
    dense = np.zeros((40, 50))
    rows = np.repeat(np.arange(40), np.diff(c.indptr.numpy()))
    dense[rows, c.indices.numpy()] = c.values.numpy()
    want = da.astype(np.float32).astype(np.float64) @ db.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(dense, want, atol=1e-12)
    struct = (np.abs(da) > 0).astype(int) @ (np.abs(db) > 0).astype(int) > 0
    assert c.nnz == int(struct.sum()) and struct[0, 7] and dense[0, 7] == 0
    scale = np.abs(da.astype(np.float32)) @ np.abs(db.astype(np.float32))
    assert c.scale[c.indptr[0]:c.indptr[1]].numpy() == pytest.approx(scale[0][struct[0]])
    low = ref.compute(a, b, dtype=torch.bfloat16, with_scale=False)
    assert torch.equal(low.indices, c.indices) and low.values.dtype == torch.bfloat16


def _ev(s, e, name, corr=0, linked=0, ann=False, thread=1):
    return (s, e, name, thread, corr, linked, ann)


def test_trace_reader_on_a_made_up_trace():
    cpu = [_ev(0, 1000, "bench.window", 1, ann=True),
           _ev(100, 400, "plan.build", 2, ann=True),
           _ev(150, 160, "aten::sort", 3),
           _ev(155, 158, "cudaLaunchKernel", 9),
           _ev(500, 900, "numeric.dispatch", 4, ann=True),
           _ev(600, 800, "cudaLaunchKernel", 10),
           _ev(700, 850, "Command Buffer Full"),
           _ev(850, 860, "aten::copy_", 5)]
    dev = [(200, 300, "sort_kernel", 3), (700, 750, "segsum_reuse_kernel", 4),
           (740, 760, "replay_ends", 4)]
    t = TraceData(cpu, dev)
    assert (t.w0, t.w1) == (0, 1000)
    assert t.busy_s == pytest.approx(160e-9)
    assert t.span_device_s("plan.build") == pytest.approx(100e-9)
    assert t.span_device_s("numeric.dispatch") == pytest.approx(70e-9)
    # the launch at 600-800 beyond the least launch (3): 603-800, with the
    # overhead event 700-850 merged
    assert t.blocked() == [[603, 850]]
    assert t.kernel_s(lambda n: "segsum" in n or "replay_ends" in n) == pytest.approx(70e-9)
    idle = t.idle_by_host()
    assert sum(idle.values()) == pytest.approx(1e-6 - 160e-9)
    # gaps 0-200 (mid 100: plan.build just opened), 300-700 (mid 500: numeric.dispatch),
    # 760-1000 (mid 880: numeric.dispatch, its copy done)
    assert idle["plan.build"] == pytest.approx(200e-9)
    assert idle["numeric.dispatch"] == pytest.approx(400e-9 + 240e-9)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["sort_kernel", pytest.approx(100e-9)]


def test_trace_reader_without_host_operations():
    # the CUDA activity alone: kernels, runtime calls and overhead events
    cpu = [_ev(100, 115, "cudaLaunchKernel", 7),
           _ev(115, 400, "Command Buffer Full", 11),
           _ev(500, 510, "cuLaunchKernel", 8),
           _ev(520, 560, "cudaLaunchKernel", 9),
           _ev(600, 900, "cudaDeviceSynchronize", 12)]
    dev = [(120, 450, "segsum_reuse_kernel", 70), (520, 900, "replay_ends", 80)]
    t = TraceData(cpu, dev)
    assert (t.w0, t.w1) == (100, 900)
    assert t.busy_s == pytest.approx(710e-9)
    # held: the overhead event, the second launch beyond the least (15 ns);
    # the closing synchronisation is the harness's, not a replay's
    assert t.blocked() == [[115, 400], [535, 560]]
    assert t.blocked_s == pytest.approx(310e-9)
    assert t.span_count("plan.build") == 0 and t.span_device_s("plan.build") == 0
    assert t.idle_by_host() == {"no span / cudaLaunchKernel": pytest.approx(20e-9),
                                "no span": pytest.approx(70e-9)}
    assert pb_trace.is_runtime_call("cudaLaunchKernel") and pb_trace.is_runtime_call("cuMemcpy")
    assert not pb_trace.is_runtime_call("aten::copy_")
    assert not pb_trace.is_runtime_call("custom_op")


def test_multigrid_inputs_are_the_port_stencil_and_the_sa_rule():
    from repro_torch.sparse.generators import stencil2d_csr

    nx, ny = 23, 20
    cfg = {"grid": [nx, ny], "aggregate": [3, 3], "damping": 4 / 3, "lambda_max": 2.0}
    ops = {k: tuple(x.numpy() if torch.is_tensor(x) else x for x in v)
           for k, v in poisson.operands(cfg, 0, 0, "cpu").items()}
    port = stencil2d_csr(nx, ny, device="cpu")
    for got, want in zip(ops["A"][:3], (port.indptr, port.indices, port.values)):
        assert np.array_equal(got, want.numpy())
    n = nx * ny
    a = sp.csr_matrix((ops["A"][2], ops["A"][1], ops["A"][0]), shape=(n, n))
    ii, jj = np.divmod(np.arange(n), ny)
    agg = (ii // 3) * -(-ny // 3) + jj // 3
    size = np.bincount(agg)
    p_tent = sp.csr_matrix((1 / np.sqrt(size[agg]), (np.arange(n), agg)))
    want = ((sp.eye(n) - (4 / 3) / 2 * sp.diags(1 / a.diagonal()) @ a) @ p_tent).tocsr()
    want.sort_indices()
    p = sp.csr_matrix((ops["P"][2], ops["P"][1], ops["P"][0]), shape=ops["P"][3])
    assert np.array_equal(p.indptr, want.indptr) and np.array_equal(p.indices, want.indices)
    assert abs(p - want).max() < 1e-6
    r = sp.csr_matrix((ops["R"][2], ops["R"][1], ops["R"][0]), shape=ops["R"][3])
    assert abs(r - p.T).max() == 0 and r.has_sorted_indices


def test_rmat_inputs_are_the_port_graph_relabelled():
    from repro_torch.sparse.generators import rmat_csr

    cfg = {"scale": 9, "edge_factor": 16, "initiator": [0.57, 0.19, 0.19],
           "structure_seeds": [4]}
    ip, idx, val, shape = (x.numpy() if torch.is_tensor(x) else x
                           for x in rmat.operands(cfg, 2**40 + 3, 0, "cpu")["A"])
    port = rmat_csr(9, 16, seed=4, device="cpu")
    pi, px = port.indptr.numpy(), port.indices.numpy()
    assert ip[-1] == pi[-1]
    # same products and the same result size: the graph up to a relabelling
    mine = sp.csr_matrix((np.ones_like(val), idx, ip), shape=shape)
    theirs = sp.csr_matrix((np.ones(pi[-1], np.float32), px[:pi[-1]], pi), shape=shape)
    assert (mine @ mine).nnz == (theirs @ theirs).nnz
    assert sorted(np.diff(ip)) == sorted(np.diff(pi))
    again = rmat.operands(cfg, 2**40 + 3, 0, "cpu")["A"]
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(again[:3], (ip, idx, val)))

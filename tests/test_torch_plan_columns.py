"""``kernels.plan_columns``: C's column indices of a fresh plan, the CUDA
kernel on the card and the scatter-max (its plain version) on the CPU.

On the CPU the wrapper runs the plain version and launches nothing; the
plan arrays it yields are held bitwise against the JAX package in
tests/test_torch_spgemm.py. The tests marked ``cuda`` hold the kernel bit for
bit against the plain version on the fresh path's sorted expansions of RMAT
graph 0's A*A and the multigrid A*P (``plan_columns_cases``, which phase 2b
of ``chip_smoke.py`` runs too) and skip where there is no card. This file imports no JAX, so on a machine with a card and no JAX they
run with ``pytest --noconftest -m cuda tests/test_torch_plan_columns.py``.
"""
import numpy as np
import pytest
import torch
from plan_columns_cases import plan_columns_cases

from repro_torch.core.spgemm import spgemm
from repro_torch.kernels import plan_columns as pc
from repro_torch.obs import trace
from repro_torch.runtime.validate import SpgemmInputError
from repro_torch.sparse import generators as gen

@pytest.fixture
def cuda():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.fixture
def _tracing_on():
    trace.clear()
    trace.set_tracing("on")
    yield
    trace.set_tracing("off")
    trace.clear()


def _arrays(heads, seg_ids, cols_s, device="cpu"):
    return (torch.tensor(heads, dtype=torch.bool, device=device),
            torch.tensor(seg_ids, dtype=torch.int32, device=device),
            torch.tensor(cols_s, dtype=torch.int32, device=device))


# (heads, seg_ids, cols_s): two rows' groups, non-heads and two padding
# products whose ids sit at the last group; a head with a negative column
HAND = ([1, 0, 1, 1, 0, 0, 0], [0, 0, 1, 2, 2, 2, 2], [4, 4, 7, -3, -3, 0, 0])


@pytest.mark.parametrize("nnz_cap, want", [(3, [4, 7, 0]), (6, [4, 7, 0, 0, 0, 0]),
                                           (2, [4, 7]), (0, [])])
def test_plain_version_is_the_scatter_max(nnz_cap, want):
    """Each head's column at its id, 0 beyond nnz and for a negative column
    (the scatter-max starts from zeros), ids past nnz_cap dropped."""
    got = pc.plan_columns_plain(*_arrays(*HAND), nnz_cap)
    assert got.dtype == torch.int32 and got.tolist() == want


def test_cpu_tensors_take_the_plain_version():
    """Every case of ``plan_columns_cases``, at a small size: the plain
    version's output and no launch."""
    launches, cases = pc.LAUNCHES, 0
    for case, heads, seg_ids, cols_s, nnz_cap, _ in plan_columns_cases("cpu", 7, 24):
        got = pc.plan_columns(heads, seg_ids, cols_s, nnz_cap)
        assert got.dtype == torch.int32 and tuple(got.shape) == (nnz_cap,), case
        assert torch.equal(got, pc.plan_columns_plain(heads, seg_ids, cols_s, nnz_cap)), case
        cases += 1
    assert pc.LAUNCHES == launches and cases == 17


BAD = {
    "heads int32": lambda h, s, c: (h.int(), s, c),
    "seg_ids int64": lambda h, s, c: (h, s.long(), c),
    "cols_s float": lambda h, s, c: (h, s, c.float()),
    "cols_s numpy": lambda h, s, c: (h, s, c.numpy()),
    "lengths differ": lambda h, s, c: (h, s[:-1], c),
    "2-D": lambda h, s, c: (h[None], s[None], c[None]),
    "strided": lambda h, s, c: (h[::2], s[::2], c[::2]),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(SpgemmInputError):
        pc.plan_columns(*BAD[bad](*_arrays(*HAND)), 3)


@pytest.mark.parametrize("nnz_cap", [-1, 2**31])
def test_wrapper_refuses_nnz_cap_outside_int32(nnz_cap):
    with pytest.raises(SpgemmInputError, match="nnz_cap"):
        pc.plan_columns(*_arrays(*HAND), nnz_cap)


def _plan_build_spans(device):
    a = gen.random_csr(40, 30, 3.0, 1, device=device)
    b = gen.random_csr(30, 35, 3.0, 2, device=device)
    spgemm(a, b, method="sparse", plan_cache=False)
    return [e for e in trace.events() if e["name"] == "plan.build"]


def test_cpu_plan_build_launches_no_kernel(_tracing_on):
    """A fresh multiply of CPU tensors builds its plan with the plain
    version: one ``plan.build`` span, no launch."""
    launches = pc.LAUNCHES
    assert len(_plan_build_spans("cpu")) == 1
    assert pc.LAUNCHES == launches


@pytest.mark.cuda
def test_cuda_plan_build_launches_the_kernel_once(cuda, _tracing_on):
    launches = pc.LAUNCHES
    assert len(_plan_build_spans(cuda)) == 1
    assert pc.LAUNCHES == launches + 1


@pytest.mark.cuda
def test_kernel_matches_plain_bitwise_on_the_card(cuda):
    """RMAT graph 0's A*A and the multigrid A*P at full size, nnz_cap at,
    above and below nnz, misaligned views, and an expansion with no
    product: each bit for bit the plain version's."""
    for case, heads, seg_ids, cols_s, nnz_cap, _ in plan_columns_cases("cuda"):
        want = pc.plan_columns_plain(heads, seg_ids, cols_s, nnz_cap)
        launches = pc.LAUNCHES
        got = pc.plan_columns(heads, seg_ids, cols_s, nnz_cap)
        torch.cuda.synchronize()
        assert pc.LAUNCHES == launches + (heads.shape[0] > 0 and nnz_cap > 0), case
        assert torch.equal(got, want), case


@pytest.mark.cuda
def test_kernel_matches_plain_on_hand_made_heads(cuda):
    heads, seg_ids, cols_s = _arrays(*HAND, device=cuda)
    for nnz_cap in (0, 2, 3, 6):
        got = pc.plan_columns(heads, seg_ids, cols_s, nnz_cap)
        np.testing.assert_array_equal(
            got.cpu().numpy(), pc.plan_columns_plain(heads, seg_ids, cols_s, nnz_cap).cpu().numpy())

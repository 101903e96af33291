"""K3 spgemm_lp's row binning (``lp_bins``, ``lp_row_class``,
``class_bounds``) on the CPU, held against the kernel's table formula
(``lp_table_slots``) and against the size classes written in
``csrc/spgemm_lp.cu``, which no CPU run compiles.

The binning runs on the device in the wrapper; the same torch ops run here
on CPU tensors. What holds, for per-row and forced L1 sizes:

* every non-empty row lands in exactly one class, empty rows in none;
* a row's class is the smallest whose tables hold its ``lp_table_slots``,
  and a row past the last shared class gets a device-memory allotment of at
  least its slots;
* the class limits equal the ``.cu``'s ``kClasses``, and each class's block
  fits the card's 227 KiB of shared memory.

The card tests of the kernel over every class are in
tests/test_torch_kernels.py.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import spgemm_lp as k3

L1_SIZES = [None, 2, 4, 16, 64, 1024, 16384, 32768]


def _kernel_classes():
    """(slots, team, threads) of each entry of kClasses in spgemm_lp.cu."""
    src = (_build.CSRC_DIR / "spgemm_lp.cu").read_text()
    body = re.search(r"constexpr SizeClass kClasses\[\] = \{(.*?)\};", src, re.S).group(1)
    return [tuple(int(x) for x in t) for t in re.findall(r"\{(\d+), (\d+), (\d+)\}", body)]


def _c_nnz(seed, m=4000, r_c=30_000):
    """Row sizes over every class: 0, each class limit and its neighbours,
    log-uniform sizes up to past r_c, and garbage below 0 and above r_c."""
    rng = np.random.default_rng(seed)
    edges = [b + d for b in (1, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                             16384) for d in (-1, 0, 1)]
    rand = np.floor(np.exp(rng.random(m) * np.log(2 * r_c))).astype(np.int64) - 1
    junk = [-5, -1, r_c, r_c + 1, 2**31 - 1]
    return torch.from_numpy(np.concatenate([[0], edges, rand, junk]).astype(np.int32))


@pytest.mark.parametrize("l1_size", L1_SIZES)
def test_every_row_lands_in_one_class_that_holds_its_tables(l1_size):
    r_c = 30_000
    c_nnz = _c_nnz(int(l1_size or 0))
    slots = k3.lp_table_slots(c_nnz, r_c, l1_size)
    rows, class_rows, g_off, g_slots = k3.lp_bins(c_nnz, r_c, l1_size)
    assert len(class_rows) == len(k3.CLASS_SLOTS) + 1
    assert rows.dtype == torch.int64 and rows.shape[0] == sum(class_rows)
    # each non-empty row exactly once, no empty row
    assert sorted(rows.tolist()) == torch.nonzero(slots > 0).flatten().tolist()
    caps = list(k3.CLASS_SLOTS) + [None]
    start = 0
    for c, (cap, n) in enumerate(zip(caps, class_rows)):
        mine = rows[start:start + n]
        start += n
        assert mine.tolist() == sorted(mine.tolist())  # stable: ascending in a class
        assert bool((k3.lp_row_class(c_nnz, l1_size)[mine] == c).all())
        smaller = 0 if c == 0 else k3.CLASS_SLOTS[c - 1]
        assert bool((slots[mine] > smaller).all())  # no smaller class holds them
        if cap is not None:
            assert bool((slots[mine] <= cap).all())
    assert bool((k3.lp_row_class(c_nnz, l1_size)[slots == 0] == -1).all())
    if class_rows[-1]:
        # the kernel's allotment of device-memory row p: [g_off[p], g_off[p + 1])
        wide = rows[-class_rows[-1]:]
        assert g_off.shape[0] == class_rows[-1] + 1 and int(g_off[0]) == 0
        assert bool((g_off[1:] - g_off[:-1] >= slots[wide]).all())
        assert int(g_off[-1]) == g_slots
    else:
        assert g_off is None and g_slots == 0


@pytest.mark.parametrize("l1_size", L1_SIZES)
def test_a_forced_l1_only_sizes_rows_that_can_spill(l1_size):
    """A row whose c_nnz is within the forced L1's cutoff gets the tables of
    ``l1_size=None``; a row past it gets ``l1_size`` slots more (its L1)."""
    r_c = 30_000
    c_nnz = _c_nnz(5)
    free = k3.lp_table_slots(c_nnz, r_c, None)
    forced = k3.lp_table_slots(c_nnz, r_c, l1_size)
    cn = c_nnz.clamp(0, r_c)
    spills = (cn > k3.l1_cutoff(l1_size)) if l1_size else torch.zeros_like(cn, dtype=bool)
    assert torch.equal(forced, torch.where(spills & (cn > 0), free + (l1_size or 0), free))


def test_a_large_forced_l1_costs_nothing_at_multigrid_a_p():
    """At multigrid 512^2 A*P (rows of at most 4 columns), l1_size=65,536
    sizes every row as l1_size=None does and sends none to device memory:
    the rule that gave every row the forced L1 allotted 1.7e10 slots there
    (137 GB)."""
    import scipy.sparse as sp

    from repro_torch.sparse import galerkin_triple

    _, a, p = galerkin_triple(512, 512, agg_size=4, device="cpu")

    def scipy_csr(c):
        nnz = int(c.indptr[-1])
        return sp.csr_matrix((np.ones(nnz, np.float32), c.indices[:nnz].numpy(),
                              c.indptr.numpy()), shape=c.shape)

    c = scipy_csr(a) @ scipy_csr(p)
    c_nnz = torch.from_numpy(np.diff(c.indptr).astype(np.int32))
    r_c = int(c_nnz.max())
    assert c_nnz.shape[0] == 262_144 and r_c == 4
    free = k3.lp_table_slots(c_nnz, r_c, None)
    forced = k3.lp_table_slots(c_nnz, r_c, 65_536)
    assert int(forced.sum()) == int(free.sum()) == 8 * 262_144
    cls = k3.lp_row_class(c_nnz, 65_536)
    assert not bool((cls == len(k3.CLASS_SLOTS)).any())
    assert torch.equal(cls, k3.lp_row_class(c_nnz, None))
    _, class_rows, g_off, g_slots = k3.lp_bins(c_nnz, r_c, 65_536)
    assert class_rows[-1] == 0 and g_off is None and g_slots == 0


@pytest.mark.parametrize("l1_size", L1_SIZES)
def test_class_bounds_are_the_largest_row_each_class_holds(l1_size):
    bounds = k3.class_bounds(l1_size)
    assert list(bounds) == sorted(bounds)
    for cap, bound in zip(k3.CLASS_SLOTS, bounds):
        probe = torch.tensor([bound, bound + 1], dtype=torch.int32)
        slots = k3.lp_table_slots(probe, 2**31 - 1, l1_size).tolist()
        assert bound == 0 or slots[0] <= cap
        assert slots[1] > cap


def test_comparison_builds_are_never_the_ports():
    """scripts/k3_variants.py builds the identity hash with a macro that the
    port's flags never set."""
    src = (_build.CSRC_DIR / "spgemm_lp.cu").read_text()
    assert "#ifdef SPGEMM_LP_IDENTITY_HASH" in src
    assert not any("SPGEMM_LP_IDENTITY_HASH" in flag for flag in _build.NVCC_FLAGS)


def test_class_limits_equal_the_kernel_source():
    classes = _kernel_classes()
    assert [s for s, _, _ in classes[:-1]] == list(k3.CLASS_SLOTS)
    assert classes[-1][0] == 0  # the last class keeps its tables in device memory
    assert list(k3.CLASS_SLOTS) == sorted(set(k3.CLASS_SLOTS))
    for slots, team, threads in classes:
        assert team & (team - 1) == 0 and threads % team == 0 and threads <= 1024
        assert team <= 32 or team == threads  # a wider team is the whole block
        # smem_bytes: a staged A entry per thread, a counter and tables per row
        assert threads * 16 + (threads // team) * (4 + 8 * slots) <= 232_448
    # lp_home_slot, which the card tests use to make keys collide, is lp_hash
    src = (_build.CSRC_DIR / "spgemm_lp.cu").read_text()
    assert f"static_cast<uint32_t>(key) * {k3.LP_HASH_MUL}u" in src


@pytest.mark.parametrize("widest", [8192, 8193])
def test_the_binning_waits_for_the_device_once_or_twice(monkeypatch, widest):
    """One wait (``tolist``) per call, a second (``int``) only where a row
    needs device-memory tables (c_nnz past 8,192), and none of the ops that
    wait on their own (``nonzero``, ``bincount``, ``unique``) on a CUDA
    tensor: the wrapper it replaced waited four times. The first call for an
    l1_size also finds the class bounds, on the host (``class_bounds``, cached).
    """
    c_nnz = _c_nnz(3).clamp(max=widest)
    k3.lp_bins(c_nnz, 30_000, None)  # the first call, which fills the caches
    calls = {"tolist": 0, "__int__": 0}
    for name in calls:
        real = getattr(torch.Tensor, name)

        def counting(self, _real=real, _name=name):
            calls[_name] += 1
            return _real(self)

        monkeypatch.setattr(torch.Tensor, name, counting)
    for name in ("nonzero", "bincount", "unique", "item"):
        monkeypatch.setattr(torch, name, None, raising=False)
        monkeypatch.setattr(torch.Tensor, name, None, raising=False)
    k3.lp_bins(c_nnz, 30_000, None)
    assert calls == {"tolist": 1, "__int__": int(widest > 8192)}

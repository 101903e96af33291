"""K4 spgemm_numeric's window classes and K5 spgemm_symbolic's nonzero-word
index: the rules the wrappers and kernels share, on the CPU, and both
kernels against their plain versions on the card.

On the CPU (held against a numpy reading of the same rule, and against the
constants written in the ``.cu`` sources, which no CPU run compiles):

* a row's window is the span of its C columns ``c_idx[i, :c_nnz[i]]``,
  clamped into [0, k), whatever their order; its class is the first of
  ``CLASS_COLS`` that holds the window, else the wide class; an empty row
  (c_nnz <= 0) has none;
* the class table mirrors ``kClasses``: a team is a power of two, shares a
  warp or is its block, and each class's block fits shared memory;
* K5's index: one summary bit per bitmask word that is not zero, the row's
  first and last nonzero word and its count, in the layout the launch's
  scratch holds (``index_ints``, ``index_views``).

The ``cuda`` tests hold K4 to its plain version in every window class (the
wide class at k = 65,536 and 70,001 with windows past its shared columns),
on empty rows, unsorted C columns, C and B columns outside [0, k), with and
without ``b_nnz``, in f32, bf16 and bf16 x f32; and K5 bitwise to its plain
version, with its index, on all-zero and dense B rows, clamped column ids,
k32 of 1, 37, 2,048, past the warps' accumulators and past shared memory.
They skip where there is no card; on a card without JAX they run with
``pytest --noconftest -m cuda tests/test_torch_dense_classes.py``. Their
operands come from ``chip_smoke.py``'s builders (``k4_window_ell``,
``k5_operands``), which its phase 2 checks on the card as well, so a new
edge case is added in one place; the CPU tests hold those builders to the
classes and rows they promise.
"""
import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import spgemm_numeric as k4
from repro_torch.kernels import spgemm_symbolic as k5

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
KM = types.SimpleNamespace(num=k4)  # the kernel modules k4_window_ell reads


@pytest.fixture
def cuda():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


def _source(name, suffix=".cu"):
    return (_build.CSRC_DIR / f"{name}{suffix}").read_text()


def _constexpr(src, name):
    return re.search(rf"constexpr int {name} = (\d+);", src).group(1)


SMEM_BYTES = int(_constexpr(_source("ell_common", ".cuh"), "kSmemBytes"))


def _wide_blocks():
    """Wide blocks an SM in spgemm_numeric.cu."""
    return int(_constexpr(_source("spgemm_numeric"), "kWideBlocks"))


def _k4_classes():
    """(cols, team, threads) of each entry of kClasses in spgemm_numeric.cu."""
    src = _source("spgemm_numeric")
    body = re.search(r"constexpr WindowClass kClasses\[\] = \{(.*?)\};", src, re.S).group(1)
    body = body.replace("kWideThreads", str(1024 // _wide_blocks()))
    return [tuple(int(x) for x in t) for t in re.findall(r"\{(\d+), (\d+), (\d+)\}", body)]


# ---------------------------------------------------------------------------
# K4: windows and classes (CPU)
# ---------------------------------------------------------------------------


def _numpy_window_class(c_idx, c_nnz, k):
    """Each row's (lo, hi, class) read row by row: class -1 for an empty row."""
    out = []
    for row, cn in zip(c_idx, c_nnz):
        cols = np.clip(row[:max(min(int(cn), row.shape[0]), 0)].astype(np.int64), 0, k - 1)
        if cols.size == 0:
            out.append((k, -1, -1))
            continue
        lo, hi = int(cols.min()), int(cols.max())
        fits = [c for c, cap in enumerate(k4.CLASS_COLS) if hi - lo + 1 <= cap]
        out.append((lo, hi, fits[0] if fits else len(k4.CLASS_COLS)))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


@pytest.mark.parametrize("k", [13, 64, 65, 513, 70_001])
def test_row_windows_and_classes_follow_the_numpy_rule(k):
    rng = np.random.default_rng(k)
    m, r_c = 400, 9
    c_idx = rng.integers(-5, k + 5, (m, r_c)).astype(np.int32)  # unsorted, past [0, k)
    c_nnz = rng.integers(-2, r_c + 3, m).astype(np.int32)  # empty, past r_c
    c_idx[:50, :3] = np.array([0, k - 1, 5 % k])  # the widest window
    for cap in k4.CLASS_COLS:  # windows at each class limit and one past
        for w, row in ((cap, 60 + cap % 97), (cap + 1, 61 + cap % 97)):
            if w <= k:
                c_idx[row, :2], c_nnz[row] = (3 % (k - w + 1), 3 % (k - w + 1) + w - 1), 2
    lo, hi = k4.row_windows(torch.from_numpy(c_idx), torch.from_numpy(c_nnz), k)
    cls = k4.window_class(torch.from_numpy(c_idx), torch.from_numpy(c_nnz), k)
    want = _numpy_window_class(c_idx, c_nnz, k)
    assert np.array_equal(lo.numpy(), want[:, 0])
    assert np.array_equal(hi.numpy(), want[:, 1])
    assert np.array_equal(cls.numpy(), want[:, 2])
    assert cls.dtype == torch.int64 and bool((cls[torch.from_numpy(c_nnz) <= 0] == -1).all())


def test_window_classes_mirror_the_kernel_source():
    classes = _k4_classes()
    assert [c[0] for c in classes[:-1]] == list(k4.CLASS_COLS)
    assert classes[-1][0] == 0  # the wide class: any window
    assert list(k4.CLASS_COLS) == sorted(k4.CLASS_COLS)
    src = _source("spgemm_numeric")
    stage = int(_constexpr(src, "kStageBytes"))
    for cols, team, threads in classes:
        assert team & (team - 1) == 0 and threads & (threads - 1) == 0
        assert team <= 32 or team == threads  # a block-wide team has the block
        if cols:
            assert threads * stage + threads // team * cols * 4 + 1024 <= SMEM_BYTES
    # the wide class's shared columns, as the source computes them: the rest
    # of the window is in device slices of k columns
    blocks = _wide_blocks()
    threads = 1024 // blocks
    wide_cols = (SMEM_BYTES // blocks - threads * stage - 1024) // 4 // 1024 * 1024
    assert wide_cols == k4.WIDE_SHARED_COLS > k4.CLASS_COLS[-1]
    assert threads * stage + wide_cols * 4 + 1024 <= SMEM_BYTES // blocks
    assert blocks <= k4.DEVICE_SLICES_PER_SM  # a device slice for every wide block


@pytest.mark.parametrize("m", [0, 1, 7, 262_144])
def test_k4_scratch_and_device_slices_follow_their_rules(m):
    n_cls = len(k4.CLASS_COLS) + 1
    # counts (padded to 8-byte alignment of the windows), windows, lists
    assert k4.scratch_ints(m) == 2 * n_cls + 2 * m + n_cls * m
    assert (2 * n_cls * 4) % 8 == 0
    assert k4.device_floats(k4.CLASS_COLS[-1], 132) == 0  # no window passes shared memory
    # wide windows that the shared columns hold: the kernel reads no slice
    assert k4.device_floats(k4.WIDE_SHARED_COLS, 132) == 0
    assert k4.device_floats(k4.WIDE_SHARED_COLS + 1, 132) == 2 * 132 * (k4.WIDE_SHARED_COLS + 1)
    assert k4.device_floats(65_536, 132) == 2 * 132 * 65_536
    assert k4.device_floats(2**31 - 1, 132) == 2**31 - 1  # at least one slice
    assert k4.device_floats(2**24, 132) == k4.DEVICE_FLOATS_CAP


# ---------------------------------------------------------------------------
# K5: the nonzero-word index (CPU)
# ---------------------------------------------------------------------------


def _numpy_index(words):
    """The index read word by word: summary bits, (first, last, count, 0)."""
    n, k32 = words.shape
    g = -(-k32 // 32)
    summary = np.zeros((n, g), np.uint32)
    meta = np.zeros((n, 4), np.int64)
    for j in range(n):
        nz = np.flatnonzero(words[j])
        for w in nz:
            summary[j, w >> 5] |= np.uint32(1 << (int(w) & 31))
        meta[j] = (nz.min(), nz.max(), nz.size, 0) if nz.size else (2**31 - 1, -1, 0, 0)
    return summary, meta


@pytest.mark.parametrize("k32", [1, 31, 32, 37, 130, 2048])
def test_symbolic_index_follows_the_numpy_rule(k32):
    g = torch.Generator().manual_seed(k32)
    bm = cs.k5_operands(8, 40, k32, 4, g, "cpu")[2]  # rows 0, 5 zero, row 3 dense
    words = bm.numpy().view(np.uint32)
    assert not words[[0, 5]].any() and (words[3] == 0xFFFFFFFF).all()
    summary, meta = k5.symbolic_index(bm)
    want_s, want_m = _numpy_index(words)
    assert summary.dtype == meta.dtype == torch.int32
    assert summary.shape == (40, k5.summary_words(k32)) and meta.shape == (40, 4)
    assert np.array_equal(summary.numpy().view(np.uint32), want_s)
    assert np.array_equal(meta.numpy(), want_m)


@pytest.mark.parametrize("n,k32,m", [(1, 1, 1), (40, 37, 9), (65_536, 2048, 65_536)])
def test_symbolic_scratch_holds_the_index(n, k32, m):
    """The scratch is meta (16-byte aligned for the kernel's int4 loads), the
    hub count, the hub list, then the summary; its views have the shapes of
    ``symbolic_index``."""
    assert k5.index_ints(n, k32, m) == 4 * n + 4 + m + n * -(-k32 // 32)
    if n * k32 > 10**6:
        return
    index = torch.arange(k5.index_ints(n, k32, m), dtype=torch.int32)
    summary, meta = k5.index_views(index, n, k32, m)
    assert meta.shape == (n, 4) and int(meta[0, 0]) == 0
    assert summary.shape == (n, k5.summary_words(k32))
    assert int(summary[-1, -1]) == index.numel() - 1


def test_symbolic_constants_mirror_the_kernel_source():
    src = _source("spgemm_symbolic")
    threads = int(_constexpr(src, "kHubThreads"))
    stage = int(_constexpr(src, "kStageBytes"))
    assert k5.SHARED_WORDS == (SMEM_BYTES - threads * stage - 1024) // 4 // 1024 * 1024
    assert threads * stage + k5.SHARED_WORDS * 4 + 1024 <= SMEM_BYTES
    assert k5.device_words(k5.SHARED_WORDS, 132) == 0
    assert k5.device_words(k5.SHARED_WORDS + 1, 132) == 4 * 132 * (k5.SHARED_WORDS + 1)
    assert int(_constexpr(src, "kWarpWords")) < k5.SHARED_WORDS


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [70_001, 65_536, 5_000])
def test_k4_window_operands_span_every_window_class(k):
    """chip_smoke's k4_window_ell, on the CPU: empty rows, a row in every
    class that k allows, C columns outside [0, k), unsorted rows, a listed
    column no product reaches, a c_nnz past rC and a negative one, B columns
    outside [0, k) within b_nnz."""
    g = torch.Generator().manual_seed(k)
    a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx, c_nnz = cs.k4_window_ell(KM, k, g, "cpu")
    cls = k4.window_class(c_idx, c_nnz, k)
    want = _numpy_window_class(c_idx.numpy(), c_nnz.numpy(), k)
    assert np.array_equal(cls.numpy(), want[:, 2])
    need = {c for c in range(len(k4.CLASS_COLS) + 1) if c == 0 or k4.CLASS_COLS[c - 1] < k}
    assert {-1} | need <= set(cls.tolist())
    r_c = c_idx.shape[1]
    assert int(c_nnz.max()) > r_c and int(c_nnz.min()) < 0
    live_c = torch.arange(r_c)[None, :] < c_nnz.clamp(0, r_c)[:, None]
    assert bool(((c_idx < 0) | (c_idx >= k))[live_c].any())
    assert bool((c_idx[:, 1:] < c_idx[:, :-1])[live_c[:, 1:]].any())  # unsorted
    assert bool(((b_idx < 0) | (b_idx >= k))[b_live].any())
    assert int(a_nnz.min()) == 0 and int(a_nnz.max()) == a_idx.shape[1]
    # a listed column of a C row that none of the row's products reaches
    reached = cs.ell_structure(a_idx, a_nnz, b_idx, b_nnz, k, drop=(b_idx < 0) | (b_idx >= k))
    unreached = [
        i for i in range(c_idx.shape[0]) if 0 < int(c_nnz[i]) <= r_c
        and set(c_idx[i, :int(c_nnz[i])].clamp(0, k - 1).tolist())
        - set(reached[0][i, :int(reached[1][i])].tolist())]
    assert unreached


K4_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", K4_DTYPES, ids=["f32", "bf16", "bf16xf32"])
@pytest.mark.parametrize("k", [70_001, 65_536, 5_000])
def test_k4_matches_plain_in_every_window_class_on_the_card(cuda, k, dtypes):
    g = torch.Generator(device=cuda).manual_seed(k)
    a_idx, a_nnz, b_idx, b_nnz, b_live, c_idx, c_nnz = cs.k4_window_ell(KM, k, g)
    cls = k4.window_class(c_idx, c_nnz, k)
    seen = set(cls.tolist())
    assert -1 in seen and {c for c in range(len(k4.CLASS_COLS) + 1)
                           if c == 0 or k4.CLASS_COLS[c - 1] < k} <= seen
    a_val = torch.randn(a_idx.shape, generator=g, device=cuda).to(dtypes[0])
    b_val = torch.randn(b_idx.shape, generator=g, device=cuda).to(dtypes[1])
    b_val0 = torch.where(b_live, b_val, torch.zeros((), dtype=dtypes[1], device=cuda))
    want = k4.spgemm_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val0, c_idx, c_nnz, k=k)
    scale = k4.spgemm_numeric_plain(a_idx, a_val.float().abs(), a_nnz, b_idx,
                                    b_val0.float().abs(), c_idx, c_nnz, k=k)
    tol = 1e-4 if dtypes[0] == torch.float32 else 8e-3
    for bn in (b_nnz, None):
        launches = k4.LAUNCHES
        got = k4.spgemm_numeric(a_idx, a_val, a_nnz, b_idx, b_val0, c_idx, c_nnz, k=k,
                                b_nnz=bn)
        torch.cuda.synchronize()
        assert k4.LAUNCHES == launches + 1
        assert got.dtype == want.dtype == dtypes[0]
        ok = (got.double() - want.double()).abs() <= tol * scale.double() + 1e-6
        assert bool(ok.all()), f"rows {torch.nonzero(~ok.all(1)).flatten().tolist()[:8]}"


@pytest.mark.cuda
@pytest.mark.parametrize("k32,r_a", cs.K5_INDEX_CASES,
                         ids=["k32=1", "k32=37", "k32=2048", "hubs-only", "device-slices"])
def test_k5_matches_plain_bitwise_on_the_card(cuda, k32, r_a):
    m, n = 300, 64
    g = torch.Generator(device=cuda).manual_seed(k32)
    a_idx, a_nnz, bm = cs.k5_operands(m, n, k32, r_a, g)
    assert (k32 > k5.SHARED_WORDS) == (k32 == cs.K5_INDEX_CASES[-1][0])
    launches = k5.LAUNCHES
    got = k5.spgemm_symbolic(a_idx, a_nnz, bm)
    torch.cuda.synchronize()
    assert k5.LAUNCHES == launches + 1
    want = k5.spgemm_symbolic_plain(a_idx, a_nnz, bm)
    assert torch.equal(got, want)
    assert int(got[1]) == 0 and int(want[m // 2]) > 0
    # the kernel's index of B's nonzero words, as the plain rule writes it
    out = torch.empty(m, dtype=torch.int32, device=cuda)
    index = k5._launch(a_idx, a_nnz, bm, out)
    torch.cuda.synchronize()
    summary, meta = k5.index_views(index, n, k32, m)
    want_s, want_m = k5.symbolic_index(bm)
    assert torch.equal(summary, want_s) and torch.equal(meta, want_m)
    assert torch.equal(out, want)

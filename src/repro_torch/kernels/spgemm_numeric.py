"""K4: the KKDENSE numeric phase over ELL operands, in CUDA (``csrc/spgemm_numeric.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/spgemm_numeric.py``
(``spgemm_numeric``). For each row of C: a dense f32 accumulator takes every
product ``a_val[i, r] * b_val[a_idx[i, r], t]`` (``r < a_nnz[i]``; all rB
slots of B's row, whose padded slots carry 0 by the contract) at column
``b_idx[...]``, and C's values are read from it at ``c_idx[i, :c_nnz[i]]``,
0 past ``c_nnz``. The output is in **``a_val.dtype``**, as the TPU kernel's
(K3, ``spgemm_lp``, returns ``promote_types(a, b)``).

What bounds it on the H100: bytes — A's live entries, the B slots visited,
C's structure once and its values once (the (m, rC) output whole, zeros
included, written first by one fill); 2 flops per product. The design (see
the source's header): a row's accumulator is dense over its window, the
span of its C columns (``row_windows``), and only its C columns are zeroed
and read, so its work is its products and c_nnz. The kernel bins rows by
window on the device (``window_class``: ``CLASS_COLS``, then a wide class),
with no host wait; small windows pack many rows into a block, 4 or 16 lanes
each, and the wide class keeps the window's first columns in shared memory
and the rest in device memory (``device_floats``), so each product is read
once. ``b_nnz`` (optional, not in the reference) lets the kernel skip B's
padded slots, which add 0.

Beside the kernel: ``spgemm_numeric_plain``, the same function in plain
torch, run by the wrapper for CPU tensors only; ``ell_numeric_plain``, the
shared plain body of K3, K4 and the reference's ``ref.spgemm_numeric_ref``
(the "xla" path of ``kernels.ops``); ``LAUNCHES``; and the ctypes launch
that ``kernels/spgemm_lp.py`` shares.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segsum_reuse import DTYPE_CODES
from repro_torch.kernels.spgemm_symbolic import check_tensor, row_chunks
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``spgemm_numeric`` (reset by callers that count)
LAUNCHES = 0

# K4's window classes (kClasses in csrc/spgemm_numeric.cu): the widest
# window (hi - lo + 1 over a row's clamped C columns) of each class whose
# accumulator is all in shared memory; wider rows take the wide class
CLASS_COLS = (64, 512, 4096, 16384)
# the wide class's columns in shared memory (kWideCols in the .cu: what two
# 512-thread blocks an SM leave each); a window's columns past them live in
# device slices, one a wide block, two an SM, of k columns each
WIDE_SHARED_COLS = 26624
DEVICE_SLICES_PER_SM = 2
DEVICE_FLOATS_CAP = 1 << 28  # 1 GiB of slices at most (but always one slice)

# expanded products per chunk of the plain versions
_PLAIN_CHUNK_PRODUCTS = 1 << 24

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = [_P, _P, _INT, _P, _I64, _P, _P, _INT, _P, _I64, _I64, _P, _P, _I64,
             _P, _I64, _I64, _P, _P, _I64, _INT, _P, _P, _P, _P, _P, _P, _P, _P]


def _pad_width(x: torch.Tensor, width: int) -> torch.Tensor:
    cur = x.shape[1]
    if cur == width:
        return x
    return torch.nn.functional.pad(x, (0, width - cur))


def check_ell_args(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                   k: int) -> None:
    """Raise ``SpgemmInputError`` on anything the ELL kernels do not take.
    The same checks run for CPU tensors, so the CPU path refuses what the
    card would."""
    device = a_idx.device if isinstance(a_idx, torch.Tensor) else None
    check_tensor("a_idx", a_idx, device, 2, (torch.int32,))
    check_tensor("a_nnz", a_nnz, device, 1, (torch.int32,))
    check_tensor("b_idx", b_idx, device, 2, (torch.int32,))
    check_tensor("c_idx", c_idx, device, 2, (torch.int32,))
    check_tensor("c_nnz", c_nnz, device, 1, (torch.int32,))
    for name, t in (("a_val", a_val), ("b_val", b_val)):
        check_tensor(name, t, device, 2, tuple(DTYPE_CODES))
    if b_nnz is not None:
        check_tensor("b_nnz", b_nnz, device, 1, (torch.int32,))
        if b_nnz.shape[0] != b_idx.shape[0]:
            raise SpgemmInputError(f"b_nnz has {b_nnz.shape[0]} rows, b_idx {b_idx.shape[0]}")
    m = a_idx.shape[0]
    if a_val.shape != a_idx.shape or b_val.shape != b_idx.shape:
        raise SpgemmInputError("ELL values and indices differ in shape")
    if not a_nnz.shape[0] == c_idx.shape[0] == c_nnz.shape[0] == m:
        raise SpgemmInputError("A's and C's rows differ in number")
    if b_idx.shape[0] == 0:
        raise SpgemmInputError("B has no rows")
    if not 1 <= k < 2**31:
        raise SpgemmInputError(f"k={k} outside [1, 2^31)")


def ell_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                      k: int, acc_dtype: torch.dtype, out_dtype: torch.dtype) -> torch.Tensor:
    """C's values at ``c_idx``/``c_nnz`` from ELL operands, in plain torch.

    Products ``a * b`` in ``acc_dtype`` for ``r < a_nnz[i]`` and B slots
    ``t < b_nnz[j]`` (every slot when ``b_nnz`` is None) whose column lies in
    [0, k); a live A column id clamps into [0, n) and a C column id into
    [0, k). Per chunk of rows, one ``index_add_`` sums each (row, column)'s
    products in the order of the insert stream (A slots row-major, then the
    B row's slots): sequential on the CPU, so the sums are exactly those of
    the reference's LP accumulator oracle. Out in ``out_dtype``.
    """
    m, r_a = a_idx.shape
    n, r_b = b_idx.shape
    r_c = c_idx.shape[1]
    dev = a_idx.device
    out = torch.zeros(m, r_c, dtype=out_dtype, device=dev)
    live_a = a_nnz.clamp(0, r_a)
    slots = torch.arange(r_b, device=dev)
    for start, stop in row_chunks(live_a * r_b, _PLAIN_CHUNK_PRODUCTS):
        rows, rs = torch.nonzero(torch.arange(r_a, device=dev)[None, :]
                                 < live_a[start:stop, None], as_tuple=True)
        j = a_idx[start:stop][rows, rs].clamp(0, n - 1).long()
        av = a_val[start:stop][rows, rs].to(acc_dtype)
        cols = b_idx[j].long()  # (E, rB), in stream order
        ok = (cols >= 0) & (cols < k)
        if b_nnz is not None:
            ok &= slots[None, :] < b_nnz[j].clamp(0, r_b)[:, None]
        prod = av[:, None] * b_val[j].to(acc_dtype)
        keys = (rows[:, None] * k + cols)[ok]
        uniq, inv = torch.unique(keys, return_inverse=True)
        sums = torch.zeros(uniq.shape[0], dtype=acc_dtype, device=dev)
        sums.index_add_(0, inv, prod[ok])
        query = (torch.arange(stop - start, device=dev)[:, None] * k
                 + c_idx[start:stop].clamp(0, k - 1).long())
        pos = torch.searchsorted(uniq, query).clamp(max=max(uniq.shape[0] - 1, 0))
        found = uniq[pos] == query if uniq.shape[0] else torch.zeros_like(query, dtype=torch.bool)
        live_c = torch.arange(r_c, device=dev)[None, :] < c_nnz[start:stop, None]
        vals = sums[pos] if uniq.shape[0] else torch.zeros_like(query, dtype=acc_dtype)
        out[start:stop] = torch.where(found & live_c, vals, 0).to(out_dtype)
    return out


def spgemm_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val, c_idx, c_nnz, *,
                         k: int, b_nnz=None) -> torch.Tensor:
    """``spgemm_numeric`` in plain torch: f32 products and sums, out in
    ``a_val.dtype``."""
    return ell_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                             k, torch.float32, a_val.dtype)


def spgemm_numeric_ref(a_idx, a_val, a_nnz, b_idx, b_val, c_idx, c_nnz, *,
                       k: int) -> torch.Tensor:
    """``kernels.ref.spgemm_numeric_ref`` in plain torch, the "xla" path of
    ``kernels.ops.numeric_values``: accumulates and returns in
    ``promote_types(a, b)``, so f64 and integer operands stay exact. Padded
    A slots are masked by ``a_nnz`` where the reference multiplies their 0."""
    acc = torch.promote_types(a_val.dtype, b_val.dtype)
    return ell_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val, None, c_idx, c_nnz,
                             k, acc, acc)


def row_windows(c_idx, c_nnz, k: int):
    """(lo, hi) int64 per row: the span of its clamped C columns
    ``c_idx[i, :c_nnz[i]]`` (lo k, hi -1 for an empty row), as K4's
    binning finds them. Torch ops, for the tests and the timing scripts."""
    r_c = c_idx.shape[1]
    live = torch.arange(r_c, device=c_idx.device)[None, :] < c_nnz.clamp(0, r_c)[:, None]
    cols = c_idx.long().clamp(0, k - 1)
    lo = torch.where(live, cols, k).amin(1) if r_c else torch.full_like(c_nnz, k).long()
    hi = torch.where(live, cols, -1).amax(1) if r_c else torch.full_like(c_nnz, -1).long()
    return lo, hi


def window_class(c_idx, c_nnz, k: int) -> torch.Tensor:
    """(m,) int64: each row's K4 class — the first of ``CLASS_COLS`` that
    holds its window (hi - lo + 1), ``len(CLASS_COLS)`` for the wide class,
    -1 for an empty row."""
    lo, hi = row_windows(c_idx, c_nnz, k)
    bounds = torch.tensor(CLASS_COLS, dtype=torch.int64, device=c_idx.device)
    cls = torch.bucketize(hi - lo + 1, bounds)
    return torch.where(hi >= 0, cls, -1)


def scratch_ints(m: int) -> int:
    """int32 scratch of a K4 launch over m rows: class counts (2 per class,
    one of them padding), the rows' windows (2 each) and one row list per
    class (m each)."""
    n_cls = len(CLASS_COLS) + 1
    return 2 * n_cls + 2 * m + n_cls * m


def device_floats(k: int, sms: int) -> int:
    """f32 of the wide class's device slices: ``DEVICE_SLICES_PER_SM`` of k
    columns an SM, at most ``DEVICE_FLOATS_CAP`` but at least one slice,
    where a window can pass the wide class's shared columns (k above
    ``WIDE_SHARED_COLS``), else 0. The kernel needs k less its shared columns
    per wide block and runs as many wide blocks as the slices hold."""
    if k <= WIDE_SHARED_COLS:
        return 0
    return max(k, min(DEVICE_SLICES_PER_SM * sms * k, DEVICE_FLOATS_CAP))


def launch_ell(lib_name: str, a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx,
               c_nnz, out, k: int, *, scratch=None, acc=None, l1_size: int = 0,
               rows=None, class_rows=None, g_off=None, g_tab=None, size_counts=None,
               lost_count=None, lost_rows=None) -> None:
    """Launch ``<lib_name>_launch`` of ``csrc/<lib_name>.cu`` (the ELL C
    interface of ``csrc/ell_common.cuh``) on the current stream, writing
    ``out`` (f32 for K3, A's dtype for K4). K4 passes its int32 ``scratch``
    and its device slices ``acc``; K3 passes its rows sorted by size class
    (``rows``, on the device) and the rows of each class (``class_rows``, a
    list read on the host), and where the kernel records rows that lost a
    product (``lost_count``, ``lost_rows``) or what sizes each row's tables
    (``size_counts``). A CUDA error after the launch raises
    ``_build.KernelLaunchError``, which the ladder of
    ``ops.numeric_values`` turns into a step to its next rung."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    counts = None if class_rows is None else (ctypes.c_int64 * len(class_rows))(*class_rows)
    m, r_a = a_idx.shape
    n, r_b = b_idx.shape
    with torch.cuda.device(a_idx.device):
        stream = torch.cuda.current_stream(a_idx.device).cuda_stream
        _build.launch(lib_name, _ARGTYPES, a_idx.data_ptr(), a_val.data_ptr(),
                      DTYPE_CODES[a_val.dtype], a_nnz.data_ptr(), r_a, b_idx.data_ptr(),
                      b_val.data_ptr(), DTYPE_CODES[b_val.dtype], ptr(b_nnz), n, r_b,
                      c_idx.data_ptr(), c_nnz.data_ptr(), c_idx.shape[1], out.data_ptr(), m,
                      k, ptr(scratch), ptr(acc), 0 if acc is None else acc.numel(), l1_size,
                      ptr(rows), counts, ptr(g_off), ptr(g_tab),
                      ptr(size_counts), ptr(lost_count), ptr(lost_rows), stream)


def spgemm_numeric(a_idx, a_val, a_nnz, b_idx, b_val, c_idx, c_nnz, *, k: int,
                   b_nnz=None) -> torch.Tensor:
    """Numeric phase: C values (ELL layout, (m, rC), in ``a_val.dtype``) at
    the given structure.

    a_idx/a_val: (m, rA) ELL of A; a_nnz: (m,); b_idx/b_val: (n, rB) ELL of B
    (padded B slots must carry value 0); c_idx: (m, rC) symbolic structure of
    C; c_nnz: (m,); k: number of columns of B; b_nnz: optional (n,) live B
    widths, which only saves the kernel the padded slots. Values are f32,
    f16 or bf16 (f32 accumulation). CUDA tensors launch the kernel (or
    raise); CPU tensors run ``spgemm_numeric_plain``.
    """
    global LAUNCHES
    check_ell_args(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, k)
    if a_idx.device.type == "cpu":
        return spgemm_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val, c_idx, c_nnz,
                                    k=k, b_nnz=b_nnz)
    if c_idx.shape[0] >= 2**31:
        raise SpgemmInputError(f"{c_idx.shape[0]} rows: K4 lists rows as int32")
    dev = a_idx.device
    out = torch.empty(c_idx.shape, dtype=a_val.dtype, device=dev)
    if out.numel():
        m = c_idx.shape[0]
        scratch = torch.empty(scratch_ints(m), dtype=torch.int32, device=dev)
        floats = device_floats(k, _build.sm_count(dev))
        acc = torch.empty(floats, dtype=torch.float32, device=dev) if floats else None
        launch_ell("spgemm_numeric", a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx,
                   c_nnz, out, k, scratch=scratch, acc=acc)
        LAUNCHES += 1
    return out


def spgemm_numeric_bucketed(a_idx, a_val, a_nnz, b_idx, b_val, c_idx, c_nnz, *,
                            k: int, pad_policy: str | None = None,
                            b_nnz=None) -> torch.Tensor:
    """``spgemm_numeric`` with ELL widths rA/rB/rC padded to capacity buckets
    (``core.meta.round_capacity``), as in the reference: zero padding keeps
    the values (padded A slots are masked by ``a_nnz``, padded B slots carry
    0, padded C slots are masked by ``c_nnz``), and the output is sliced back
    to the caller's rC."""
    from repro_torch.core.meta import DEFAULT_PAD_POLICY, round_capacity

    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    r_c = c_idx.shape[1]
    a_idx = _pad_width(a_idx, round_capacity(a_idx.shape[1], policy))
    a_val = _pad_width(a_val, a_idx.shape[1])
    b_idx = _pad_width(b_idx, round_capacity(b_idx.shape[1], policy))
    b_val = _pad_width(b_val, b_idx.shape[1])
    c_idx_p = _pad_width(c_idx, round_capacity(r_c, policy))
    out = spgemm_numeric(a_idx, a_val, a_nnz, b_idx, b_val, c_idx_p, c_nnz, k=k,
                         b_nnz=b_nnz)
    return out[:, :r_c]

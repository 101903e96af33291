"""K5: the symbolic phase over B's bitmask rows, in CUDA (``csrc/spgemm_symbolic.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/spgemm_symbolic.py``
(``spgemm_symbolic``). For each row i of C = A*B: the popcount of the OR of
B's bitmask rows ``b_bitmask[a_idx[i, r]]`` over ``r < a_nnz[i]``, i.e. the
number of distinct columns of C's row. Bitmasks are int32 tensors holding
the reference's uint32 bits (``core.compression.bitmask_rows``).

What bounds it on the H100: bytes — B's bitmask (n * k32 * 4 bytes) at
least once, and in practice one k32-word row per live A entry, mostly from
L2. The design (see the source's header): one 128-thread block per C row,
words OR-ed in registers, ``__popc`` and a block sum. The TPU-only
``k32 % 128`` alignment check is gone.

Beside the kernel: ``spgemm_symbolic_plain``, the reference's
``kernels.ref.spgemm_symbolic_ref`` in plain torch, chunked by rows, which
the wrapper runs for CPU tensors only; ``LAUNCHES``, the number of kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``spgemm_symbolic`` (reset by callers that count)
LAUNCHES = 0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P]

# words of the (rows, k32) OR accumulator per chunk of the plain version
_PLAIN_CHUNK_WORDS = 1 << 27


def check_tensor(name: str, t, device, ndim: int, dtypes) -> None:
    """Raise ``SpgemmInputError`` unless ``t`` is a contiguous tensor on
    ``device`` with ``ndim`` dimensions and a dtype in ``dtypes``."""
    if not isinstance(t, torch.Tensor):
        raise SpgemmInputError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise SpgemmInputError(f"{name} is on {t.device}, not {device}")
    if t.ndim != ndim or not t.is_contiguous():
        raise SpgemmInputError(f"{name} must be {ndim}-D and contiguous, got shape "
                               f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise SpgemmInputError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if device.type not in ("cpu", "cuda"):
        raise SpgemmInputError(f"the kernels run on cpu or cuda, not {device}")


def row_chunks(cost: torch.Tensor, budget: int):
    """Split rows into consecutive [start, stop) chunks whose summed ``cost``
    stays within ``budget`` (a row costlier than the budget gets a chunk of
    its own)."""
    m = cost.shape[0]
    if m == 0:
        return []
    cum = torch.cumsum(cost.to(torch.int64).clamp(min=1), 0).cpu()
    chunks, start, done = [], 0, 0
    while start < m:
        stop = int(torch.searchsorted(cum, done + budget, right=True))
        stop = max(stop, start + 1)
        chunks.append((start, stop))
        done = int(cum[stop - 1])
        start = stop
    return chunks


def spgemm_symbolic_plain(a_idx, a_nnz, b_bitmask) -> torch.Tensor:
    """``kernels.ref.spgemm_symbolic_ref`` in plain torch. torch has no OR
    reduction, so per chunk of rows, sorted by live width, slot r ORs B's
    selected bitmask rows into the accumulators of the rows that have a
    live slot r (a prefix, in that order); then each row's bits are
    counted. Column ids clamp into [0, n)."""
    from repro_torch.core.compression import row_popcounts

    m, r_a = a_idx.shape
    n, k32 = b_bitmask.shape
    out = torch.zeros(m, dtype=torch.int32, device=a_idx.device)
    live_w = a_nnz.clamp(0, r_a)
    budget = max(_PLAIN_CHUNK_WORDS // max(k32, 1), 1)
    for start, stop in row_chunks(torch.ones_like(live_w), budget):
        width, order = torch.sort(live_w[start:stop], descending=True, stable=True)
        idx = a_idx[start:stop][order].clamp(0, n - 1).long()
        # rows with a live slot r: the first live_rows[r] of the sorted chunk
        hist = torch.bincount(width.long(), minlength=r_a + 1).cpu()
        live_rows = (width.shape[0] - torch.cumsum(hist, 0)).tolist()
        acc = torch.zeros(stop - start, k32, dtype=torch.int32, device=a_idx.device)
        for r in range(int(width[0]) if width.numel() else 0):
            rows = live_rows[r]
            acc[:rows] |= b_bitmask[idx[:rows, r]]
        out[start + order] = row_popcounts(acc)
    return out


def _launch(a_idx, a_nnz, b_bitmask, out) -> None:
    m, r_a = a_idx.shape
    n, k32 = b_bitmask.shape
    with torch.cuda.device(a_idx.device):
        stream = torch.cuda.current_stream(a_idx.device).cuda_stream
        _build.launch("spgemm_symbolic", _ARGTYPES, a_idx.data_ptr(), r_a, a_nnz.data_ptr(),
                      b_bitmask.data_ptr(), n, k32, out.data_ptr(), m, stream)


def spgemm_symbolic(a_idx, a_nnz, b_bitmask) -> torch.Tensor:
    """Row sizes of C = A*B from A's ELL structure and B's bitmask rows.

    a_idx: (m, rA) int32 ELL column ids of A (padded slots masked by a_nnz);
    a_nnz: (m,) int32; b_bitmask: (n, k32) int32 (uint32 bits).
    Returns (m,) int32. CUDA tensors launch the kernel (or raise); CPU
    tensors run ``spgemm_symbolic_plain``.
    """
    global LAUNCHES
    device = a_idx.device if isinstance(a_idx, torch.Tensor) else None
    check_tensor("a_idx", a_idx, device, 2, (torch.int32,))
    check_tensor("a_nnz", a_nnz, device, 1, (torch.int32,))
    check_tensor("b_bitmask", b_bitmask, device, 2, (torch.int32,))
    if a_nnz.shape[0] != a_idx.shape[0]:
        raise SpgemmInputError(
            f"a_nnz has {a_nnz.shape[0]} rows, a_idx {a_idx.shape[0]}")
    if b_bitmask.shape[0] == 0:
        raise SpgemmInputError("b_bitmask has no rows")
    if device.type == "cpu":
        return spgemm_symbolic_plain(a_idx, a_nnz, b_bitmask)
    out = torch.empty(a_idx.shape[0], dtype=torch.int32, device=device)
    if a_idx.shape[0]:
        _launch(a_idx, a_nnz, b_bitmask, out)
        LAUNCHES += 1
    return out


def spgemm_symbolic_bucketed(a_idx, a_nnz, b_bitmask, *,
                             pad_policy: str | None = None) -> torch.Tensor:
    """``spgemm_symbolic`` with the ELL width rA padded to a capacity bucket
    (``core.meta.round_capacity``), as in the reference. Padded slots lie
    past ``a_nnz`` and are masked."""
    from repro_torch.core.meta import DEFAULT_PAD_POLICY, round_capacity
    from repro_torch.kernels.spgemm_numeric import _pad_width

    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    a_idx = _pad_width(a_idx, round_capacity(a_idx.shape[1], policy))
    return spgemm_symbolic(a_idx, a_nnz, b_bitmask)

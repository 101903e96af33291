"""K5: the symbolic phase over B's bitmask rows, in CUDA (``csrc/spgemm_symbolic.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/spgemm_symbolic.py``
(``spgemm_symbolic``). For each row i of C = A*B: the popcount of the OR of
B's bitmask rows ``b_bitmask[a_idx[i, r]]`` over ``r < a_nnz[i]``, i.e. the
number of distinct columns of C's row. Bitmasks are int32 tensors holding
the reference's uint32 bits (``core.compression.bitmask_rows``).

What bounds it on the H100: bytes — B's bitmask (n * k32 * 4 bytes) once.
The design (see the source's header): one sweep of the bitmask builds an
index of each B row's nonzero words (a summary bit per word and the row's
first and last nonzero word, ``symbolic_index``); then a warp per small C
row, and a block per hub row, ORs only those words into a dense k32-word
accumulator in shared memory (device memory past ``SHARED_WORDS``) and
counts the bits of the words it touched. No host wait. The TPU-only
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
_ARGTYPES = [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P, _P, _I64, _P]

# kSharedWords in csrc/spgemm_symbolic.cu: the widest accumulator (k32 words)
# a hub block keeps in shared memory; past it, in device-memory slices
SHARED_WORDS = 55296
DEVICE_SLICES_PER_SM = 4  # the hub blocks' slices an SM, past SHARED_WORDS
DEVICE_WORDS_CAP = 1 << 28  # 1 GiB of slices at most (but always one slice)

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


def summary_words(k32: int) -> int:
    """Summary words of a B row in K5's index: one bit per bitmask word."""
    return -(-k32 // 32)


def index_ints(n: int, k32: int, m: int) -> int:
    """int32 scratch of a K5 launch: each B row's meta (first and last
    nonzero word, nonzero words, padding), the hub-row count (and padding),
    the hub-row list (m) and the summary (n rows of ``summary_words``)."""
    return 4 * n + 4 + m + n * summary_words(k32)


def device_words(k32: int, sms: int) -> int:
    """int32 of the hub blocks' device slices: none where k32 words fit
    shared memory (``SHARED_WORDS``), else ``DEVICE_SLICES_PER_SM`` slices of
    k32 words an SM, at most ``DEVICE_WORDS_CAP`` but at least one slice."""
    if k32 <= SHARED_WORDS:
        return 0
    return max(k32, min(DEVICE_SLICES_PER_SM * sms * k32, DEVICE_WORDS_CAP))


def symbolic_index(b_bitmask: torch.Tensor):
    """K5's index of B's nonzero words, in plain torch, as the kernel's first
    sweep writes it: (summary, meta). ``summary`` (n, ``summary_words(k32)``)
    int32: bit w & 31 of word w >> 5 says bitmask word w of the row is
    nonzero. ``meta`` (n, 4) int32: the row's first and last nonzero word
    (2^31 - 1 and -1 for an empty row), its nonzero words, and 0."""
    n, k32 = b_bitmask.shape
    g = summary_words(k32)
    nz = torch.nn.functional.pad(b_bitmask != 0, (0, 32 * g - k32))
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64,
                           device=b_bitmask.device)
    summary = (nz.view(n, g, 32).long() * weights).sum(-1)
    summary = torch.where(summary >= 2**31, summary - 2**32, summary).to(torch.int32)
    pos = torch.arange(k32, device=b_bitmask.device)
    nzk = nz[:, :k32]
    meta = torch.stack([torch.where(nzk, pos, 2**31 - 1).amin(1) if k32 else
                        torch.full((n,), 2**31 - 1, device=b_bitmask.device),
                        torch.where(nzk, pos, -1).amax(1) if k32 else
                        torch.full((n,), -1, device=b_bitmask.device),
                        nzk.sum(1), torch.zeros(n, dtype=torch.int64,
                                                device=b_bitmask.device)], 1)
    return summary, meta.to(torch.int32)


def index_views(index: torch.Tensor, n: int, k32: int, m: int):
    """(summary, meta) views of a K5 launch's int32 scratch, shaped as
    ``symbolic_index`` returns them."""
    return (index[4 * n + 4 + m:].view(n, summary_words(k32)), index[:4 * n].view(n, 4))


def _launch(a_idx, a_nnz, b_bitmask, out) -> torch.Tensor:
    """Launch K5 into ``out``; returns its scratch (``index_views`` reads the
    index there)."""
    m, r_a = a_idx.shape
    n, k32 = b_bitmask.shape
    dev = a_idx.device
    index = torch.empty(index_ints(n, k32, m), dtype=torch.int32, device=dev)
    words = device_words(k32, _build.sm_count(dev))
    slices = torch.empty(words, dtype=torch.int32, device=dev) if words else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch("spgemm_symbolic", _ARGTYPES, a_idx.data_ptr(), r_a, a_nnz.data_ptr(),
                      b_bitmask.data_ptr(), n, k32, out.data_ptr(), m, index.data_ptr(),
                      None if slices is None else slices.data_ptr(), words, stream)
    return index


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
    if a_idx.shape[0] >= 2**31 or b_bitmask.shape[1] >= 2**26:
        raise SpgemmInputError("K5 lists rows and words as int32: m < 2^31, k32 < 2^26")
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

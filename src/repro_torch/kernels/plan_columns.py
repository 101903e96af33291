"""C's column indices of a fresh plan in CUDA (``csrc/plan_columns.cu``).

Replaces no TPU kernel: the reference writes the columns in
``plan_from_sorted`` with an XLA scatter-max. For every product i of a
sorted expansion that heads a (row, column) group, ``indices[seg_ids[i]] =
cols_s[i]``; slots no head reaches, ``[nnz, nnz_cap)``, are 0, and heads
whose id is not in ``[0, nnz_cap)`` are dropped. The kernel stores each C
entry once, with no atomics, where the scatter sent every product to its
group's slot and all the padding to one slot.

What bounds it on the H100: bytes, about 1 B a product of flags, 8 B a live
product of ids and columns, and 4 B a C entry stored, after the caller's
fill of ``nnz_cap`` words (see the source's header for the design).

Beside the kernel: ``plan_columns_plain``, today's scatter-max in plain
torch, which the wrapper runs for CPU tensors only (and which
``chip_smoke.py`` holds the kernel against on the card); ``LAUNCHES``, the
number of launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``plan_columns`` (reset by callers that count)
LAUNCHES = 0

INT32_MAX = 2**31 - 1  # the kernel keeps ids, fm and nnz_cap in int32

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _I64, _P, _I64, _P]


def check_plan_columns_args(heads, seg_ids, cols_s, nnz_cap: int) -> None:
    """Raise ``SpgemmInputError`` on anything the kernel does not take. The
    same checks run for CPU tensors, so the CPU path refuses what the card
    would."""
    tensors = {"heads": heads, "seg_ids": seg_ids, "cols_s": cols_s}
    dtypes = {"heads": torch.bool, "seg_ids": torch.int32, "cols_s": torch.int32}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise SpgemmInputError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != heads.device:
            raise SpgemmInputError(f"{name} is on {t.device} but heads on {heads.device}")
        if t.ndim != 1 or not t.is_contiguous():
            raise SpgemmInputError(f"{name} must be 1-D and contiguous")
        if t.dtype != dtypes[name]:
            raise SpgemmInputError(f"{name} must be {dtypes[name]}, got {t.dtype}")
    if heads.device.type not in ("cpu", "cuda"):
        raise SpgemmInputError(f"plan_columns runs on cpu or cuda, not {heads.device}")
    if not heads.shape[0] == seg_ids.shape[0] == cols_s.shape[0]:
        raise SpgemmInputError(
            f"sorted arrays differ in length: {heads.shape[0]}, {seg_ids.shape[0]}, "
            f"{cols_s.shape[0]}")
    if heads.shape[0] > INT32_MAX:
        raise SpgemmInputError(f"{heads.shape[0]} products exceed int32 ids")
    if not 0 <= nnz_cap <= INT32_MAX:
        raise SpgemmInputError(f"nnz_cap={nnz_cap} outside [0, 2^31)")


def plan_columns_plain(heads, seg_ids, cols_s, nnz_cap: int) -> torch.Tensor:
    """The kernel's function in plain torch, the reference's scatter-max:
    every product sends its column (heads) or 0 (the rest) to its slot, an
    ``amax`` into ``nnz_cap + 1`` zeroed slots (the last one takes every id
    past the end), sliced."""
    out = torch.zeros(nnz_cap + 1, dtype=torch.int32, device=heads.device)
    out.scatter_reduce_(0, seg_ids.clamp(max=nnz_cap).long(),
                        torch.where(heads, cols_s, 0), "amax", include_self=True)
    return out[:nnz_cap]


def plan_columns(heads, seg_ids, cols_s, nnz_cap: int) -> torch.Tensor:
    """C's (nnz_cap,) int32 column indices from a sorted expansion's
    ``heads``, ``seg_ids`` and ``cols_s``. CUDA tensors launch the kernel
    (or raise); CPU tensors run ``plan_columns_plain``. The two agree bit
    for bit."""
    global LAUNCHES
    check_plan_columns_args(heads, seg_ids, cols_s, nnz_cap)
    if heads.device.type == "cpu":
        return plan_columns_plain(heads, seg_ids, cols_s, nnz_cap)
    device = heads.device
    out = torch.zeros(nnz_cap, dtype=torch.int32, device=device)
    fm = heads.shape[0]
    if fm > 0 and nnz_cap > 0:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _build.launch("plan_columns", _ARGTYPES, heads.data_ptr(), seg_ids.data_ptr(),
                          cols_s.data_ptr(), fm, out.data_ptr(), nnz_cap, stream)
        LAUNCHES += 1
    return out

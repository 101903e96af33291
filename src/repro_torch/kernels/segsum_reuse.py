"""K1: the Reuse-case replay kernel in CUDA (``csrc/segsum_reuse.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/segsum_reuse.py``
(``segsum_reuse_arrays``). For every product t of a precomposed plan, in
sorted order: ``C[seg_ids[t]] += A[a_slot_s[t]] * B[b_slot_s[t]]``, with f32
products and f32 accumulation, cast to ``promote_types(a, b)``; ids outside
``[0, nnz_cap)``, the sentinel ``nnz_cap`` among them, are dropped. Like the
reference kernel it takes seg_ids sorted, as every plan has them: on the card,
unsorted seg_ids give wrong sums (the plain version does not care).

What bounds it on the H100: bytes — 12 B of plan per product, two value
reads at random slots, and ``4 * nnz_cap`` bytes written; two flops per
product. The design (see the source's header and ``csrc/replay_tile.cuh``):
tiles of 2,048 consecutive products, eight a thread loaded as int4 vectors,
summed by segment in registers and across the tile by a segmented scan;
each segment is stored once, the slots no product reaches are written 0,
and a small second kernel adds the partial sums of segments that span
tiles, so the output needs no fill first.

Beside the kernel: ``segsum_reuse_plain``, the same function in plain torch,
which the wrapper runs for CPU tensors only (and which ``chip_smoke.py``
holds the kernel against on the card); ``LAUNCHES``, the number of kernel
launches. This module also holds the argument checks and the ctypes launch
that ``kernels/spgemm_lp.py`` shares.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``segsum_reuse_arrays`` (reset by callers that count)
LAUNCHES = 0

# value dtype codes of csrc/replay_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int, _I64, _P, ctypes.c_int, _I64, _P,
             _I64, _I64, _P, _I64, _P]


def check_replay_args(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                      nnz_cap: int) -> None:
    """Raise ``SpgemmInputError`` on anything the replay kernels do not
    take. The same checks run for CPU tensors, so the CPU path refuses what
    the card would."""
    tensors = {"a_slot_s": a_slot_s, "b_slot_s": b_slot_s, "seg_ids": seg_ids,
               "a_values": a_values, "b_values": b_values}
    device = a_values.device
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise SpgemmInputError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != device:
            raise SpgemmInputError(
                f"{name} is on {t.device} but a_values on {device}")
        if t.ndim != 1 or not t.is_contiguous():
            raise SpgemmInputError(f"{name} must be 1-D and contiguous")
    if device.type not in ("cpu", "cuda"):
        raise SpgemmInputError(f"replay runs on cpu or cuda, not {device}")
    for name in ("a_slot_s", "b_slot_s", "seg_ids"):
        if tensors[name].dtype != torch.int32:
            raise SpgemmInputError(f"{name} must be int32, got {tensors[name].dtype}")
    if not a_slot_s.shape[0] == b_slot_s.shape[0] == seg_ids.shape[0]:
        raise SpgemmInputError(
            f"plan arrays differ in length: {a_slot_s.shape[0]}, "
            f"{b_slot_s.shape[0]}, {seg_ids.shape[0]}")
    for name in ("a_values", "b_values"):
        t = tensors[name]
        if t.dtype not in DTYPE_CODES:
            raise SpgemmInputError(
                f"{name} must be float32, float16 or bfloat16 (f32 "
                f"accumulation), got {t.dtype}")
        if t.shape[0] == 0:
            raise SpgemmInputError(f"{name} is empty")
    if not 0 <= nnz_cap < 2**31:
        raise SpgemmInputError(f"nnz_cap={nnz_cap} outside [0, 2^31)")


def replay_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                 nnz_cap: int) -> torch.Tensor:
    """The replay kernels' function in plain torch: f32 products,
    ``index_add_`` into ``nnz_cap + 1`` slots (the last one takes every
    dropped product), slice, cast to ``promote_types(a, b)``. Slots clamp
    into the value buffers as in the kernels."""
    live = (seg_ids >= 0) & (seg_ids < nnz_cap)
    seg = torch.where(live, seg_ids, nnz_cap)
    prod = (a_values.index_select(0, a_slot_s.clamp(0, a_values.shape[0] - 1)).float()
            * b_values.index_select(0, b_slot_s.clamp(0, b_values.shape[0] - 1)).float())
    out = torch.zeros(nnz_cap + 1, dtype=torch.float32, device=prod.device)
    out.index_add_(0, seg, prod)
    return out[:nnz_cap].to(torch.promote_types(a_values.dtype, b_values.dtype))


def workspace_bytes(lib_name: str, fm: int) -> int:
    """Bytes of scratch ``<lib_name>_launch`` needs for ``fm`` products (the
    tiles' carries and the bounds of the slots no product reaches)."""
    fn = getattr(_build.load(lib_name), f"{lib_name}_workspace_bytes")
    fn.argtypes, fn.restype = [_I64], _I64
    return fn(fm)


def tile_products(lib_name: str) -> int:
    """Products a tile of ``<lib_name>_launch`` (K1 2,048, K2 1,024)."""
    fn = getattr(_build.load(lib_name), f"{lib_name}_tile_products")
    fn.argtypes, fn.restype = [], _I64
    return fn()


def launch_replay(lib_name: str, a_slot_s, b_slot_s, seg_ids, a_values,
                  b_values, out: torch.Tensor) -> None:
    """Launch ``<lib_name>_launch`` of ``csrc/<lib_name>.cu`` on the current
    stream, writing every slot of the f32 ``out`` (which needs no zeroing).
    A CUDA error after the launch raises ``KernelFallbackError``: there is no
    rung to fall back to."""
    device = a_values.device
    fm = seg_ids.shape[0]
    with torch.cuda.device(device):
        work = torch.empty(workspace_bytes(lib_name, fm), dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.launch(lib_name, _ARGTYPES, a_slot_s.data_ptr(), b_slot_s.data_ptr(),
                      seg_ids.data_ptr(), a_values.data_ptr(), DTYPE_CODES[a_values.dtype],
                      a_values.shape[0], b_values.data_ptr(), DTYPE_CODES[b_values.dtype],
                      b_values.shape[0], out.data_ptr(), fm, out.shape[0],
                      work.data_ptr(), work.shape[0], stream)


def replay_out(seg_ids, nnz_cap: int, device) -> torch.Tensor:
    """The f32 output of a launch: unwritten (the kernel writes every slot),
    or zeros when there is no product and so no launch."""
    if seg_ids.shape[0] == 0:
        return torch.zeros(nnz_cap, dtype=torch.float32, device=device)
    return torch.empty(nnz_cap, dtype=torch.float32, device=device)


def segsum_reuse_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                       nnz_cap: int) -> torch.Tensor:
    """``segsum_reuse_arrays`` in plain torch (see ``replay_plain``)."""
    return replay_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap)


def segsum_reuse_arrays(a_slot_s, b_slot_s, seg_ids, a_values, b_values, *,
                        nnz_cap: int) -> torch.Tensor:
    """Kernel entry on raw plan arrays. Returns (nnz_cap,) C values.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``segsum_reuse_plain``. seg_ids must be sorted, as a plan's are: the
    kernel gives wrong sums for unsorted ones and does not check.
    """
    global LAUNCHES
    check_replay_args(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap)
    if a_values.device.type == "cpu":
        return segsum_reuse_plain(a_slot_s, b_slot_s, seg_ids, a_values,
                                  b_values, nnz_cap)
    out = replay_out(seg_ids, nnz_cap, a_values.device)
    if seg_ids.shape[0] > 0 and nnz_cap > 0:
        launch_replay("segsum_reuse", a_slot_s, b_slot_s, seg_ids, a_values,
                      b_values, out)
        LAUNCHES += 1
    return out.to(torch.promote_types(a_values.dtype, b_values.dtype))


def segsum_reuse(plan, a_values, b_values) -> torch.Tensor:
    """Replay a ``SpgemmPlan`` with the kernel. Same structure contract as
    ``core.spgemm.numeric_reuse``, but f32 accumulation: f64/int operands
    belong on the plain path. Select it through
    ``ReuseExecutor(..., backend="pallas")``."""
    return segsum_reuse_arrays(plan.a_slot_s, plan.b_slot_s, plan.seg_ids,
                               a_values, b_values,
                               nnz_cap=plan.indices.shape[0])

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

The batched launch, ``segsum_reuse_batched_arrays``, replays one plan over
a stack of value rows ``(batch, n)`` in one launch, either operand possibly
shared ``(n,)``: grid (tiles, batch), each row the single launch's tile code
(the same order of adds), each row reading the plan again.

Beside the kernel: ``segsum_reuse_plain`` and ``segsum_reuse_batched_plain``,
the same functions in plain torch, which the wrappers run for CPU tensors
only (and which ``chip_smoke.py`` holds the kernels against on the card);
``LAUNCHES`` and ``BATCHED_LAUNCHES``, the number of launches of each. This
module also holds the argument checks and the ctypes launches that
``kernels/spgemm_lp.py`` shares.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``segsum_reuse_arrays`` and ``segsum_reuse_batched_arrays``
# (reset by callers that count)
LAUNCHES = 0
BATCHED_LAUNCHES = 0

MAX_BATCH = 65_535  # rows of a batched launch (kMaxBatch: the grid's y)

# value dtype codes of csrc/replay_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int, _I64, _P, ctypes.c_int, _I64, _P,
             _I64, _I64, _P, _I64, _P]
_ARGTYPES_BATCHED = [_P, _P, _P, _P, ctypes.c_int, _I64, _I64, _P, ctypes.c_int, _I64,
                     _I64, _P, _I64, _I64, _I64, _P, _I64, _P]


def check_replay_args(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                      nnz_cap: int, batched: bool = False) -> None:
    """Raise ``SpgemmInputError`` on anything the replay kernels do not
    take. The same checks run for CPU tensors, so the CPU path refuses what
    the card would. ``batched``: the values may also be stacked rows
    ``(batch, n)`` with unit stride along a row (at least one operand
    stacked, both of one batch, at most ``MAX_BATCH`` rows)."""
    tensors = {"a_slot_s": a_slot_s, "b_slot_s": b_slot_s, "seg_ids": seg_ids,
               "a_values": a_values, "b_values": b_values}
    device = a_values.device
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise SpgemmInputError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != device:
            raise SpgemmInputError(
                f"{name} is on {t.device} but a_values on {device}")
        if batched and name.endswith("_values") and t.ndim == 2:
            if t.shape[1] > 1 and t.stride(1) != 1:
                raise SpgemmInputError(f"{name}'s rows must have unit stride")
        elif t.ndim != 1 or not t.is_contiguous():
            raise SpgemmInputError(f"{name} must be 1-D and contiguous")
    if batched:
        rows = {t.shape[0] for t in (a_values, b_values) if t.ndim == 2}
        if not rows:
            raise SpgemmInputError("a batched replay needs a stacked (batch, n) operand")
        if len(rows) > 1:
            raise SpgemmInputError(f"stacked operands differ in batch: {sorted(rows)}")
        if rows.pop() > MAX_BATCH:
            raise SpgemmInputError(f"batch above {MAX_BATCH} rows")
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
        if t.shape[-1] == 0:
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


def replay_batched_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                         nnz_cap: int, acc_dtype=torch.float32) -> torch.Tensor:
    """``replay_plain`` over stacked rows: either operand ``(batch, n)`` or
    shared ``(n,)``; products and sums in ``acc_dtype`` (the kernels' f32 by
    default), the (batch, nnz_cap) output cast to ``promote_types(a, b)``."""
    live = (seg_ids >= 0) & (seg_ids < nnz_cap)
    seg = torch.where(live, seg_ids, nnz_cap)
    prod = (a_values.index_select(-1, a_slot_s.clamp(0, a_values.shape[-1] - 1)).to(acc_dtype)
            * b_values.index_select(-1, b_slot_s.clamp(0, b_values.shape[-1] - 1)).to(acc_dtype))
    out = torch.zeros(prod.shape[0], nnz_cap + 1, dtype=acc_dtype, device=prod.device)
    out.index_add_(1, seg, prod)
    return out[:, :nnz_cap].to(torch.promote_types(a_values.dtype, b_values.dtype))


def workspace_bytes(lib_name: str, fm: int, batch: int | None = None) -> int:
    """Bytes of scratch ``<lib_name>_launch`` needs for ``fm`` products (the
    tiles' carries and the bounds of the slots no product reaches), or
    ``<lib_name>_launch_batched`` for ``batch`` rows."""
    lib = _build.load(lib_name)
    if batch is None:
        fn = getattr(lib, f"{lib_name}_workspace_bytes")
        fn.argtypes, fn.restype = [_I64], _I64
        return fn(fm)
    fn = getattr(lib, f"{lib_name}_workspace_bytes_batched")
    fn.argtypes, fn.restype = [_I64, _I64], _I64
    return fn(fm, batch)


def tile_products(lib_name: str) -> int:
    """Products a tile of ``<lib_name>_launch`` (K1 2,048, K2 1,024)."""
    fn = getattr(_build.load(lib_name), f"{lib_name}_tile_products")
    fn.argtypes, fn.restype = [], _I64
    return fn()


def launch_replay(lib_name: str, a_slot_s, b_slot_s, seg_ids, a_values,
                  b_values, out: torch.Tensor) -> None:
    """Launch ``<lib_name>_launch`` of ``csrc/<lib_name>.cu`` on the current
    stream, writing every slot of the f32 ``out`` (which needs no zeroing).
    A CUDA error after the launch raises ``_build.KernelLaunchError``, which
    the executor's degradation ladder turns into a step to the other replay
    kernel (or into ``KernelFallbackError`` under
    ``on_kernel_failure="raise"``)."""
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


def launch_replay_batched(lib_name: str, a_slot_s, b_slot_s, seg_ids, a_values,
                          b_values, out: torch.Tensor) -> None:
    """Launch ``<lib_name>_launch_batched`` over the rows of ``out`` (batch,
    nnz_cap), f32 and unwritten: row i replays a_values[i] (or the shared
    1-D a_values) with b_values[i] (likewise). Errors as ``launch_replay``."""
    device = a_values.device
    fm, batch = seg_ids.shape[0], out.shape[0]

    def stride(v):
        return v.stride(0) if v.ndim == 2 else 0

    with torch.cuda.device(device):
        work = torch.empty(workspace_bytes(lib_name, fm, batch), dtype=torch.uint8,
                           device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.launch(lib_name, _ARGTYPES_BATCHED, a_slot_s.data_ptr(), b_slot_s.data_ptr(),
                      seg_ids.data_ptr(), a_values.data_ptr(), DTYPE_CODES[a_values.dtype],
                      a_values.shape[-1], stride(a_values), b_values.data_ptr(),
                      DTYPE_CODES[b_values.dtype], b_values.shape[-1], stride(b_values),
                      out.data_ptr(), fm, out.shape[1], batch, work.data_ptr(),
                      work.shape[0], stream, entry="launch_batched")


def replay_out(seg_ids, nnz_cap: int, device, batch: int | None = None) -> torch.Tensor:
    """The f32 output of a launch, (nnz_cap,) or (batch, nnz_cap): unwritten
    (the kernel writes every slot), or zeros when there is no product and so
    no launch."""
    shape = (nnz_cap,) if batch is None else (batch, nnz_cap)
    if seg_ids.shape[0] == 0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.empty(shape, dtype=torch.float32, device=device)


def run_batched(lib_name: str, a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                nnz_cap: int) -> tuple[bool, torch.Tensor]:
    """The batched launch of ``lib_name`` on CUDA tensors (checked already):
    whether it launched (not where there is nothing to replay, and the
    output is zeros), and its output in ``promote_types(a, b)``."""
    batch = a_values.shape[0] if a_values.ndim == 2 else b_values.shape[0]
    out = replay_out(seg_ids, nnz_cap, a_values.device, batch)
    launched = seg_ids.shape[0] > 0 and nnz_cap > 0 and batch > 0
    if launched:
        launch_replay_batched(lib_name, a_slot_s, b_slot_s, seg_ids, a_values,
                              b_values, out)
    return launched, out.to(torch.promote_types(a_values.dtype, b_values.dtype))


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
    ``ReuseExecutor(..., backend="pallas")``; on the card a fresh multiply's
    numeric phase runs it too (``core.spgemm.fresh_values``)."""
    return segsum_reuse_arrays(plan.a_slot_s, plan.b_slot_s, plan.seg_ids,
                               a_values, b_values,
                               nnz_cap=plan.indices.shape[0])


def segsum_reuse_batched_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                               nnz_cap: int) -> torch.Tensor:
    """``segsum_reuse_batched_arrays`` in plain torch (``replay_batched_plain``)."""
    return replay_batched_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap)


def segsum_reuse_batched_arrays(a_slot_s, b_slot_s, seg_ids, a_values, b_values, *,
                                nnz_cap: int) -> torch.Tensor:
    """One launch over stacked values: (batch, nnz_cap) C values.

    Either operand is stacked ``(batch, n)`` (rows of unit stride) or shared
    ``(n,)``; at least one is stacked. Row i equals ``segsum_reuse_arrays``
    on row i's values, bit for bit. CUDA tensors launch the kernel (or
    raise); CPU tensors run ``segsum_reuse_batched_plain``.
    """
    global BATCHED_LAUNCHES
    check_replay_args(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap,
                      batched=True)
    if a_values.device.type == "cpu":
        return segsum_reuse_batched_plain(a_slot_s, b_slot_s, seg_ids, a_values,
                                          b_values, nnz_cap)
    launched, out = run_batched("segsum_reuse", a_slot_s, b_slot_s, seg_ids, a_values,
                                b_values, nnz_cap)
    BATCHED_LAUNCHES += launched
    return out


def segsum_reuse_batched(plan, a_values, b_values) -> torch.Tensor:
    """Replay a ``SpgemmPlan`` over stacked values with the batched kernel
    (``ReuseExecutor.apply_batched`` with ``backend="pallas"`` on the card)."""
    return segsum_reuse_batched_arrays(plan.a_slot_s, plan.b_slot_s, plan.seg_ids,
                                       a_values, b_values, nnz_cap=plan.indices.shape[0])

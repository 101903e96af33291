"""K6: the block-sparse (BSR) numeric phase in CUDA (``csrc/bsr_spgemm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/bsr_spgemm.py``
(``bsr_spgemm_numeric``): the block end of the paper's accumulator spectrum.
For block-structured operands (FEM or multigrid with a dense block per
node) the scalar accumulators collapse into dense (bs, bs) block products.

Two phases at block granularity, as in the reference:

- symbolic, ``plan_bsr_numeric``: for each C block, the (A block, B block)
  pairs that contribute to it. The reference walks the block graph in a host
  loop; here the block products are expanded in A-then-B order and
  stable-sorted by (block row, C column) on the operands' device, which
  gives the reference's arrays bit for bit. The plan serves every later
  change of the block values (the Reuse case).
- numeric, ``bsr_spgemm_numeric``: ``C[s] = sum_{t < contrib_n[s]}
  A[contrib_a[s, t]] @ B[contrib_b[s, t]]`` with f32 products and sums,
  out in ``a_blocks.dtype``.

What bounds the kernel on the H100: bytes, A's blocks, the plan and C each
moved once; 2 * bs^3 flops per contribution. The design (see the source's
header): a CTA takes a tile of ``TILE_BLOCKS[bs]`` consecutive C blocks,
lists each group's products from the tile's plan in shared memory and,
when it fits ``A_SPAN_BLOCKS[bs]`` blocks, stages the span of A blocks the
tile reads (``tile_a_spans``) there once; groups of bs threads stream
their B blocks through a cp.async ring and sum each C block's products in
registers (f32 FMAs), then write it once. No atomics, no output fill.

Beside the kernel: ``bsr_spgemm_plain``, the same function in plain torch
(the counterpart of the reference's oracle ``bsr_spgemm_ref``), which the
wrapper runs for CPU tensors only; ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segsum_reuse import DTYPE_CODES
from repro_torch.kernels.spgemm_symbolic import check_tensor
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``bsr_spgemm_numeric`` (reset by callers that count)
LAUNCHES = 0

BLOCK_SIZES = (8, 16)  # what the kernel takes (the reference's tests use both)
# C blocks a CTA takes, and the A blocks it can stage, by bs (kTile and
# kASpan in csrc/bsr_spgemm.cu)
TILE_BLOCKS = {8: 128, 16: 64}
A_SPAN_BLOCKS = {8: 64, 16: 36}

# C blocks per chunk of the plain version
_PLAIN_CHUNK_BLOCKS = 1 << 20

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = [_P, _INT, _I64, _P, _INT, _I64, _P, _P, _P, _I64, _I64, _P, _INT, _P]


def plan_bsr_numeric(a_indptr, a_indices, b_indptr, b_indices):
    """Symbolic phase on the block graph.

    Inputs: BSR structure tensors of A and B (integer, on one device).
    Returns int32 tensors ``(c_indptr, c_indices, contrib_a, contrib_b,
    contrib_n)`` on that device, where ``contrib_*`` have shape
    ``(nnzb_C, T_max)`` and list, per C block, the contributing A and B
    block slots in the order the reference appends them (A's slots
    ascending, then B's); padded slots hold 0. ``T_max`` is 1 when C is
    empty.
    """
    dev = a_indptr.device
    a_indptr, b_indptr = a_indptr.long(), b_indptr.long()
    mb = a_indptr.shape[0] - 1
    nnz_a = int(a_indptr[-1])
    a_cols = a_indices[:nnz_a].long()
    a_rows = torch.repeat_interleave(torch.arange(mb, device=dev), a_indptr.diff())
    b_first = b_indptr[a_cols]
    width = b_indptr[a_cols + 1] - b_first
    # every block product (e, f), e ascending, then f ascending
    e = torch.repeat_interleave(torch.arange(nnz_a, device=dev), width)
    start = torch.cumsum(width, 0) - width
    f = b_first[e] + torch.arange(e.shape[0], device=dev) - start[e]
    c_col = b_indices.long()[f]
    n_cols = int(c_col.max()) + 1 if c_col.numel() else 1
    key, order = torch.sort(a_rows[e] * n_cols + c_col, stable=True)
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    nnzb_c = uniq.shape[0]
    t_max = int(counts.max()) if nnzb_c else 1
    slot = torch.repeat_interleave(torch.arange(nnzb_c, device=dev), counts)
    t = torch.arange(key.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[slot]
    contrib_a = torch.zeros(nnzb_c, t_max, dtype=torch.int32, device=dev)
    contrib_b = torch.zeros(nnzb_c, t_max, dtype=torch.int32, device=dev)
    contrib_a[slot, t] = e[order].to(torch.int32)
    contrib_b[slot, t] = f[order].to(torch.int32)
    c_indptr = torch.zeros(mb + 1, dtype=torch.int32, device=dev)
    c_indptr[1:] = torch.cumsum(torch.bincount(uniq // n_cols, minlength=mb), 0)
    return (c_indptr, (uniq % n_cols).to(torch.int32), contrib_a, contrib_b,
            counts.to(torch.int32))


def check_bsr_args(a_blocks, b_blocks, contrib_a, contrib_b, contrib_n) -> None:
    """Raise ``SpgemmInputError`` on anything the kernel does not take. The
    same checks run for CPU tensors, so the CPU path refuses what the card
    would."""
    device = a_blocks.device if isinstance(a_blocks, torch.Tensor) else None
    check_tensor("a_blocks", a_blocks, device, 3, tuple(DTYPE_CODES))
    check_tensor("b_blocks", b_blocks, device, 3, tuple(DTYPE_CODES))
    for name, t, ndim in (("contrib_a", contrib_a, 2), ("contrib_b", contrib_b, 2),
                          ("contrib_n", contrib_n, 1)):
        check_tensor(name, t, device, ndim, (torch.int32,))
    bs = a_blocks.shape[1]
    if bs not in BLOCK_SIZES or a_blocks.shape[1:] != (bs, bs):
        raise SpgemmInputError(f"blocks must be (bs, bs) with bs in {BLOCK_SIZES}, "
                               f"got {tuple(a_blocks.shape[1:])}")
    if b_blocks.shape[1:] != a_blocks.shape[1:]:
        raise SpgemmInputError(f"A's blocks are {tuple(a_blocks.shape[1:])}, B's "
                               f"{tuple(b_blocks.shape[1:])}")
    if contrib_b.shape != contrib_a.shape or contrib_n.shape[0] != contrib_a.shape[0]:
        raise SpgemmInputError(
            f"plan arrays differ in shape: {tuple(contrib_a.shape)}, "
            f"{tuple(contrib_b.shape)}, {tuple(contrib_n.shape)}")
    if contrib_a.shape[0] and (contrib_a.shape[1] == 0 or not a_blocks.shape[0]
                               or not b_blocks.shape[0]):
        raise SpgemmInputError("a plan with C blocks needs T_max >= 1 and blocks of "
                               "A and B")


def tile_a_spans(contrib_a, contrib_n, bs: int, nnzb_a: int) -> torch.Tensor:
    """The span (max - min + 1 of the clamped live A slots; 0 where none is
    live) of each tile of ``TILE_BLOCKS[bs]`` consecutive C blocks: the
    kernel stages a tile's A blocks when its span is at most
    ``A_SPAN_BLOCKS[bs]``, and reads them from device memory otherwise."""
    nnzb_c, t_max = contrib_a.shape
    tile = TILE_BLOCKS[bs]
    pad = -nnzb_c % tile
    n = torch.nn.functional.pad(contrib_n.clamp(0, t_max), (0, pad))
    slots = torch.nn.functional.pad(contrib_a.long().clamp(0, nnzb_a - 1), (0, 0, 0, pad))
    live = torch.arange(t_max, device=slots.device)[None, :] < n[:, None]
    big = torch.iinfo(torch.int64).max
    lo = torch.where(live, slots, big).view(-1, tile * t_max).amin(1)
    hi = torch.where(live, slots, -1).view(-1, tile * t_max).amax(1)
    return torch.where(hi >= 0, hi - lo + 1, 0)


def bsr_spgemm_plain(a_blocks, b_blocks, contrib_a, contrib_b, contrib_n) -> torch.Tensor:
    """``bsr_spgemm_numeric`` in plain torch: per chunk of C blocks and per
    contribution slot t, a batched f32 product of the gathered A and B
    blocks, added only where ``t < contrib_n``; out in ``a_blocks.dtype``.
    Block ids clamp into the block arrays."""
    nnzb_c, t_max = contrib_a.shape
    bs = a_blocks.shape[1]
    out = torch.zeros(nnzb_c, bs, bs, dtype=torch.float32, device=a_blocks.device)
    n = contrib_n.clamp(0, t_max)
    for lo in range(0, nnzb_c, _PLAIN_CHUNK_BLOCKS):
        hi = min(lo + _PLAIN_CHUNK_BLOCKS, nnzb_c)
        for t in range(t_max):
            live = torch.nonzero(n[lo:hi] > t).flatten() + lo
            if not live.numel():
                break
            ia = contrib_a[live, t].long().clamp(0, a_blocks.shape[0] - 1)
            ib = contrib_b[live, t].long().clamp(0, b_blocks.shape[0] - 1)
            out[live] += torch.bmm(a_blocks[ia].float(), b_blocks[ib].float())
    return out.to(a_blocks.dtype)


def bsr_spgemm_numeric(a_blocks, b_blocks, contrib_a, contrib_b, contrib_n) -> torch.Tensor:
    """Numeric phase. a_blocks: (nnzb_A, bs, bs); b_blocks: (nnzb_B, bs, bs),
    bs 8 or 16, f32, f16 or bf16 (f32 accumulation); plan arrays from
    ``plan_bsr_numeric``. Returns (nnzb_C, bs, bs) in ``a_blocks.dtype``.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``bsr_spgemm_plain``."""
    global LAUNCHES
    check_bsr_args(a_blocks, b_blocks, contrib_a, contrib_b, contrib_n)
    if a_blocks.device.type == "cpu":
        return bsr_spgemm_plain(a_blocks, b_blocks, contrib_a, contrib_b, contrib_n)
    nnzb_c, t_max = contrib_a.shape
    bs = a_blocks.shape[1]
    # the kernel reads every array in 16-byte pieces: a view that starts
    # elsewhere is copied
    a_blocks, b_blocks, contrib_a, contrib_b, contrib_n = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (a_blocks, b_blocks, contrib_a, contrib_b, contrib_n))
    out = torch.empty(nnzb_c, bs, bs, dtype=a_blocks.dtype, device=a_blocks.device)
    if nnzb_c:
        with torch.cuda.device(a_blocks.device):
            stream = torch.cuda.current_stream(a_blocks.device).cuda_stream
            _build.launch("bsr_spgemm", _ARGTYPES, a_blocks.data_ptr(),
                          DTYPE_CODES[a_blocks.dtype], a_blocks.shape[0],
                          b_blocks.data_ptr(), DTYPE_CODES[b_blocks.dtype],
                          b_blocks.shape[0], contrib_a.data_ptr(), contrib_b.data_ptr(),
                          contrib_n.data_ptr(), nnzb_c, t_max, out.data_ptr(), bs, stream)
        LAUNCHES += 1
    return out

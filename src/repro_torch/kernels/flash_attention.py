"""K8: blocked flash attention with GQA, sliding window and logit softcap, in
CUDA (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``). q: (Hq, Tq, D), k and v: (Hkv, Tk, D); query head h
reads KV head ``h // (Hq // Hkv)``. Scores are f32: ``q . k / sqrt(D)``,
then ``tanh(s / softcap) * softcap`` where ``softcap`` is set, then the
causal and window masks with the finite ``-1e30``; online softmax; out in
``q.dtype``. A row with no live key (``window=0``, say) gives the mean of
V, in the reference's kernel and oracle alike, and here too.

What bounds it on the H100: operations, 4 * D flops per live (query, key)
pair of each head, at 989 TFLOP/s on the tensor cores in bf16/f16; in f32
three TF32 products of that work at 495 TFLOP/s (``"tf32"``), or one pass
at 67 TFLOP/s of f32 FMAs (``"fma"``). The C launcher picks the variant by
dtype and head dim (``variant``); a failed build or launch raises, nothing
falls back:

- ``"wgmma"`` (bf16, f16 at D 64, 128, 256): an FA3-style forward; one block
  of two warpgroups per (128-row query tile, head); TMA copies Q and
  64-key K/V stages into 128-byte-swizzled shared memory, counted on
  mbarriers; per stage O += P V (P from registers) then S = Q K^T, both
  ``wgmma`` with f32 accumulators, then the softmax in registers.
- ``"mma"`` (bf16, f16 at D 16, 32): an FA2-style forward with
  ``mma.sync.m16n8k16``; 8 warps of 16 query rows, K/V tiles double-buffered
  with ``cp.async``.
- ``"tf32"`` (f32 at D 64, 128, 256): the f32 contract on Hopper's tensor
  cores in split TF32: each f32 operand is a TF32 big part plus a TF32
  small part, and each product three TF32 products (small terms first) for
  S = Q K^T and P V alike, with ``wgmma`` from registers (Q, P) and K-major
  big/small panels in shared memory (K, and V^T). A pre-pass kernel of the
  same launch splits K and V (transposed) once into device scratch, which
  the wrapper allocates (``scratch_bytes``); TMA copies each key stage's
  panels from there. No accumulator sums for long, as the tensor cores'
  adds truncate: S a 32-column panel of D at a time, P V each key stage,
  each part added in f32. Two warpgroups a block: at D 64 and 128 each
  takes 64 query rows of its own; at D 256 both take the same 64 rows and
  split D for S (the partial scores added through shared memory) and O's
  columns.
- ``"fma"`` (f32 at D 16, 32): f32 FMAs over f32 shared-memory tiles, no
  tensor cores.

In the bf16/f16 variants S, the softmax and O stay in registers and P is
rounded to the input dtype in registers before O += P V; the reference
keeps P in f32, and its 5e-2 tolerance covers that rounding. In "tf32" P
stays f32 (split like every operand), and the f32 outputs are held to
2e-3 and a relative Frobenius error of 1e-5. The softcap's tanh is
1 - 2 / (2^y + 1) from ``ex2.approx`` and ``rcp.approx`` in every
tensor-core variant, within about 1e-7 of an exact tanh.

Beside the kernel: ``flash_attention_plain``, the reference's
``ref.flash_attention_ref`` (with ``segment_pos``) in plain torch, one KV
head's group of query heads at a time, which the wrapper runs for CPU
tensors only; ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segsum_reuse import DTYPE_CODES
from repro_torch.kernels.spgemm_symbolic import check_tensor
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``flash_attention`` (reset by callers that count)
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)  # what the kernel takes
NEG_INF = -1e30  # the masked score, the reference's

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _INT, _I64, _I64, _I64, _I64, _INT, _F32, _INT, _INT, _I64,
             _F32, _P]


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel variant that a CUDA launch runs for (dtype, head_dim), as
    the C launcher chooses it: "wgmma" (bf16/f16, D >= 64), "mma" (bf16/f16,
    D 16 and 32), "tf32" (f32, D >= 64), "fma" (f32, D 16 and 32), or "none"
    where it refuses. Reads the built library."""
    fn = _build.load("flash_attention").flash_attention_variant
    fn.argtypes, fn.restype = [_INT, _INT], ctypes.c_char_p
    return fn(DTYPE_CODES[dtype], head_dim).decode()


def scratch_bytes(lib, dtype: torch.dtype, hkv: int, tk: int, head_dim: int) -> int:
    """The device scratch that ``lib``'s launch needs for these shapes (the
    "tf32" pre-pass's split K and V^T; 0 for the other variants)."""
    fn = lib.flash_attention_scratch_bytes
    fn.argtypes, fn.restype = [_INT, _I64, _I64, _INT], ctypes.c_int64
    return fn(DTYPE_CODES[dtype], hkv, tk, head_dim)


def check_attention_args(q, k, v, block_q: int, block_k: int) -> None:
    """Raise ``SpgemmInputError`` on anything the kernel does not take: the
    reference's asserts (Hq % Hkv == 0, Tq % block_q == 0, Tk % block_k == 0)
    as typed errors, one dtype for q, k and v, devices and contiguity. The
    same checks run for CPU tensors."""
    device = q.device if isinstance(q, torch.Tensor) else None
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, device, 3, tuple(DTYPE_CODES))
    hq, tq, d = q.shape
    hkv, tk, dk = k.shape
    if v.shape != k.shape or dk != d:
        raise SpgemmInputError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                               f"{tuple(v.shape)} disagree on D or on k/v shape")
    if not k.dtype == v.dtype == q.dtype:
        raise SpgemmInputError(f"q, k and v must share a dtype: {q.dtype}, {k.dtype}, "
                               f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise SpgemmInputError(f"head_dim {d} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise SpgemmInputError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if tk == 0 or block_q < 1 or block_k < 1 or tq % block_q or tk % block_k:
        raise SpgemmInputError(f"Tq={tq}, Tk={tk} must be positive multiples of "
                               f"block_q={block_q}, block_k={block_k}")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int | None = None,
                          softcap: float | None = None, segment_pos=None) -> torch.Tensor:
    """``ref.flash_attention_ref`` in plain torch: f32 scores divided by
    sqrt(D), softcap, masks with -1e30, softmax, @ V; out in ``q.dtype``.
    segment_pos: (Tq,) absolute positions of the queries (default arange).
    One KV head's group of query heads at a time, so the f32 scores of a
    group, not of every head, are held at once."""
    hq, tq, d = q.shape
    hkv, tk, _ = k.shape
    group = hq // hkv
    dev = q.device
    qpos = (torch.arange(tq, device=dev) if segment_pos is None
            else segment_pos.to(device=dev, dtype=torch.int64))
    kpos = torch.arange(tk, device=dev)
    mask = torch.ones(tq, tk, dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    out = torch.empty(hq, tq, d, dtype=q.dtype, device=dev)
    for g in range(hkv):
        qg = q[g * group:(g + 1) * group].float()
        scores = torch.matmul(qg, k[g].float().T) / math.sqrt(d)
        if softcap is not None:
            scores = torch.tanh(scores / softcap) * softcap
        scores = torch.where(mask[None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out[g * group:(g + 1) * group] = torch.matmul(p, v[g].float()).to(q.dtype)
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (Hq, Tq, D); k, v: (Hkv, Tk, D), one dtype (f32, f16 or bf16);
    returns (Hq, Tq, D) in q's dtype.

    block_q, block_k: the reference's tiling, kept for its shape contract
    (Tq and Tk must be multiples of them); the values do not depend on them.
    The CUDA kernel tiles by its own sizes: 128 query rows and 64 keys a
    stage in bf16/f16 (tensor cores, P rounded to q's dtype before P @ V);
    in f32 on "tf32" (split TF32 on tensor cores) 128 rows with 64 keys at D
    64 and 128, 64 rows with 32 keys at D 256, and on "fma" 64 and 64;
    ``variant`` names the kernel for a dtype and head dim. "tf32" also takes
    ``scratch_bytes`` of device scratch (K and V split once a call). CUDA tensors launch the
    kernel (or raise); CPU tensors run ``flash_attention_plain``. An operand
    that is not 16-byte aligned (an odd storage offset) is copied first: the
    tensor-core kernels read 16 bytes at a time.
    """
    global LAUNCHES
    check_attention_args(q, k, v, block_q, block_k)
    if softcap is not None and not softcap:
        raise SpgemmInputError("softcap=0 divides the scores by 0; pass None for no cap")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    hq, tq, d = q.shape
    hkv, tk, _ = k.shape
    out = torch.empty_like(q)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    if hq and tq:
        nbytes = scratch_bytes(_build.load("flash_attention"), q.dtype, hkv, tk, d)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _build.launch("flash_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          DTYPE_CODES[q.dtype], hq, hkv, tq,
                          tk, d, 1.0 / math.sqrt(d), int(causal), int(window is not None),
                          0 if window is None else int(window),
                          0.0 if softcap is None else float(softcap), stream)
        LAUNCHES += 1
    return out

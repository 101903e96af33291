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
pair of each head, at 989 TFLOP/s on the tensor cores in bf16/f16 and 67
TFLOP/s in f32. The C launcher picks the variant by dtype and head dim
(``variant``); a failed build or launch raises, nothing falls back:

- ``"wgmma"`` (bf16, f16 at D 64, 128, 256): an FA3-style forward; one block
  of two warpgroups per (128-row query tile, head); TMA copies Q and
  64-key K/V stages into 128-byte-swizzled shared memory, counted on
  mbarriers; per stage O += P V (P from registers) then S = Q K^T, both
  ``wgmma`` with f32 accumulators, then the softmax in registers.
- ``"mma"`` (bf16, f16 at D 16, 32): an FA2-style forward with
  ``mma.sync.m16n8k16``; 8 warps of 16 query rows, K/V tiles double-buffered
  with ``cp.async``.
- ``"fma"`` (f32, every D): f32 FMAs over f32 shared-memory tiles, no
  tensor cores (the port's f32 contract is full-f32 products).

In both tensor-core variants S, the softmax and O stay in registers and P
is rounded to the input dtype in registers before O += P V; the reference
keeps P in f32, and its 5e-2 tolerance covers that rounding. The softcap's
tanh is 1 - 2 / (2^y + 1) from ``ex2.approx`` and ``rcp.approx``, within
about 1e-7 of an exact tanh.

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
_ARGTYPES = [_P, _P, _P, _P, _INT, _I64, _I64, _I64, _I64, _INT, _F32, _INT, _INT, _I64,
             _F32, _P]


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel variant that a CUDA launch runs for (dtype, head_dim), as
    the C launcher chooses it: "wgmma" (bf16/f16, D >= 64), "mma" (bf16/f16,
    D 16 and 32), "fma" (f32), or "none" where it refuses. Reads the built
    library."""
    fn = _build.load("flash_attention").flash_attention_variant
    fn.argtypes, fn.restype = [_INT, _INT], ctypes.c_char_p
    return fn(DTYPE_CODES[dtype], head_dim).decode()


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
    The CUDA kernel tiles by its own sizes: 128 query rows and 64 keys in
    bf16/f16 (tensor cores, P rounded to q's dtype before P @ V), 64 and 64
    in f32; ``variant`` names the kernel for a dtype and head dim. CUDA
    tensors launch the kernel (or raise); CPU tensors run
    ``flash_attention_plain``. An operand that is not 16-byte aligned (an
    odd storage offset) is copied first: the bf16/f16 kernel reads 16 bytes
    at a time.
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
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _build.launch("flash_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], hq, hkv, tq,
                          tk, d, 1.0 / math.sqrt(d), int(causal), int(window is not None),
                          0 if window is None else int(window),
                          0.0 if softcap is None else float(softcap), stream)
        LAUNCHES += 1
    return out

"""K7: the expert-grouped matmul (the MoE numeric phase) in CUDA
(``csrc/grouped_matmul.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/grouped_matmul.py``
(``grouped_matmul``). MoE dispatch is a top-k-sparse token-to-expert
matrix: routing is the symbolic phase (counts only), this is the numeric
phase. Tokens arrive sorted by expert and padded so that no block of
``TM = 128`` rows spans two experts: ``y[t] = x[t] @ w[block_expert[t //
128]]`` with f32 products and sums, out in ``x.dtype``.

What bounds it on the H100: at the MoE widths in bf16 the bytes (x, the
experts' weights and y, each once), just above the 2 * T * d * f flops on
tensor cores; in f32 the three TF32 products of the split below. The C
launcher picks the variant by the dtype pair (``variant``); a failed build
or launch raises, nothing falls back. "wgmma" for x and w both bf16 or both
f16 (a product of two such values is exact in f32, so tensor cores with f32
accumulators keep the contract): one block per (token block, 128-column
tile of f), a producer warp feeding a ring of TMA stages, two consumer
warpgroups on ``wgmma`` (see the source's header). "tf32" for every other
pair: ``mma.sync`` on tensor cores in split TF32, each f32 operand v as
big = tf32(v) and small = tf32(v - big), y = xs * wb + xb * ws + xb * wb in
f32; a bf16 or f16 operand is exact in TF32 and has no small part, so a pair
takes ``products`` of 3 (f32 x f32), 2 (f32 with a 16-bit type) or 1 (bf16
x f16).

Beside the kernel: ``grouped_matmul_plain``, the reference's
``ref.grouped_matmul_ref`` in plain torch, one f32 product per expert (the
literal ``w[group_ids]`` would hold T * d * f values), which the wrapper
runs for CPU tensors only; ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segsum_reuse import DTYPE_CODES
from repro_torch.kernels.spgemm_symbolic import check_tensor
from repro_torch.runtime.validate import SpgemmInputError

# kernel launches by ``grouped_matmul`` (reset by callers that count)
LAUNCHES = 0

TM = 128  # token-block rows, the reference's
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = [_P, _INT, _P, _INT, _P, _P, _I64, _I64, _I64, _I64, _P]


def variant(x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The kernel variant that a CUDA launch runs for (x's dtype, w's), as
    ``variant_of`` in the C launcher chooses it: "wgmma" where both are bf16
    or both f16, "tf32" for every other pair the kernel takes, "none" where
    it refuses a dtype (the card tests hold the library's
    ``grouped_matmul_variant`` to this)."""
    if x_dtype not in DTYPE_CODES or w_dtype not in DTYPE_CODES:
        return "none"
    return "wgmma" if x_dtype == w_dtype and x_dtype in TENSOR_CORE_DTYPES else "tf32"


def products(x_dtype: torch.dtype, w_dtype: torch.dtype) -> int:
    """Tensor-core products that ``variant`` takes for each product of the
    contract, as the library's ``grouped_matmul_products`` counts them: 1 on
    "wgmma"; on "tf32" 1 and one more for each f32 operand (its small
    part); 0 where the kernel refuses a dtype."""
    name = variant(x_dtype, w_dtype)
    if name == "none":
        return 0
    return 1 if name == "wgmma" else 1 + (x_dtype == torch.float32) + (w_dtype == torch.float32)


def check_grouped_args(x, w, block_expert) -> None:
    """Raise ``SpgemmInputError`` on anything the kernel does not take: the
    reference's shape asserts (T % 128, d % 128, f % 128, d == w's d) as
    typed errors, and dtypes, devices and contiguity. The same checks run for
    CPU tensors."""
    device = x.device if isinstance(x, torch.Tensor) else None
    check_tensor("x", x, device, 2, tuple(DTYPE_CODES))
    check_tensor("w", w, device, 3, tuple(DTYPE_CODES))
    check_tensor("block_expert", block_expert, device, 1, (torch.int32,))
    t, d = x.shape
    e, dw, f = w.shape
    if d != dw or t % TM or d % 128 or f % 128:
        raise SpgemmInputError(
            f"grouped_matmul needs x (T, d), w (E, d, f) with T % {TM} == 0 and "
            f"d % 128 == f % 128 == 0; got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if block_expert.shape[0] != t // TM:
        raise SpgemmInputError(
            f"block_expert has {block_expert.shape[0]} entries for {t // TM} token blocks")
    if e == 0:
        raise SpgemmInputError("w has no experts")


def grouped_matmul_plain(x, w, block_expert) -> torch.Tensor:
    """``grouped_matmul`` in plain torch: for each expert that owns blocks,
    one f32 product of its rows; out in ``x.dtype``. Expert ids clamp into
    [0, E)."""
    t, d = x.shape
    e, _, f = w.shape
    out = torch.zeros(t // TM, TM, f, dtype=x.dtype, device=x.device)
    xb = x.view(t // TM, TM, d)
    be = block_expert.long().clamp(0, e - 1)
    for ex in torch.unique(be).tolist():
        blocks = torch.nonzero(be == ex).flatten()
        y = xb[blocks].reshape(-1, d).float() @ w[ex].float()
        out[blocks] = y.view(-1, TM, f).to(x.dtype)
    return out.view(t, f)


def grouped_matmul(x, w, block_expert) -> torch.Tensor:
    """y[t] = x[t] @ w[expert(t)] for expert-sorted, block-aligned tokens.

    x: (T, d) with T % 128 == 0; w: (E, d, f); block_expert: (T // 128,)
    int32. Values f32, f16 or bf16 (f32 products and sums); out (T, f) in
    ``x.dtype``; ``variant`` names the kernel for a dtype pair. CUDA tensors
    launch the kernel (or raise); CPU tensors run ``grouped_matmul_plain``.
    """
    global LAUNCHES
    check_grouped_args(x, w, block_expert)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, block_expert)
    for name, ten in (("x", x), ("w", w)):
        if ten.data_ptr() % 16:
            raise SpgemmInputError(f"{name} must start on a 16-byte boundary (16-byte loads)")
    t, d = x.shape
    e, _, f = w.shape
    out = torch.empty(t, f, dtype=x.dtype, device=x.device)
    if t and f:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _build.launch("grouped_matmul", _ARGTYPES, x.data_ptr(), DTYPE_CODES[x.dtype],
                          w.data_ptr(), DTYPE_CODES[w.dtype], block_expert.data_ptr(),
                          out.data_ptr(), t, d, f, e, stream)
        LAUNCHES += 1
    return out

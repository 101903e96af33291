"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

The port keeps the reference's backend and kernel strings so that callers of
both packages pass the same names. ``BACKEND_NAMES`` (replay backends) and
``NUMERIC_KERNEL_NAMES`` (the numeric kernels of ``ops.numeric_values``) are
the tables of what each name runs here.

Kernels (``csrc/``, built by ``_build``):
  segsum_reuse    — K1, replay of a pinned plan: tiles of consecutive products,
                    a segmented scan, each segment stored once; its batched
                    launch replays a stack of value rows, a row of tiles each
  lp_reuse        — K2, the same replay through a shared-memory LP hash table
                    (and its batched launch likewise)
  spgemm_symbolic — K5, C's row sizes: OR of B's bitmask rows + popcount
  spgemm_numeric  — K4, numeric phase through a dense row in shared memory
  spgemm_lp       — K3, numeric phase through the two-level LP hash tables
  bsr_spgemm      — K6, block-sparse (BSR) numeric phase: a CTA per tile of
                    consecutive C blocks stages the tile's plan and A span in
                    shared memory once, streams B blocks through a cp.async
                    ring and sums each C block in registers (f32 FMAs)
                    (``plan_bsr_numeric`` is its symbolic phase, on the device)
  grouped_matmul  — K7, MoE expert-grouped matmul: a tiled f32 GEMM per
                    128-token block, the weight tile chosen by block_expert
  flash_attention — K8, attention forward with GQA, sliding window and logit
                    softcap (replaces the TPU kernel
                    repro/kernels/flash_attention.py; bound by operations at
                    989 TFLOP/s in bf16/f16): "wgmma" for bf16/f16 at D 64-256
                    (TMA-fed K/V stages, wgmma, FA3-style), "mma" for bf16/f16
                    at D 16 and 32 (mma.sync, cp.async, FA2-style), both with
                    S and O in registers and P rounded to the input dtype
                    before P @ V; "fma" for f32 (f32 FMAs, no tensor cores)

``ops.py`` holds the kernel-backed two-phase path (``pallas_spgemm``,
``symbolic_rowsizes``, ``numeric_values``) and the reference's
``attention`` (K8) and ``expert_matmul`` (K7) wrappers.
"""
from repro_torch.kernels.bsr_spgemm import bsr_spgemm_numeric, plan_bsr_numeric
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul

__all__ = ["BACKEND_NAMES", "NUMERIC_KERNEL_NAMES", "bsr_spgemm_numeric",
           "flash_attention", "grouped_matmul", "plan_bsr_numeric"]

# backend string (the reference's) -> what it runs in the port
BACKEND_NAMES = {
    "xla": "plain torch core.spgemm.numeric_reuse (batched: executor._replay_batched)",
    "pallas": "CUDA kernel segsum_reuse (kernels/csrc/segsum_reuse.cu), single and batched",
    "pallas_lp": "CUDA kernel lp_reuse (kernels/csrc/lp_reuse.cu), single and batched",
}

# numeric_values kernel name (the reference's) -> what it runs in the port
NUMERIC_KERNEL_NAMES = {
    "dense_acc": "CUDA kernel spgemm_numeric (kernels/csrc/spgemm_numeric.cu)",
    "flat_lp": "CUDA kernel spgemm_lp (kernels/csrc/spgemm_lp.cu)",
    "xla": "plain torch kernels.spgemm_numeric.spgemm_numeric_ref",
}

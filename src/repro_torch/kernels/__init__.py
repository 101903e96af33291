"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

The port keeps the reference's backend strings so that callers of both
packages pass the same names. ``BACKEND_NAMES`` is the one table of what
each name runs here.

Kernels (``csrc/``, built by ``_build``):
  segsum_reuse — K1, replay of a pinned plan: segmented warp scan + atomics
  lp_reuse     — K2, the same replay through a shared-memory LP hash table
"""

# backend string (the reference's) -> what it runs in the port
BACKEND_NAMES = {
    "xla": "plain torch core.spgemm.numeric_reuse",
    "pallas": "CUDA kernel segsum_reuse (kernels/csrc/segsum_reuse.cu)",
    "pallas_lp": "CUDA kernel lp_reuse (kernels/csrc/lp_reuse.cu)",
}

"""PyTorch + CUDA port of the two-phase SpGEMM system in ``repro``.

The package mirrors ``repro`` path for path (``repro_torch/core/spgemm.py``
ports ``repro/core/spgemm.py``, and so on):

  sparse   — CSR, ELL and BSR over torch tensors, the numpy-seeded
             generators and the numpy oracles;
  core     — the single-expansion plan pipeline, the structure-keyed plan
             cache, the pinned ``ReuseExecutor``, the meta-algorithm's
             choosers and the autotuner (static < fitted < measured);
  kernels  — the eight hand-written CUDA kernels for Hopper (``csrc``),
             built with ``nvcc`` at first use, each beside its plain torch
             version, and the kernel-backed two-phase path (``ops``) with
             its degradation ladder;
  runtime  — the typed failure taxonomy, operand and plan validation, fault
             injection, retry and the watchdog;
  obs      — phase spans with Chrome export, latency histograms and the
             flight recorder;
  serve    — the SpGEMM serving tier: bounded admission, deadlines, grouped
             dispatch over pinned plans, the circuit breaker, plan-cache
             warming;
  configs  — the model configurations whose widths the attention and MoE
             kernels run at; ``convert`` carries the reference's arrays
             across.

It imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of
``repro``. Entry points run where their tensors live; the generators and
converters default to ``device="cuda"``. A kernel failure on the card steps
down the degradation ladder to another kernel on the same device, never to
the plain version or the CPU; a kernel that cannot be built raises.
"""

__all__ = ["configs", "convert", "core", "kernels", "obs", "runtime", "serve", "sparse"]

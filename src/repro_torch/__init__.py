"""PyTorch + CUDA port of the two-phase SpGEMM system in ``repro``.

The package mirrors ``repro`` path for path (``repro_torch/core/spgemm.py``
ports ``repro/core/spgemm.py``, and so on) and covers the sparse main path:
CSR formats and generators, the single-expansion plan pipeline behind the
structure-keyed plan cache, and the pinned ``ReuseExecutor`` replay. The two
Pallas replay kernels of that path are hand-written CUDA kernels for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.

It imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of
``repro``. Entry points run where their tensors live; the generators and
converters default to ``device="cuda"``. There is no CPU fallback for a CUDA
tensor: a kernel launches or raises.
"""

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
  models   — the LM substrate's model zoo in plain torch (dense, local /
             global, MoE, RG-LRU and SSD stacks): templates, init, forward
             and decode, as the reference's models call no kernel;
  train    — AdamW (f32 moments, in-place updates), the cross-entropy loss
             and the remat'd training step with microbatches;
  data     — Philox-keyed synthetic and memory-mapped token streams;
  ckpt     — atomic checkpoints in the reference's on-disk layout;
  launch   — the training launcher (``python -m repro_torch.launch.train``),
             the data x model meshes, and the dry run (``python -m
             repro_torch.launch.dryrun``: per-rank op counts of every cell
             on meta tensors under a fake process group, H100 rooflines);
  serve    — the SpGEMM serving tier: bounded admission, deadlines, grouped
             dispatch over pinned plans, the circuit breaker, plan-cache
             warming; and ``ServeEngine``, prefill then decode of the model
             zoo;
  dist     — the sharded two-phase SpGEMM: stacked per-shard plans pinned
             once and replayed a shard at a time (K1 on the card), the
             mesh-aware plan cache, compressed collectives, pipeline
             parallelism;
  compat   — the mesh those run on: every shard on one device, or shards
             split over a ``torch.distributed`` process group;
  configs  — the model configurations whose widths the attention and MoE
             kernels run at; ``convert`` carries the reference's arrays
             across.

It imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of
``repro``. Entry points run where their tensors live; the generators and
converters default to ``device="cuda"``. A kernel failure on the card steps
down the degradation ladder to another kernel on the same device, never to
the plain version or the CPU; a kernel that cannot be built raises.
"""

__all__ = ["ckpt", "compat", "configs", "convert", "core", "data", "dist", "kernels", "launch",
           "models", "obs", "runtime", "serve", "sparse", "train"]

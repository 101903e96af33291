"""Thread-scalable memory pool, paper §3.1.2 (port of ``repro/core/memory_pool.py``).

The paper's pool serves the L2-accumulator allocations of thousands of
threads: NUMCHUNKS chunks of CHUNKSIZE = MAXRF entries, with ONE2ONE
(CPU/KNL: chunk i belongs to thread i, NUMA-local reuse) and MANY2MANY (GPU:
scan from the thread index for a free chunk, spin on exhaustion).

The sizing logic is the paper's and the reference's: CHUNKSIZE from the
(compressed) MAXRF bound, NUMCHUNKS from the concurrency, shrunk to fit a
byte budget. Acquisition maps a unit of work (a row block) to a chunk:

* ONE2ONE   — chunk id == work id: ownership is exclusive by construction;
* MANY2MANY — chunk id == work id mod NUMCHUNKS.

The reference may take MANY2MANY without locks because Mosaic runs a TPU
grid's steps one after another on a core: a chunk is released (its row
finished) before the next step that maps to it begins. A GPU gives no such
order: the blocks of a grid run concurrently, and any of them may be
resident at once. On the card MANY2MANY is therefore valid only with a real
lock (the paper's scan over a lock bitmap, with atomics), or with one chunk
per block that can be resident at once (NUMCHUNKS at least the grid's
resident blocks, and the chunk taken from a resident-slot id, not the block
index). The port's CUDA kernels allocate no chunks: their accumulators are
shared memory or fixed slices of device memory per size class.

``acquire_release_sim`` keeps the reference's lock-bitmap simulation of the
MANY2MANY scan for the data-structure tests, as a plain sequential loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    num_chunks: int
    chunk_size: int  # entries per chunk == MAXRF bound
    mode: str  # "one2one" | "many2many"

    @property
    def total_entries(self) -> int:
        return self.num_chunks * self.chunk_size


def size_pool(maxrf: int, concurrency: int, mode: str = "one2one",
              bytes_budget: int | None = None, entry_bytes: int = 8) -> PoolConfig:
    """Size the pool as §3.1.2: CHUNKSIZE = MAXRF (any row fits), NUMCHUNKS =
    concurrency, shrunk while the allocation would exceed the budget (the
    paper's GPU fallback)."""
    chunk = max(int(maxrf), 1)
    chunks = max(int(concurrency), 1)
    if bytes_budget is not None:
        max_chunks = max(bytes_budget // max(chunk * entry_bytes, 1), 1)
        chunks = min(chunks, int(max_chunks))
    return PoolConfig(num_chunks=chunks, chunk_size=chunk, mode=mode)


def chunk_for_step(cfg: PoolConfig, step):
    """Chunk index owned by a unit of work (an int or an integer tensor)."""
    if cfg.mode == "one2one":
        return step
    return step % cfg.num_chunks


def acquire_release_sim(thread_ids, release_after, num_chunks: int) -> torch.Tensor:
    """The MANY2MANY semantics check: run a timeline of acquire events
    (``thread_ids``) with a hold time each; event i first releases every
    chunk whose time has come (``<= i``), then scans from
    ``tid % num_chunks`` for the first free chunk, at most ``2*num_chunks``
    probes (exhaustion clamps to chunk 0, as in the reference). Returns the
    int32 chunk of each event, on the device of ``thread_ids``. Sequential:
    test scale only."""
    device = thread_ids.device if isinstance(thread_ids, torch.Tensor) else "cpu"
    tids = np.asarray(torch.as_tensor(thread_ids).cpu(), dtype=np.int64)
    holds = np.asarray(torch.as_tensor(release_after).cpu(), dtype=np.int64)
    locks = np.full(num_chunks, -1, np.int64)  # locks[j]: the step chunk j frees at
    got = np.zeros(tids.shape[0], np.int32)
    for i, tid in enumerate(tids):
        locks[locks <= i] = -1
        chunk = -1
        for j in range(2 * num_chunks):
            idx = (tid + j) % num_chunks
            if locks[idx] == -1:
                chunk = idx
                break
        chunk = max(chunk, 0)
        locks[chunk] = i + holds[i]
        got[i] = chunk
    return torch.from_numpy(got).to(device)

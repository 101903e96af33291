"""Deterministic, shard-aware data pipeline with exact skip-ahead (port of
``repro/data/pipeline.py``).

Counter-based RNG (Philox keyed by (seed, step)) means batch ``s`` is a pure
function of the step number — restart/resume after a failure replays no data
and skips no data (the checkpoint stores only the step). Each host slices
its rows from the global batch by (process_index, num_processes).

Tokens are drawn and addressed with numpy exactly as the reference draws
them, so a batch is bitwise the reference's, then handed over as int32
tensors on ``device`` ("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _rows_to_batch(rows: np.ndarray, device) -> dict:
    return {"tokens": torch.from_numpy(np.ascontiguousarray(rows[:, :-1])).to(device),
            "labels": torch.from_numpy(np.ascontiguousarray(rows[:, 1:])).to(device)}


@dataclasses.dataclass
class SyntheticLMDataset:
    """Zipf-ish synthetic token stream (vocab-shaped like real text)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    process_index: int = 0
    num_processes: int = 1
    device: str = "cuda"

    def local_batch_size(self) -> int:
        assert self.global_batch % self.num_processes == 0
        return self.global_batch // self.num_processes

    def get_batch(self, step: int) -> dict:
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=np.uint64(step))
        )
        b = self.local_batch_size()
        # skip rows belonging to other processes deterministically
        full = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        full = (full - 1) % self.vocab_size
        lo = self.process_index * b
        return _rows_to_batch(full[lo : lo + b].astype(np.int32), self.device)


@dataclasses.dataclass
class TokenFileDataset:
    """Memory-mapped token file (flat int32 stream), strided per process.

    Deterministic addressing: batch ``step`` reads rows
    [step * global_batch, (step+1) * global_batch) of seq_len+1 tokens, so
    resume-at-step is exact.
    """

    path: str
    seq_len: int
    global_batch: int
    process_index: int = 0
    num_processes: int = 1
    device: str = "cuda"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._row = self.seq_len + 1
        self.num_rows = len(self._data) // self._row

    def get_batch(self, step: int) -> dict:
        b = self.global_batch // self.num_processes
        start_row = (step * self.global_batch) % max(
            self.num_rows - self.global_batch, 1
        )
        lo = start_row + self.process_index * b
        rows = np.stack(
            [
                self._data[(lo + i) * self._row : (lo + i + 1) * self._row]
                for i in range(b)
            ]
        ).astype(np.int32)
        return _rows_to_batch(rows, self.device)


def make_labels(batch: dict) -> dict:
    """For modality-stub batches: synthesize frame-level targets. They are
    computed with numpy on a host copy of the frames, so they are bitwise
    the reference's, and returned as int32 on the frames' device."""
    if "labels" in batch:
        return batch
    frames = batch["frames"]
    host = frames.detach().to("cpu", torch.float32).numpy()
    labels = (np.abs(host.sum(-1) * 1000).astype(np.int64) % 504).astype(np.int32)
    return dict(batch, labels=torch.from_numpy(labels).to(frames.device))

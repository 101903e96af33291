"""The paper's accumulator data structures (§3.1.2), port of
``repro/core/accumulators.py``.

These are the semantic oracles of the numeric kernels, run one insert at a
time on the host:

* ``LLState`` — linked-list hashmap: 4 parallel arrays (Begins, Nexts, Ids,
  Values), power-of-2 ``&`` hashing, insertion at the list head.
* ``LPState`` — linear probing with the paper's 50% max-occupancy rule:
  beyond the cutoff, *new* keys are rejected (spill to L2) while existing
  keys still accumulate. The cutoff is clamped to ``size - 1`` so that an
  empty slot always survives and a probe always ends.
* ``accumulate_row`` — the two-level L1/L2 composition, with L2 sized to
  hold every spill (CHUNKSIZE = MAXRF).

The reference's functions are pure. Here ``ll_insert`` and ``lp_insert``
update the state's tensors in place and return that same state, which
saves a copy of every table per insert; callers use the returned state as
they would the reference's. Values add in the table's dtype, one insert at
a time, so a table holds exactly the reference's bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MAX_OCCUPANCY = 0.5  # paper §3.1.2: LP slows down past 50% occupancy


def _check_pow2(size: int, what: str) -> None:
    if size < 1 or size & (size - 1):
        from repro_torch.runtime.validate import SpgemmConfigError
        raise SpgemmConfigError(f"{what} must be a power of 2, got {size}")


class LLState(NamedTuple):
    begins: torch.Tensor  # (hash_size,) int32, -1 = empty list
    nexts: torch.Tensor  # (capacity,) int32, -1 = end of list
    ids: torch.Tensor  # (capacity,) int32
    values: torch.Tensor  # (capacity,) float
    used: torch.Tensor  # () int32


def ll_init(hash_size: int, capacity: int, dtype=torch.float32) -> LLState:
    _check_pow2(hash_size, "hash size")
    return LLState(
        begins=torch.full((hash_size,), -1, dtype=torch.int32),
        nexts=torch.full((capacity,), -1, dtype=torch.int32),
        ids=torch.zeros(capacity, dtype=torch.int32),
        values=torch.zeros(capacity, dtype=dtype),
        used=torch.zeros((), dtype=torch.int32),
    )


def ll_insert(state: LLState, key, val):
    """Insert-or-accumulate one (key, val). Returns (state, accepted: bool).

    accepted=False is the paper's "FULL" return: the caller spills to L2.
    """
    key = int(key)
    h = key & (state.begins.shape[0] - 1)
    idx = int(state.begins[h])
    while idx != -1:
        if int(state.ids[idx]) == key:
            state.values[idx] += val
            return state, True
        idx = int(state.nexts[idx])
    slot = int(state.used)
    if slot >= state.nexts.shape[0]:
        return state, False
    state.nexts[slot] = state.begins[h]
    state.begins[h] = slot
    state.ids[slot] = key
    state.values[slot] = val
    state.used.add_(1)
    return state, True


class LPState(NamedTuple):
    ids: torch.Tensor  # (size,) int32, -1 = empty (paper Fig. 4c)
    values: torch.Tensor  # (size,) float
    used: torch.Tensor  # () int32


def lp_init(size: int, dtype=torch.float32) -> LPState:
    _check_pow2(size, "LP table size")
    return LPState(
        ids=torch.full((size,), -1, dtype=torch.int32),
        values=torch.zeros(size, dtype=dtype),
        used=torch.zeros((), dtype=torch.int32),
    )


def lp_cutoff(size: int, max_occupancy: float = MAX_OCCUPANCY) -> int:
    """The paper's occupancy cutoff, clamped so an empty slot survives."""
    return min(int(size * max_occupancy), size - 1)


def lp_insert(state: LPState, key, val, max_occupancy: float = MAX_OCCUPANCY):
    """Linear-probing insert-or-accumulate with the max-occupancy cutoff.
    Returns (state, accepted: bool). ``max_occupancy`` must lie in (0, 1]."""
    if not 0.0 < max_occupancy <= 1.0:
        from repro_torch.runtime.validate import SpgemmConfigError
        raise SpgemmConfigError(
            f"max_occupancy must be in (0, 1]; got {max_occupancy!r}")
    key = int(key)
    size = state.ids.shape[0]
    mask = size - 1
    p = key & mask
    while True:
        held = int(state.ids[p])
        if held == -1 or held == key:
            break
        p = (p + 1) & mask
    exists = held == key
    if not exists and int(state.used) >= lp_cutoff(size, max_occupancy):
        return state, False
    state.ids[p] = key
    state.values[p] += val
    if not exists:
        state.used.add_(1)
    return state, True


class TwoLevelResult(NamedTuple):
    l1: LPState | LLState
    l2: LLState
    l2_allocated: torch.Tensor  # () bool — whether any spill happened


def accumulate_row(keys: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor,
                   l1_hash: int, l1_cap: int, l2_cap: int, kind: str = "ll"):
    """Run a full insert stream through the two-level L1/L2 scheme (Alg. 3
    lines 7-10). L2 is an LL map sized to hold every spill (MAXRF bound).

    Returns (l1_state, l2_state, l2_allocated).
    """
    if kind == "ll":
        l1 = ll_init(l1_hash, l1_cap, vals.dtype)
        insert1 = ll_insert
    elif kind == "lp":
        l1 = lp_init(l1_cap, vals.dtype)
        insert1 = lp_insert
    else:
        from repro_torch.runtime.validate import SpgemmConfigError
        raise SpgemmConfigError(
            f"unknown accumulator kind {kind!r}; expected 'll' or 'lp'")
    l2_hash = 1 << (max(1, l2_cap) - 1).bit_length()  # next pow2
    l2 = ll_init(l2_hash, l2_cap, vals.dtype)
    spilled = False
    for k, v, ok in zip(keys.tolist(), vals, valid.tolist()):
        if not ok:
            continue
        l1, accepted = insert1(l1, k, v)
        if not accepted:
            l2, _ = ll_insert(l2, k, v)
            spilled = True
    return l1, l2, torch.tensor(spilled)


def extract_sorted(ids: torch.Tensor, values: torch.Tensor, live: torch.Tensor):
    """Sort an accumulator's live (id, value) pairs by id (test helper).

    For LL maps pass ``live = arange(cap) < used``; for LP ``live = ids >= 0``.
    """
    key = torch.where(live, ids, torch.iinfo(torch.int32).max)
    order = torch.argsort(key, stable=True)
    return key[order], values[order], live[order]

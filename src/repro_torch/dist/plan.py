"""ShardedPlan: the two-phase SpGEMM plan lifecycle lifted onto a mesh (port
of ``repro/dist/plan.py``).

A ``ShardedPlan`` is a stacked per-shard ``SpgemmPlan``: every array
carries a leading shard axis and uniform capacities (the max over all S
shards, bucketed by ``core.meta.round_capacity``). Building one costs:

  1. ONE sharded expand-and-sort: ``expand_and_sort`` once per local shard,
     each shard enumerating and sorting its own products (never re-run for
     the plan);
  2. ONE host cap-sync: the per-shard nnz(C) maxima come to the host and
     pick the uniform ``nnz_cap`` bucket (under a process group, the max
     over ranks, by an all-gather of one scalar);
  3. ``plan_from_sorted`` per local shard, stacked: no second sort.

The plan also pins the value routing, so replays never touch structure:

  * ``a_perm`` (S, a_cap): the global A value slot feeding each shard slot;
  * ``b_shard_perm`` / ``b_perm`` (allgather placement only): how B values
    shard before the collective, and how the flattened all-gather maps onto
    the concatenated global B the plan was built against. B's structure
    all-gather (``concat_csr_shards``) happens once, here.

Every integer array is the reference's, bit for bit. Under a process group
the plan holds this rank's ``S_loc`` shards of every stacked array
(``b_perm``, which every shard reads, whole): ``num_shards`` is then the
local count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.distributed import (  # B_PLACEMENTS: the reference's name here
    B_PLACEMENTS,
    ShardedCSR,
    allgather_value_perm,
    check_placement,
    local_shard_csrs,
    max_over_mesh,
    partition_rows,
    partition_value_map,
    shard_fm_cap,
)
from repro_torch.core.meta import DEFAULT_PAD_POLICY, round_capacity
from repro_torch.core.spgemm import SortedExpansion, expand_and_sort, plan_from_sorted
from repro_torch.sparse.formats import CSR

_PLAN_ROWS = ("indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s")


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """Stacked per-shard numeric plan (leading shard axis, uniform caps).

    ``indptr``/``indices`` describe each shard's rows of C; ``seg_ids`` /
    ``a_slot_s`` / ``b_slot_s`` are each shard's precomposed replay maps
    (see ``SpgemmPlan``); the perms route values between the global and
    sharded layouts. For the replicated placement the B perms are empty
    placeholders, ``(S, 0)`` and ``(0,)``. The rows of the stacked replay
    maps lie ``4 * fm_cap`` bytes apart, a multiple of 32 (every cap is a
    multiple of 8), so each row keeps the stack's alignment for K1's int4
    plan loads.
    """

    indptr: torch.Tensor  # (S, m_loc+1) int32 — per-shard C row pointers
    indices: torch.Tensor  # (S, nnz_cap) int32 — per-shard C columns
    seg_ids: torch.Tensor  # (S, fm_cap) int32 — sorted product -> C slot
    a_slot_s: torch.Tensor  # (S, fm_cap) int32 — A slot per sorted product
    b_slot_s: torch.Tensor  # (S, fm_cap) int32 — B slot per sorted product
    a_perm: torch.Tensor  # (S, a_cap) int32 — global A value slot per shard slot
    b_shard_perm: torch.Tensor  # (S, b_cap) int32 (allgather) — B value sharding
    b_perm: torch.Tensor  # (S*b_cap,) int32 (allgather) — gathered -> concat slot
    shape: tuple  # global (m, k) of C

    @property
    def num_shards(self) -> int:
        return self.indptr.shape[0]

    @property
    def m_loc(self) -> int:
        return self.indptr.shape[1] - 1

    @property
    def nnz_cap(self) -> int:
        return self.indices.shape[1]

    @property
    def fm_cap(self) -> int:
        return self.seg_ids.shape[1]


def _expand_each(a_sh: ShardedCSR, b, mesh, axis: str, fm_cap: int) -> list:
    shards, b_glob = local_shard_csrs(a_sh, b, mesh, axis)
    return [expand_and_sort(a_loc, b_glob, fm_cap) for a_loc in shards]


def dist_expand_and_sort(a_sh: ShardedCSR, b: CSR | ShardedCSR, mesh,
                         axis: str, fm_cap: int) -> SortedExpansion:
    """ONE sharded expansion+sort: the stacked ``SortedExpansion`` of this
    process's shards. Its ``row_sizes`` (S_loc, m_loc) doubles as the
    sharded symbolic answer."""
    sxs = _expand_each(a_sh, b, mesh, axis, fm_cap)
    return SortedExpansion(**{f.name: torch.stack([getattr(sx, f.name) for sx in sxs])
                              for f in dataclasses.fields(SortedExpansion)})


def build_sharded_plan(a: CSR, b: CSR, mesh, *, axis: str = "data",
                       b_placement: str = "replicated",
                       pad_policy: str | None = None) -> ShardedPlan:
    """Pin the sharded plan: partition -> one sharded expand/sort -> one
    host cap-sync -> stacked plan composition.

    ``a`` and ``b`` are the global operands (callers that also feed the
    single-device path pass them through ``prepare_sparse_inputs`` first,
    so both paths hash and bucket alike). The expansions are held per shard
    and each shard's plan is written into the stack as it is built, so the
    peak is one stack of expansions, not two.
    """
    check_placement(b_placement)
    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    num = mesh.shape[axis]
    dev = a.device
    a_sh = partition_rows(a, num, policy)
    a_perm = mesh.local(partition_value_map(a, num, policy), axis)
    if b_placement == "replicated":
        b_in: CSR | ShardedCSR = b
        b_shard_perm = np.zeros((mesh.local_shards(axis)[1], 0), np.int32)
        b_perm = np.zeros((0,), np.int32)
    else:
        b_in = partition_rows(b, num, policy)
        b_shard_perm = mesh.local(partition_value_map(b, num, policy), axis)
        b_perm = allgather_value_perm(b_in)

    fm_cap = shard_fm_cap(a_sh, b, policy)
    sxs = _expand_each(a_sh, b_in, mesh, axis, fm_cap)
    # the one host round-trip between phases: a uniform nnz bucket over shards
    local_max = max(int(sx.row_sizes.sum()) for sx in sxs)
    nnz_cap = round_capacity(max_over_mesh(local_max, mesh, axis), policy)
    k = b.shape[1]
    rows = {name: torch.empty((len(sxs), n), dtype=torch.int32, device=dev)
            for name, n in zip(_PLAN_ROWS, (a_sh.m_loc + 1, nnz_cap, fm_cap, fm_cap, fm_cap))}
    for i in range(len(sxs)):
        p = plan_from_sorted(sxs[i], k, nnz_cap)
        sxs[i] = None  # free this shard's expansion before the next plan
        for name in _PLAN_ROWS:
            rows[name][i] = getattr(p, name)
        del p
    return ShardedPlan(
        **rows,
        a_perm=torch.from_numpy(np.ascontiguousarray(a_perm)).to(dev),
        b_shard_perm=torch.from_numpy(np.ascontiguousarray(b_shard_perm)).to(dev),
        b_perm=torch.from_numpy(b_perm).to(dev),
        shape=(a.m, k),
    )

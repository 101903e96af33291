"""Partitioning layer of the sharded SpGEMM, 1-D row decomposition (port of
``repro/core/distributed.py``).

This module is the partitioning substrate under ``repro_torch.dist``: the
host-side row decomposition (``partition_rows`` / ``merge_shards``), the
device-side shard concat used after all-gathering B
(``concat_csr_shards``), the value-slot maps that let a pinned sharded plan
re-shard values without touching structure (``partition_value_map`` /
``allgather_value_perm``), and the from-scratch driver
``distributed_spgemm``. The plan lifecycle (``ShardedPlan``,
``ShardedReuseExecutor``, the mesh-aware plan cache) lives in
``repro_torch.dist`` and composes these; use it whenever a structure is
replayed.

C's rows are partitioned over a mesh axis (the paper's first-level team
partitioning lifted to devices), with B either ``replicated`` on every
shard or ``allgather``: row-sharded, all-gathered before use.

The host functions are the reference's numpy code, with tensors out on the
operands' device, and give its arrays bit for bit. The sharded phases
(``dist_symbolic``, ``dist_numeric``) follow the port's mesh design
(``repro_torch.compat``): they take whole ``(S, ...)`` stacks or this
process's local ones, and return local ``(S_loc, ...)`` stacks, running the
port's ``symbolic_plain`` and ``numeric_fresh`` once per local shard (plain
torch, as the reference's fresh path). Every static cap goes through
``core.meta.round_capacity``, so shards share capacity buckets with the
single-device path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.meta import DEFAULT_PAD_POLICY, round_capacity
from repro_torch.core.spgemm import numeric_fresh, symbolic_plain
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.sparse.formats import CSR

B_PLACEMENTS = ("replicated", "allgather")


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-partitioned CSR with a leading shard axis on every array."""

    indptr: torch.Tensor  # (S, m_loc+1) int32
    indices: torch.Tensor  # (S, cap) int32
    values: torch.Tensor  # (S, cap)
    shape: tuple  # global (m, k)

    @property
    def num_shards(self) -> int:
        return self.indptr.shape[0]

    @property
    def m_loc(self) -> int:
        return self.indptr.shape[1] - 1


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def row_block_bounds(a: CSR, num_shards: int) -> np.ndarray:
    """Host-side: (S+1,) nnz offsets of the contiguous row blocks of ``a``.

    Shard ``s`` owns rows ``[s*ceil(m/S), min((s+1)*ceil(m/S), m))`` and its
    values/indices live in the global buffers at ``[bounds[s], bounds[s+1])``.
    The same bounds drive ``partition_rows`` and ``partition_value_map``, so
    structure and value sharding never disagree.
    """
    indptr = _host(a.indptr)
    m = a.m
    m_loc = -(-m // num_shards)
    return np.asarray(
        [indptr[min(s * m_loc, m)] for s in range(num_shards + 1)], np.int64)


def shard_cap(a: CSR, num_shards: int, pad_policy: str | None = None) -> int:
    """Uniform per-shard nnz capacity, bucketed by ``round_capacity``."""
    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    bounds = row_block_bounds(a, num_shards)
    return round_capacity(int(np.max(np.diff(bounds))), policy)


def partition_rows(a: CSR, num_shards: int,
                   pad_policy: str | None = None) -> ShardedCSR:
    """Host-side: split A into ``num_shards`` row blocks with uniform caps
    (on A's device)."""
    indptr = _host(a.indptr)
    indices = _host(a.indices)
    values = a.values.detach().cpu()
    m = a.m
    m_loc = -(-m // num_shards)
    bounds = row_block_bounds(a, num_shards)
    cap = shard_cap(a, num_shards, pad_policy)
    ip = np.zeros((num_shards, m_loc + 1), np.int32)
    ix = np.zeros((num_shards, cap), np.int32)
    vl = torch.zeros((num_shards, cap), dtype=values.dtype)
    for s in range(num_shards):
        # clamp both ends: when S > m whole shards fall past the last row
        # (rows == 0) and come out empty
        r0, r1 = min(s * m_loc, m), min((s + 1) * m_loc, m)
        lo, hi = bounds[s], bounds[s + 1]
        ip[s, : r1 - r0 + 1] = indptr[r0: r1 + 1] - lo
        ip[s, r1 - r0 + 1:] = indptr[r1] - lo  # empty padded rows
        ix[s, : hi - lo] = indices[lo:hi]
        vl[s, : hi - lo] = values[lo:hi]
    dev = a.device
    return ShardedCSR(indptr=torch.from_numpy(ip).to(dev),
                      indices=torch.from_numpy(ix).to(dev),
                      values=vl.to(dev), shape=a.shape)


def merge_shards(c_sh: ShardedCSR, m: int) -> CSR:
    """Host-side inverse of ``partition_rows`` (drops row padding); the
    result lies on the shards' device. Takes the whole ``(S, ...)`` stack."""
    S, m_loc1 = c_sh.indptr.shape
    m_loc = m_loc1 - 1
    ip = _host(c_sh.indptr)
    ix = _host(c_sh.indices)
    vl = c_sh.values.detach().cpu()
    out_ip = [0]
    out_ix, out_vl = [], []
    for s in range(S):
        rows = min(m_loc, m - s * m_loc)
        if rows <= 0:
            break
        nnz = ip[s, rows]
        out_ix.append(ix[s, :nnz])
        out_vl.append(vl[s, :nnz])
        base = out_ip[-1]
        out_ip.extend((ip[s, 1: rows + 1] + base).tolist())
    indices = np.concatenate(out_ix) if out_ix else np.zeros(0, np.int32)
    values = torch.cat(out_vl) if out_vl else torch.zeros(0, dtype=torch.float32)
    return CSR.from_arrays(np.asarray(out_ip, np.int32), indices, values,
                           (m, c_sh.shape[1]), device=c_sh.indptr.device)


def partition_value_map(a: CSR, num_shards: int,
                        pad_policy: str | None = None) -> np.ndarray:
    """(S, cap) int32: the global value slot feeding each shard value slot.

    ``values[perm]`` re-shards a values array exactly as ``partition_rows``
    sharded the structure. Padding slots point at clamped live slots; their
    products carry the sentinel ``seg_id`` and are dropped.
    """
    bounds = row_block_bounds(a, num_shards)
    cap = shard_cap(a, num_shards, pad_policy)
    base = bounds[:-1, None] + np.arange(cap, dtype=np.int64)[None, :]
    return np.minimum(base, max(a.nnz_cap - 1, 0)).astype(np.int32)


def allgather_value_perm(b_sh: ShardedCSR) -> np.ndarray:
    """(S*cap,) int32: the flattened all-gather slot of each global concat slot.

    ``all_gather(values).reshape(-1)[perm]`` reproduces the value layout of
    ``concat_csr_shards`` without concatenating structure again: B's
    structure all-gather is paid once at pin time, replays move values only.
    """
    S, cap = b_sh.indices.shape
    nnz_s = _host(b_sh.indptr)[:, -1].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(nnz_s)[:-1]])
    perm = np.zeros(S * cap, np.int32)
    for s in range(S):
        n = int(nnz_s[s])
        perm[offs[s]: offs[s] + n] = s * cap + np.arange(n, dtype=np.int64)
    return perm


def concat_csr_shards(indptrs: torch.Tensor, indices: torch.Tensor,
                      values: torch.Tensor, k: int) -> CSR:
    """On the device: one global CSR from gathered row shards (used after
    all-gathering B). Slots past each shard's nnz are dropped, as the
    reference's ``mode="drop"`` scatter drops its out-of-range index."""
    S, m_loc1 = indptrs.shape
    cap = indices.shape[1]
    dev = indptrs.device
    nnzs = indptrs[:, -1].to(torch.int64)  # (S,)
    offs = torch.zeros(S, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(nnzs, 0)[:-1]
    slot = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    dest = torch.where(slot < nnzs[:, None], offs[:, None] + slot, S * cap).reshape(-1)
    # one extra slot takes every dropped entry, then is cut off
    g_ix = torch.zeros(S * cap + 1, dtype=torch.int32, device=dev)
    g_vl = torch.zeros(S * cap + 1, dtype=values.dtype, device=dev)
    g_ix.index_put_((dest,), indices.reshape(-1))
    g_vl.index_put_((dest,), values.reshape(-1))
    g_ip = torch.empty(S * (m_loc1 - 1) + 1, dtype=torch.int32, device=dev)
    g_ip[:-1] = (offs[:, None] + indptrs[:, :-1]).reshape(-1)
    g_ip[-1] = offs[-1] + nnzs[-1]
    return CSR(indptr=g_ip, indices=g_ix[:-1], values=g_vl[:-1],
               shape=(S * (m_loc1 - 1), k))


def _local_csr(indptr, indices, values, shape) -> CSR:
    return CSR(indptr=indptr, indices=indices, values=values, shape=shape)


def _local_stack(sh: ShardedCSR, mesh, axis: str) -> tuple:
    return tuple(mesh.local(t, axis) for t in (sh.indptr, sh.indices, sh.values))


def gathered_b(b_sh: ShardedCSR, mesh, axis: str) -> CSR:
    """The global B of the allgather placement: every shard's rows gathered
    over ``axis`` and concatenated on the device."""
    ip, ix, vl = (mesh.all_gather(t, axis) for t in _local_stack(b_sh, mesh, axis))
    return concat_csr_shards(ip, ix, vl, b_sh.shape[1])


def local_shard_csrs(a_sh: ShardedCSR, b, mesh, axis: str):
    """This process's A shards as CSRs and the B each one multiplies with."""
    ip, ix, vl = _local_stack(a_sh, mesh, axis)
    b_glob = b if isinstance(b, CSR) else gathered_b(b, mesh, axis)
    shape = (a_sh.m_loc, a_sh.shape[1])
    return [_local_csr(ip[i], ix[i], vl[i], shape) for i in range(ip.shape[0])], b_glob


def dist_symbolic(a_sh: ShardedCSR, b: CSR | ShardedCSR, mesh, axis: str,
                  fm_cap: int) -> torch.Tensor:
    """The sharded symbolic phase: (S_loc, m_loc) row sizes of this
    process's shards of C. ``b`` is a CSR (replicated) or row shards
    (allgather)."""
    shards, b_glob = local_shard_csrs(a_sh, b, mesh, axis)
    return torch.stack([symbolic_plain(a_loc, b_glob, fm_cap) for a_loc in shards])


def dist_numeric(a_sh: ShardedCSR, b: CSR | ShardedCSR, mesh, axis: str,
                 fm_cap: int, nnz_cap: int) -> ShardedCSR:
    """The sharded numeric phase with uniform caps on every shard: this
    process's (S_loc, ...) shards of C."""
    shards, b_glob = local_shard_csrs(a_sh, b, mesh, axis)
    cs = [numeric_fresh(a_loc, b_glob, fm_cap, nnz_cap)[0] for a_loc in shards]
    return ShardedCSR(indptr=torch.stack([c.indptr for c in cs]),
                      indices=torch.stack([c.indices for c in cs]),
                      values=torch.stack([c.values for c in cs]),
                      shape=(a_sh.shape[0], b.shape[1]))


def shard_fm_cap(a_sh: ShardedCSR, b: CSR, pad_policy: str | None = None) -> int:
    """Host-side uniform per-shard f_m capacity (max over all S shards,
    bucketed): ``a_sh`` is the whole stack ``partition_rows`` returns."""
    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    b_rn = np.diff(_host(b.indptr))
    a_ix = _host(a_sh.indices)
    a_ip = _host(a_sh.indptr)
    fm_cap = 1
    for s in range(a_sh.num_shards):
        nnz_s = a_ip[s, -1]
        fm_s = int(b_rn[a_ix[s, :nnz_s]].sum()) if nnz_s else 0
        fm_cap = max(fm_cap, fm_s)
    return round_capacity(fm_cap, policy)


def max_over_mesh(value: int, mesh, axis: str) -> int:
    """The largest of every process's ``value``: the one host cap-sync of
    the sharded phases (a one-element all-gather under a process group)."""
    t = torch.full((mesh.local_shards(axis)[1],), int(value), dtype=torch.int64,
                   device=mesh.device)
    return int(mesh.all_gather(t, axis).max())


def check_placement(b_placement: str) -> None:
    if b_placement not in B_PLACEMENTS:
        raise SpgemmConfigError(
            f"unknown b_placement {b_placement!r}; expected one of {B_PLACEMENTS}")


def distributed_spgemm(a: CSR, b: CSR, mesh, axis: str = "data",
                       b_placement: str = "replicated",
                       pad_policy: str | None = None) -> CSR:
    """Host driver: partition -> symbolic -> sync caps -> numeric -> merge.

    The from-scratch path: every call runs both phases again. When a
    structure repeats, pin it once with ``repro_torch.dist.
    ShardedReuseExecutor`` (or ``spgemm(..., mesh=...)``, which caches
    sharded plans) and replay only the numeric phase. Every process
    returns the whole C.
    """
    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    check_placement(b_placement)
    num = mesh.shape[axis]
    a_sh = partition_rows(a, num, policy)
    b_in: CSR | ShardedCSR = b if b_placement == "replicated" else partition_rows(b, num, policy)
    fm_cap = shard_fm_cap(a_sh, b, policy)
    sizes = dist_symbolic(a_sh, b_in, mesh, axis, fm_cap)  # (S_loc, m_loc)
    nnz_cap = round_capacity(max_over_mesh(int(sizes.sum(1).max()), mesh, axis), policy)
    c_sh = dist_numeric(a_sh, b_in, mesh, axis, fm_cap, nnz_cap)
    whole = ShardedCSR(*(mesh.all_gather(t, axis)
                         for t in (c_sh.indptr, c_sh.indices, c_sh.values)), c_sh.shape)
    return merge_shards(whole, a.m)

"""ShardedReuseExecutor: pinned sharded plans replayed shard by shard (port
of ``repro/dist/executor.py``).

The single-device ``ReuseExecutor`` made the paper's Reuse case cheap to
dispatch; this is the same contract on a mesh. Construction pins a
``ShardedPlan`` (one ``structure_key`` hash, ever, probed against the
mesh-aware plan cache, so a repeated structure never re-shards), and every
``apply`` replays each local shard: two gathers and one sorted segment sum,
the function of the reference's per-shard ``numeric_reuse``.

What runs a shard's replay:

  * CUDA tensors whose dtypes ``f32_accumulation_ok`` admits: the K1 replay
    kernel, ``kernels.segsum_reuse.segsum_reuse_arrays``, once per local
    shard with live products (``segsum_reuse_batched_arrays`` for
    ``apply_batched``), on row s of the stacked plan. A shard with no live
    product is zeros, with no launch. There is no degradation ladder, as in
    the reference's sharded replay: a ``KernelLaunchError`` or
    ``KernelBuildError`` reaches the caller;
  * CUDA tensors of f64 or integer dtypes: the plain ``numeric_reuse`` (the
    dtype guard of ``ReuseExecutor``; ``FALLBACK_COUNTS
    ["dtype:dist->xla"]`` counts it);
  * CPU tensors: the plain ``numeric_reuse``, as the reference. Each shard
    holds the same products in the same sorted order as its slice of the
    single-device plan, so ``merge`` of a CPU replay is bitwise the
    single-device plain replay. On the card K1's tiles start at other
    products than the single-device launch's, so the sums agree within
    ``F32_TOL``, not bit for bit.

Value routing is part of the plan, so replays never touch structure: fresh
A values enter in the global ``(a_nnz_cap,)`` layout and are re-sharded by
the pinned ``a_perm`` gather; replicated B values pass through; allgather B
values are sharded by ``b_shard_perm``, all-gathered over the mesh axis and
routed into the concatenated layout by ``b_perm`` (only values move).

``apply`` returns this process's ``(S_loc, nnz_cap)`` values (under the
single-process mesh, the reference's ``(S, nnz_cap)``); ``merge`` and
``merge_values`` all-gather first, so every process gets the whole C.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import (ShardedCSR, check_placement, max_over_mesh,
                                          merge_shards)
from repro_torch.core.executor import DISPATCH_COUNTS, _replay_batched
from repro_torch.core.meta import DEFAULT_PAD_POLICY, f32_accumulation_ok
from repro_torch.core.plan_cache import structure_key
from repro_torch.core.spgemm import (SpgemmPlan, SpgemmResult, _note_stage, gather_clamped,
                                     numeric_reuse, prepare_sparse_inputs)
from repro_torch.dist.plan import ShardedPlan, build_sharded_plan
from repro_torch.dist.plan_cache import default_dist_plan_cache, dist_plan_key
from repro_torch.kernels.segsum_reuse import segsum_reuse_arrays, segsum_reuse_batched_arrays
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.validate import (PlanMismatchError, SpgemmConfigError,
                                          SpgemmInputError, check_csr, resolve_mode)
from repro_torch.sparse.formats import CSR


class ShardedReuseExecutor:
    """A pinned ``ShardedPlan`` exposed as a mesh replay engine.

    Construction is the only host-side work (partitioning, one structure
    hash, one sharded expand+sort on a cache miss, one read of which local
    shards have live products); every ``apply`` / ``apply_batched`` then
    replays with zero hashing and zero cache probes.
    """

    def __init__(self, plan: ShardedPlan, mesh, *, axis: str = "data",
                 b_placement: str = "replicated", validate: str | None = "off"):
        check_placement(b_placement)
        count = mesh.local_shards(axis)[1]
        if plan.num_shards != count:
            raise PlanMismatchError(
                f"plan has {plan.num_shards} shards but mesh axis {axis!r} holds "
                f"{count} of its {mesh.shape[axis]} here")
        self.plan = plan
        self.mesh = mesh
        self.axis = axis
        self.b_placement = b_placement
        self.cache_state = "pinned"
        self._merge_perm = None  # built lazily by merge_values
        self._whole = None  # the whole (S, ...) C structure, gathered lazily
        m_loc, k = plan.m_loc, plan.shape[1]
        self._shard_plans = [
            SpgemmPlan(indptr=plan.indptr[i], indices=plan.indices[i],
                       seg_ids=plan.seg_ids[i], a_slot_s=plan.a_slot_s[i],
                       b_slot_s=plan.b_slot_s[i], shape=(m_loc, k))
            for i in range(count)]
        # which local shards have a live product: seg_ids are sorted, so the
        # first product says (one small read)
        self.live_shards = (plan.seg_ids[:, 0] < plan.nnz_cap).tolist()
        # validate= mirrors ReuseExecutor: a literal "off" default (the
        # replay hot path must not change under $REPRO_VALIDATE); the pin
        # reads the plan once for O(1) per-replay operand checks
        self.validate_mode = resolve_mode(validate)
        self._a_req = self._b_req = 0
        if self.validate_mode != "off":
            # requirements over LIVE products only: trace each live
            # product's slot back through the pinned routing perms to the
            # global value slot it reads
            live = plan.seg_ids.cpu().numpy() < plan.nnz_cap
            asl = plan.a_slot_s.cpu().numpy()
            bsl = plan.b_slot_s.cpu().numpy()
            aperm = plan.a_perm.cpu().numpy()  # (S_loc, a_cap): local -> global
            ga = np.take_along_axis(aperm, np.minimum(asl, aperm.shape[1] - 1), axis=1)
            a_req = int(ga[live].max()) + 1 if live.any() else 0
            if b_placement == "replicated":
                gb = bsl[live]
            else:
                # concat slot -> gathered flat slot -> global value slot; the
                # whole b_shard_perm is the gather of every rank's rows
                bperm = plan.b_perm.cpu().numpy()
                flatshard = mesh.all_gather(plan.b_shard_perm, axis).cpu().numpy().reshape(-1)
                gb = flatshard[bperm[np.minimum(bsl[live], len(bperm) - 1)]]
            b_req = int(gb.max()) + 1 if gb.size else 0
            # every rank checks against the same bound, so all raise together
            self._a_req = max_over_mesh(a_req, mesh, axis)
            self._b_req = max_over_mesh(b_req, mesh, axis)

    def _check_values(self, a_values, b_values, batched: bool) -> None:
        """Per-replay operand check (validate != "off"): global value-buffer
        lengths against the pinned routing perms (``PlanMismatchError``),
        plus a finiteness sweep in "device" mode (``SpgemmInputError``)."""
        for side, vals, req in (("A", a_values, self._a_req),
                                ("B", b_values, self._b_req)):
            ok_ndim = vals.ndim in (1, 2) if batched else vals.ndim == 1
            if not ok_ndim:
                raise PlanMismatchError(
                    f"{side} values must be "
                    f"{'(batch, nnz) or (nnz,)' if batched else '1-D (nnz,)'} in the "
                    f"flat global layout, got shape {tuple(vals.shape)}")
            if vals.shape[-1] < req:
                raise PlanMismatchError(
                    f"{side} value buffer has {vals.shape[-1]} slots but the pinned "
                    f"sharded plan routes up to slot {req - 1}: replaying against "
                    f"operands from a different structure?")
            if (self.validate_mode == "device" and vals.is_floating_point()
                    and not bool(torch.isfinite(vals).all())):
                raise SpgemmInputError(f"{side} values contain NaN/Inf (device validation)")

    @classmethod
    def from_matrices(cls, a: CSR, b: CSR, mesh, *, axis: str = "data",
                      b_placement: str = "replicated", pad_policy: str | None = None,
                      plan_cache=None, validate: str | None = "off",
                      _prepared=None) -> "ShardedReuseExecutor":
        """Build (or fetch from the mesh-aware plan cache) the sharded plan
        for ``a @ b`` and pin it. One structure hash, ever; a cache hit
        skips partitioning, the sharded expansion and the plan build.

        ``_prepared``: a caller that already ran ``prepare_sparse_inputs``
        (``sharded_spgemm``) passes its tuple to skip a second preamble.
        """
        policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
        vmode = resolve_mode(validate)
        if vmode != "off":
            check_csr(a, vmode, name="A")
            check_csr(b, vmode, name="B")
        if _prepared is None:
            _prepared = prepare_sparse_inputs(a, b, policy)
        a, b, _, _, fm_cap = _prepared
        skey = structure_key(a, b, fm_cap, policy)  # the one hash
        if plan_cache is None:
            cache = default_dist_plan_cache()
        elif plan_cache is False:
            cache = None
        else:
            cache = plan_cache
        key = dist_plan_key(skey, mesh.shape[axis], b_placement)
        plan = cache.get(key) if cache is not None else None
        state = "hit"
        if plan is None:
            plan = build_sharded_plan(a, b, mesh, axis=axis, b_placement=b_placement,
                                      pad_policy=policy)
            if cache is not None:
                cache.put(key, plan)
                state = "miss"
            else:
                state = "bypass"
        ex = cls(plan, mesh, axis=axis, b_placement=b_placement, validate=vmode)
        ex.cache_state = state
        return ex

    @property
    def shape(self) -> tuple:
        return tuple(self.plan.shape)

    @property
    def num_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def nnz_cap(self) -> int:
        return self.plan.nnz_cap

    def _routed_b(self, b_values: torch.Tensor) -> torch.Tensor:
        """B values in the global concat layout the plan was built against:
        ``(n,)`` or ``(batch, n)`` as given."""
        if self.b_placement == "replicated":
            return b_values
        p = self.plan
        count, cap = p.b_shard_perm.shape
        b_sh = gather_clamped(b_values, p.b_shard_perm.reshape(-1))
        if b_values.ndim == 2:  # (batch, S_loc*cap) -> (S_loc, batch, cap)
            b_sh = b_sh.view(b_values.shape[0], count, cap).transpose(0, 1)
        else:
            b_sh = b_sh.view(count, cap)
        gathered = self.mesh.all_gather(b_sh, self.axis)  # (S, [batch,] cap)
        if b_values.ndim == 2:
            flat = gathered.transpose(0, 1).reshape(b_values.shape[0], -1)
            return flat.index_select(1, p.b_perm)
        return gathered.reshape(-1).index_select(0, p.b_perm)

    def _replay(self, a_values: torch.Tensor, b_values: torch.Tensor,
                batched: bool) -> torch.Tensor:
        _note_stage("dist_replay")
        p = self.plan
        bg = self._routed_b(b_values)
        kernel = (a_values.device.type == "cuda"
                  and f32_accumulation_ok(a_values.dtype, b_values.dtype))
        if a_values.device.type == "cuda" and not kernel:
            from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

            FALLBACK_COUNTS["dtype:dist->xla"] += 1
        out_shape = (p.nnz_cap,)
        if batched:
            rows = a_values.shape[0] if a_values.ndim == 2 else b_values.shape[0]
            out_shape = (rows, p.nnz_cap)
        out_dtype = torch.promote_types(a_values.dtype, b_values.dtype)
        outs = []
        for i, sp in enumerate(self._shard_plans):
            a_loc = gather_clamped(a_values, p.a_perm[i])
            if not kernel:
                outs.append(_replay_batched(sp, a_loc, bg) if batched
                            else numeric_reuse(sp, a_loc, bg))
            elif not self.live_shards[i]:
                outs.append(torch.zeros(out_shape, dtype=out_dtype, device=a_values.device))
            elif batched:
                outs.append(segsum_reuse_batched_arrays(
                    sp.a_slot_s, sp.b_slot_s, sp.seg_ids, a_loc, bg, nnz_cap=p.nnz_cap))
            else:
                outs.append(segsum_reuse_arrays(
                    sp.a_slot_s, sp.b_slot_s, sp.seg_ids, a_loc, bg, nnz_cap=p.nnz_cap))
        return torch.stack(outs, dim=1 if batched else 0)

    def apply(self, a_values: torch.Tensor, b_values: torch.Tensor) -> torch.Tensor:
        """Replay on new global operand values -> this process's
        (S_loc, nnz_cap) C values.

        Operand values use the flat global layout of the single-device
        executor (the pinned perms re-shard them), so a serving loop can
        switch meshes without reshaping its buffers.
        """
        DISPATCH_COUNTS["dist_apply"] += 1
        if self.validate_mode != "off":
            self._check_values(a_values, b_values, batched=False)
        with obs_trace.span("dist.replay", placement=self.b_placement,
                            shards=self.num_shards):
            return self._replay(a_values, b_values, batched=False)

    def apply_batched(self, a_values: torch.Tensor, b_values: torch.Tensor) -> torch.Tensor:
        """Replay stacked values -> (batch, S_loc, nnz_cap).

        Either operand may be stacked ``(batch, operand_nnz_cap)`` or shared
        ``(operand_nnz_cap,)``; at least one must be stacked. On the card,
        one batched K1 launch a local shard with live products.
        """
        DISPATCH_COUNTS["dist_apply_batched"] += 1
        if a_values.ndim != 2 and b_values.ndim != 2:
            raise SpgemmConfigError(
                "apply_batched needs at least one stacked (batch, nnz) operand; use "
                "apply() for a single replay")
        if self.validate_mode != "off":
            self._check_values(a_values, b_values, batched=True)
        batch = a_values.shape[0] if a_values.ndim == 2 else b_values.shape[0]
        with obs_trace.span("dist.replay", placement=self.b_placement,
                            shards=self.num_shards, batch=batch):
            return self._replay(a_values, b_values, batched=True)

    def _check_one_replay(self, values: torch.Tensor, what: str) -> None:
        want = (self.plan.num_shards, self.nnz_cap)
        if tuple(values.shape) != want:
            raise PlanMismatchError(
                f"{what} takes ONE replay's (S_loc, nnz_cap)={want} values, got "
                f"{tuple(values.shape)}; apply_batched output carries a leading "
                f"batch axis: index a batch element first")

    def to_sharded_csr(self, values: torch.Tensor) -> ShardedCSR:
        """Wrap one replay's (S_loc, nnz_cap) values in this process's
        shards of C's structure."""
        self._check_one_replay(values, "to_sharded_csr")
        return ShardedCSR(indptr=self.plan.indptr, indices=self.plan.indices,
                          values=values, shape=self.shape)

    def _whole_structure(self) -> tuple:
        """C's (S, m_loc+1) row pointers and (S, nnz_cap) columns over every
        shard: the plan's own in one process, gathered once otherwise."""
        if self._whole is None:
            self._whole = tuple(self.mesh.all_gather(t, self.axis)
                                for t in (self.plan.indptr, self.plan.indices))
        return self._whole

    def merge(self, values: torch.Tensor) -> CSR:
        """Host-side: merge one replay's values into the global C (every
        process gets all of it)."""
        self._check_one_replay(values, "merge")
        ip, ix = self._whole_structure()
        whole = ShardedCSR(indptr=ip, indices=ix,
                           values=self.mesh.all_gather(values, self.axis), shape=self.shape)
        return merge_shards(whole, self.shape[0])

    def merge_values(self, values: torch.Tensor) -> torch.Tensor:
        """Device-side merge: one replay's values -> the flat global value
        layout of ``merge(...)`` (live slots, row-major), by one gather
        through a perm pinned on first use: no host transfer of values."""
        self._check_one_replay(values, "merge_values")
        if self._merge_perm is None:
            ip = self._whole_structure()[0].cpu().numpy()
            m, m_loc = self.shape[0], self.plan.m_loc
            perm = []
            for s in range(self.num_shards):
                rows = min(m_loc, max(m - s * m_loc, 0))
                nnz_s = int(ip[s, rows]) if rows else 0
                perm.append(s * self.nnz_cap + np.arange(nnz_s, dtype=np.int64))
            self._merge_perm = torch.from_numpy(
                np.concatenate(perm) if perm else np.zeros(0, np.int64)).to(values.device)
        return self.mesh.all_gather(values, self.axis).reshape(-1)[self._merge_perm]


def sharded_spgemm(a: CSR, b: CSR, mesh, *, axis: str = "data",
                   b_placement: str = "replicated", pad_policy: str | None = None,
                   plan_cache=None) -> SpgemmResult:
    """One sharded multiply through the pinned-plan machinery.

    The mesh entry point behind ``spgemm(..., mesh=...)``: resolves (or
    builds) the sharded plan through the mesh-aware cache, replays once,
    merges. Returns a ``SpgemmResult`` whose ``plan`` is the ``ShardedPlan``:
    hand it to ``ShardedReuseExecutor`` to keep replaying without hashing.
    """
    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    prepared = prepare_sparse_inputs(a, b, policy)
    a, b, fm, maxrf, fm_cap = prepared
    ex = ShardedReuseExecutor.from_matrices(
        a, b, mesh, axis=axis, b_placement=b_placement, pad_policy=policy,
        plan_cache=plan_cache, _prepared=prepared)
    values = ex.apply(a.values, b.values)
    c = ex.merge(values)
    stats = {
        "method": "sparse",
        "pad_policy": policy,
        "fm": fm,
        "maxrf": maxrf,
        "fm_cap": fm_cap,
        "cache": ex.cache_state,
        "mesh_shape": tuple(mesh.axis_shapes),
        "mesh_axis": axis,
        "num_shards": ex.num_shards,
        "b_placement": b_placement,
        "nnz_c": int(c.indptr[-1]),
        "nnz_cap": ex.nnz_cap,
    }
    return SpgemmResult(c=c, plan=ex.plan, stats=stats)

"""Structure-keyed LRU cache of SpGEMM plans (port of ``repro/core/plan_cache.py``).

``structure_key`` hashes A's and B's ``indptr``, the live prefix of their
``indices`` (int32 bytes), their shapes and capacities, the bucketed
``fm_cap`` and the pad policy — the same bytes in the same order as the
reference, so both packages give the same hex digest for the same operands.
Tensors on the card are copied to the host for the digest.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import Counter, OrderedDict
from typing import Any

import torch

from repro_torch.obs.trace import span

# Hash telemetry: ``structure_key`` bumps this on every call, so callers can
# assert the executor's "one structure hash, ever" contract.
HASH_COUNTS: Counter = Counter()


def reset_hash_counts() -> None:
    HASH_COUNTS.clear()


# Eviction telemetry, keyed by cache name. clear() does not count.
EVICT_COUNTS: Counter = Counter()


def reset_evict_counts() -> None:
    EVICT_COUNTS.clear()


def plan_nbytes(plan) -> int:
    """Device bytes pinned by a cached plan: the sum of its tensors' nbytes."""
    return sum(v.nbytes for v in (getattr(plan, f.name) for f in dataclasses.fields(plan))
               if isinstance(v, torch.Tensor))


class PlanCache:
    """Bounded LRU mapping structure keys -> SpgemmPlan.

    Two bounds compose: ``capacity`` (entries) and ``max_bytes`` (device
    memory pinned by cached plans, ``plan_nbytes``). The most recent entry
    is always kept, even when it alone exceeds ``max_bytes``. A per-entry
    sidecar (``set_meta``/``get_meta``) lives and dies with its entry.
    """

    def __init__(self, capacity: int = 16, max_bytes: int | None = None,
                 name: str = "plan"):
        if capacity < 1 or (max_bytes is not None and max_bytes < 1):
            from repro_torch.runtime.validate import SpgemmConfigError
            if capacity < 1:
                raise SpgemmConfigError(
                    f"capacity must be >= 1, got {capacity}")
            raise SpgemmConfigError(
                f"max_bytes must be >= 1, got {max_bytes}")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.name = name  # EVICT_COUNTS key
        self._entries: OrderedDict[str, Any] = OrderedDict()
        self._nbytes: dict[str, int] = {}
        self._meta: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get(self, key: str):
        """Return the cached plan (refreshing recency) or None."""
        with self._lock:
            plan = self._entries.get(key)
            if plan is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return plan

    def put(self, key: str, plan) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.total_bytes -= self._nbytes.pop(key)
            nbytes = plan_nbytes(plan)
            self._entries[key] = plan
            self._nbytes[key] = nbytes
            self.total_bytes += nbytes
            while len(self._entries) > self.capacity or (
                self.max_bytes is not None
                and self.total_bytes > self.max_bytes
                and len(self._entries) > 1
            ):
                old_key, _ = self._entries.popitem(last=False)
                self.total_bytes -= self._nbytes.pop(old_key)
                self._meta.pop(old_key, None)
                self.evictions += 1
                EVICT_COUNTS[self.name] += 1

    def set_meta(self, key: str, meta_key, value) -> bool:
        """Attach sidecar metadata to a cached entry; False if not resident."""
        with self._lock:
            if key not in self._entries:
                return False
            self._meta.setdefault(key, {})[meta_key] = value
            return True

    def get_meta(self, key: str, meta_key, default=None):
        """Sidecar metadata for a cached entry, or ``default``."""
        with self._lock:
            return self._meta.get(key, {}).get(meta_key, default)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes.clear()
            self._meta.clear()
            self.total_bytes = 0
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "name": self.name,
            "size": len(self._entries),
            "capacity": self.capacity,
            "bytes": self.total_bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": (self.hits / total) if total else 0.0,
        }


def structure_key(a, b, fm_cap: int, pad_policy: str) -> str:
    """Hash the structural identity of a multiply (values excluded).

    The whole digest, host copies included, runs inside a ``plan.hash`` span
    (attribute ``bytes``: the bytes hashed), each copy a ``host.read`` span."""
    HASH_COUNTS["structure_key"] += 1
    with span("plan.hash") as sp:
        h = hashlib.blake2b(digest_size=16)
        nbytes = 0
        for mat in (a, b):
            with span("host.read", site="structure_key.indptr"):
                indptr = mat.indptr.to(torch.int32).cpu().numpy()
            nnz = int(indptr[-1])
            with span("host.read", site="structure_key.indices"):
                indices = mat.indices[:nnz].to(torch.int32).cpu().numpy()
            shape = repr((tuple(mat.shape), mat.nnz_cap)).encode()
            for part in (indptr.tobytes(), indices.tobytes(), shape):
                h.update(part)
                nbytes += len(part)
        tail = repr((int(fm_cap), pad_policy)).encode()
        h.update(tail)
        sp.set("bytes", nbytes + len(tail))
        return h.hexdigest()


_DEFAULT_CACHE = PlanCache(name="default")


def default_plan_cache() -> PlanCache:
    """The module-level cache used by ``spgemm()`` when none is passed."""
    return _DEFAULT_CACHE

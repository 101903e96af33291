"""Per-rank op counts of one eager run on meta tensors (port of
``repro/launch/hlo_cost.py``).

The reference parses the compiled per-chip HLO and multiplies each while
body by its trip count. Eager torch has no HLO, so this module counts what
one run of the program does instead: ``count_ops(fn, *args)`` calls ``fn``
once under a ``TorchDispatchMode`` on ``meta`` tensors, where every op has
a shape and a dtype and nothing is computed or allocated.

**Per rank, from local shapes.** On a data x model mesh the args are
DTensors. A counter at the DTensor level (``FlopCounterMode``) sees the
global op: a matmul sharded 256 ways counts 256 times one rank's work. The
mode here steps aside for every op that has a DTensor argument (it returns
``NotImplemented``, and DTensor's dispatch runs with the mode still on the
stack), so it counts what DTensor runs below: the local op on each
argument's local shard, the redistributions' collectives and copies, and
work repeated on replicated dims, as the reference's per-chip HLO counts
it. DTensor's own shape propagation runs the op once more on global fake
tensors; those ops (``FakeTensor`` arguments or results) are not counted.

What is counted, for this rank:

* matmul flops (``torch.utils.flop_counter``'s formulas: mm, addmm, bmm,
  baddbmm, convolutions, attention), split by compute dtype: bf16/f16 (the
  tensor cores) and the rest (f32);
* bytes read and written by every op that materialises a tensor: its
  tensor inputs and outputs, once each; views, ``empty`` and the
  collectives' wrappers and waits are free;
* collectives by kind (all-gather, all-reduce, reduce-scatter,
  all-to-all): result bytes and counts, and the bytes by link class (a
  group of at most ``NODE_GPUS`` ranks on NVLink, a larger one on
  the network). An all-to-all counts as one, as NCCL issues it: a CPU
  group has none, and DTensor's fallback (an all-gather and a chunk, inside
  ``shard_dim_alltoall``) is counted as the all-to-all it stands for, its
  result the size of its input;
* memory: meta tensors have no allocator, so every storage an op creates
  is tracked live until it is freed (a weakref finalizer a storage). The
  peak of the arguments plus the live storages is ``peak_bytes``, split as
  XLA's ``memory_analysis`` splits it: ``argument_bytes`` (the args' local
  storages), ``output_bytes`` (the result's storages that the run
  created), ``temp_bytes`` (the rest of the peak).

Eager torch has no scan to undercount: a Python loop runs every trip, and
each trip's ops are counted as they run. The reference's while-body trip
counts therefore have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import _tree

LOW_PRECISION = (torch.bfloat16, torch.float16)
NODE_GPUS = 8  # the ranks one NVLink domain holds (an 8-GPU HGX H100 node)
_KIND_WORDS = (("reduce_scatter", "reduce-scatter"), ("all_gather", "all-gather"),
               ("allgather", "all-gather"), ("all_reduce", "all-reduce"),
               ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
               ("alltoall", "all-to-all"))
_FREE_OPS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
             "detach", "lift_fresh", "_wrap_tensor_autograd", "wait_tensor"}
_ALLTOALL_FALLBACK = "shard_dim_alltoall"


@dataclasses.dataclass
class OpCost:
    """One rank's counts of one run (see the module docstring)."""

    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)  # kind -> result bytes
    collective_counts: dict = dataclasses.field(default_factory=dict)  # kind -> count
    link_bytes: dict = dataclasses.field(default_factory=lambda: {"nvlink": 0.0,
                                                                  "network": 0.0})
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0

    @property
    def flops(self) -> float:
        return self.flops_bf16 + self.flops_f32

    def coll_breakdown(self) -> dict:
        """The reference's ``collective_bytes`` dict: bytes a kind, 'total'
        and 'count'."""
        out = {k: float(v) for k, v in self.collectives.items()}
        out["total"] = float(sum(self.collectives.values()))
        out["count"] = int(sum(self.collective_counts.values()))
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "OpCost":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _tensors(tree) -> list:
    return [_local(x) for x in _tree.leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kind(func) -> str | None:
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns not in ("_c10d_functional", "c10d", "_dtensor"):
        return None
    for word, kind in _KIND_WORDS:
        if word in name:
            return kind
    return None


def _group_size(args) -> int:
    """The size of the group a collective runs over (its group's name is
    its last string argument)."""
    from torch.distributed import distributed_c10d

    names = [a for a in args if isinstance(a, str)]
    return distributed_c10d._resolve_process_group(names[-1]).size()


def _alltoall_fallback_frame():
    """The frame of DTensor's all-to-all fallback that this op runs in, or
    None."""
    frame = sys._getframe(2)
    while frame is not None and frame.f_code.co_name != _ALLTOALL_FALLBACK:
        frame = frame.f_back
    return frame


def _on_stack(target) -> bool:
    frame = sys._getframe(2)
    while frame is not None and frame is not target:
        frame = frame.f_back
    return frame is not None


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost, argument_keys: set):
        super().__init__()
        self.cost = cost
        self.known = set(argument_keys)  # storages that are not temps
        self.live: dict = {}
        self.fallback = None  # the frame of DTensor's all-to-all fallback, while it runs
        self.current = 0
        self.peak = 0
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry

        self.fake, self.flop_registry = FakeTensor, flop_registry

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def track(self, t: torch.Tensor, nbytes=None) -> None:
        """Hold ``t``'s storage (``nbytes`` of it, default all) until freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.live:
            return
        self.live[key] = st.nbytes() if nbytes is None else nbytes
        self.current += self.live[key]
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [x for x in tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)]
        if any(isinstance(x, DTensor) for x in ins):
            return NotImplemented  # DTensor dispatches; its local ops come back here
        out = func(*args, **kwargs)
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if any(isinstance(x, self.fake) for x in ins + outs):
            return out  # DTensor's sharding propagation on global shapes
        c = self.cost
        if self.fallback is not None:
            if _on_stack(self.fallback):
                return out
            self.fallback = None
        kind = _kind(func)
        if kind == "all-gather":
            self.fallback = _alltoall_fallback_frame()
            if self.fallback is not None:
                # NCCL's all-to-all writes the input's size: the gathered
                # tensor and its chunking exist only on a CPU group, so the
                # ops up to the fallback's return are neither held nor
                # counted, and its result is held from its first use
                kind, outs = "all-to-all", ins
        c.ops += 1
        for t in ins:  # an input not seen yet: a fallback's result, a view of its gather
            self.track(t, _nbytes(t))
        for t in outs:
            self.track(t)
        if kind is not None:
            result = sum(_nbytes(t) for t in outs)
            c.collectives[kind] = c.collectives.get(kind, 0.0) + result
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            c.link_bytes["nvlink" if _group_size(args) <= NODE_GPUS else "network"] += result
        flop_fn = self.flop_registry.get(func.overloadpacket)
        if flop_fn is not None:
            flops = flop_fn(*args, **kwargs, out_val=out)
            if outs and outs[0].dtype in LOW_PRECISION:
                c.flops_bf16 += flops
            else:
                c.flops_f32 += flops
        if func._schema.name.split("::")[-1] not in _FREE_OPS and not _is_view(func):
            c.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def _storage_keys(tensors, *, held=False) -> dict:
    """Storage -> bytes: the storage's size, or with ``held`` the bytes its
    tensors hold (a placed arg's local shard can be a view of a whole
    tensor's storage, of which a rank keeps only the shard)."""
    out: dict = {}
    for t in tensors:
        key = t.untyped_storage()._cdata
        n = _nbytes(t) if held else t.untyped_storage().nbytes()
        out[key] = max(out.get(key, 0), n)
    return out


def count_ops(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, this rank's ``OpCost``) of one run. The
    args are meta tensors or meta DTensors (``cells.build_cell``); a run on
    another device is counted the same way, but its time and memory are
    spent."""
    arg_storages = _storage_keys(_tensors((args, kwargs)), held=True)
    cost = OpCost(argument_bytes=int(sum(arg_storages.values())))
    counter = _Counter(cost, set(arg_storages))
    with counter:
        result = fn(*args, **kwargs)
    outputs = {k: n for k, n in _storage_keys(_tensors(result)).items() if k in counter.live}
    cost.output_bytes = int(sum(outputs.values()))
    cost.peak_bytes = int(cost.argument_bytes + counter.peak)
    cost.temp_bytes = int(cost.peak_bytes - cost.argument_bytes - cost.output_bytes)
    return result, cost

"""The device mesh of the sharded paths (port of ``repro/compat.py``).

The reference routes JAX's distribution APIs through one module
(``shard_map``, ``make_mesh``, ``use_mesh``): one controller drives every
device of the mesh, and a sharded function sees the whole ``(S, ...)``
array of an axis of S shards. PyTorch has no ``shard_map``, and this module
has no alias of it. Every sharded function of the port takes and returns a
**local stack** instead: the leading ``(S_loc, ...)`` slice of the
reference's ``(S, ...)`` arrays that this process holds, starting at shard
``shard_offset``. It loops over its local shards itself and reaches the
others through the mesh's three primitives over one axis:

  ``all_gather(local)``       -> the whole ``(S, ...)`` stack;
  ``ppermute(local, shift)``  -> shard s receives shard s - shift's slice
                                 (the ring of ``dist/pipeline.py``);
  ``psum(local)``             -> the sum over the S shards, broadcast back
                                 to ``(S_loc, ...)``.

Two backings, one design:

* **single process** (``group=None`` and no initialised
  ``torch.distributed``): every shard lives on ``mesh.device`` and
  ``S_loc == S``, so a local stack is the reference's whole array. This is
  the counterpart of the reference's forced host devices, and the way one
  card runs S = 8. ``all_gather`` is the identity, ``ppermute`` a roll of
  the stack, ``psum`` a sum over axis 0, broadcast back.
* **process group** (``group`` given, or ``torch.distributed``
  initialised): the mesh has one axis, whose S shards are split evenly
  over the group's W ranks (W must divide S); rank r holds shards
  ``[r*S/W, (r+1)*S/W)`` on its own device. The primitives are
  ``torch.distributed`` collectives (NCCL on the card, gloo on the CPU):
  the list form of ``all_gather``, ``all_reduce``, and
  ``batch_isend_irecv`` for the ring.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from repro_torch.runtime.validate import SpgemmConfigError

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


class Mesh:
    """Named axes over shards held as local stacks (see the module docstring).

    ``shape`` maps each axis name to its shard count, as JAX's
    ``mesh.shape`` does; ``axis_shapes`` is the same as a tuple. Under a
    process group the mesh has one axis and ``S_loc``/``shard_offset`` say
    which of its shards this rank holds; in one process ``S_loc`` is the
    whole first axis and ``shard_offset`` 0.
    """

    def __init__(self, axis_shapes, axis_names, device, group=None):
        axis_shapes = tuple(int(s) for s in axis_shapes)
        axis_names = tuple(axis_names)
        if len(axis_shapes) != len(axis_names) or not axis_names:
            raise SpgemmConfigError(
                f"axis_shapes {axis_shapes} and axis_names {axis_names} must "
                f"be non-empty and of one length")
        if any(s < 1 for s in axis_shapes):
            raise SpgemmConfigError(f"every axis needs at least one shard, got {axis_shapes}")
        self.axis_names = axis_names
        self.axis_shapes = axis_shapes
        self.shape = dict(zip(axis_names, axis_shapes))
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            if len(axis_names) != 1:
                raise SpgemmConfigError(
                    f"a process-group mesh has one axis, got {axis_names}")
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            if axis_shapes[0] % self.world:
                raise SpgemmConfigError(
                    f"world size {self.world} does not divide the {axis_shapes[0]} "
                    f"shards of axis {axis_names[0]!r}")
        self.S_loc = axis_shapes[0] // self.world
        self.shard_offset = self.rank * self.S_loc

    def __repr__(self) -> str:
        backing = "single process" if self.group is None else f"rank {self.rank}/{self.world}"
        return f"Mesh({self.shape}, device={self.device}, {backing})"

    def _axis(self, axis: str | None) -> str:
        if axis is None:
            return self.axis_names[0]
        if axis not in self.shape:
            raise SpgemmConfigError(f"mesh has no axis {axis!r}; axes {self.axis_names}")
        return axis

    def local_shards(self, axis: str | None = None) -> tuple[int, int]:
        """(first shard, count) of ``axis`` held by this process."""
        axis = self._axis(axis)
        if self.group is None:
            return 0, self.shape[axis]
        return self.shard_offset, self.S_loc

    def local(self, x, axis: str | None = None):
        """This process's slice of a whole ``(S, ...)`` stack; a local stack
        passes through. (Host arrays and tensors alike.)"""
        axis = self._axis(axis)
        first, count = self.local_shards(axis)
        if x.shape[0] == count:
            return x
        if x.shape[0] != self.shape[axis]:
            raise SpgemmConfigError(
                f"leading dim {x.shape[0]} is neither the {self.shape[axis]} shards "
                f"of axis {axis!r} nor this process's {count}")
        return x[first:first + count]

    def _check_local(self, local: torch.Tensor, axis: str) -> None:
        count = self.local_shards(axis)[1]
        if local.ndim == 0 or local.shape[0] != count:
            raise SpgemmConfigError(
                f"a local stack of axis {axis!r} has {count} rows, got shape "
                f"{tuple(local.shape)}")

    def all_gather(self, local: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """The whole ``(S, ...)`` stack from every process's ``(S_loc, ...)``."""
        axis = self._axis(axis)
        self._check_local(local, axis)
        if self.group is None:
            return local
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(parts, local, group=self.group)
        return torch.cat(parts)

    def psum(self, local: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """The sum over all S shards, as ``(S_loc, ...)`` (every row equal)."""
        axis = self._axis(axis)
        self._check_local(local, axis)
        total = local.sum(0, keepdim=True)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        return total.expand_as(local).clone()

    def ppermute(self, local: torch.Tensor, shift: int = 1,
                 axis: str | None = None) -> torch.Tensor:
        """Ring shift: shard s's new slice is shard (s - shift) mod S's."""
        axis = self._axis(axis)
        self._check_local(local, axis)
        n = self.shape[axis]
        if self.group is None:
            return torch.roll(local, shifts=shift, dims=0)
        out = torch.empty_like(local)
        ops = []
        first = self.shard_offset
        ranks = dist.get_process_group_ranks(self.group)
        # pairs of ranks match their messages in the order issued: a rank's
        # shards go out, and come in, in increasing shard order
        for i in range(self.S_loc):
            dst = (first + i + shift) % n
            src = (first + i - shift) % n
            if dst // self.S_loc != self.rank:
                ops.append(dist.P2POp(dist.isend, local[i].contiguous(),
                                      ranks[dst // self.S_loc], group=self.group))
            if src // self.S_loc == self.rank:
                out[i] = local[src - first]
            else:
                ops.append(dist.P2POp(dist.irecv, out[i], ranks[src // self.S_loc],
                                      group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


def make_mesh(axis_shapes, axis_names, *, device=None, group=None) -> Mesh:
    """A mesh of ``axis_shapes`` shards over ``axis_names``.

    ``group=None`` with ``torch.distributed`` uninitialised gives the
    single-process backing on ``device`` (default: the current CUDA card);
    a ``group``, or an initialised default group, gives the process-group
    backing, ``device`` then defaulting to the rank's CUDA card under NCCL
    and the CPU under gloo.
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if device is None:
        if group is not None and dist.get_backend(group) != "nccl":
            device = "cpu"
        else:
            device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis_shapes, axis_names, device, group)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Bind ``mesh`` as the default mesh (``current_mesh``) inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Mesh | None:
    """The mesh bound by the innermost ``use_mesh``, or None."""
    return _MESH.get()

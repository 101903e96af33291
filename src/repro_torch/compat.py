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

The LM substrate's data x model mesh is a sibling class, ``DTensorMesh``
(``make_device_mesh``), not a third backing of ``Mesh``: one shard a rank
over a ``torch.distributed.device_mesh.DeviceMesh``, its tensors DTensors
whose placements come from the reference's ``PartitionSpec``-like specs
(``spec_placements``). The two meshes move data differently (local stacks
and three primitives against DTensor redistributions), and ``Mesh``'s
single-process multi-axis form stays what ``dist/`` uses, so one class with
both meanings would branch in every method. Both have ``shape`` (axis name
-> size), ``axis_names`` and ``axis_shapes``; ``AbstractMesh`` has only
those (JAX's ``AbstractMesh``: axis names and sizes, no devices), enough to
resolve rules and specs for a mesh that is not built.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed import tensor as dtensor
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

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


# --------------------------------------------------------------------------
# the data x model mesh: one shard a rank, DTensor placements
# --------------------------------------------------------------------------


def spec_placements(spec, axis_names, axis_sizes) -> tuple:
    """The DTensor placements, one a mesh dim, of a spec tuple (entry for
    entry the reference's ``PartitionSpec``: ``None`` or ``()`` replicated,
    an axis name, or a tuple of names for a dim split over several axes).

    A dim split over several axes takes ``Shard(dim)`` on each of their mesh
    dims; DTensor splits such a dim over its mesh dims left to right, so the
    names must come in mesh order (JAX's major-to-minor order). An unknown
    axis, an axis named twice, or names out of mesh order raise
    ``SpgemmConfigError``. An axis of one shard (``axis_sizes``, one a
    name) takes ``Replicate()``, the same layout (DTensor's view refuses to
    merge a dim sharded over one shard, as an einsum does at decode's
    T = 1)."""
    axis_names = tuple(axis_names)
    out = [Replicate()] * len(axis_names)
    for dim, entry in enumerate(spec):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for name in names:
            if name not in axis_names:
                raise SpgemmConfigError(f"spec {spec!r} names {name!r}, not an axis of "
                                        f"{axis_names}")
            i = axis_names.index(name)
            if isinstance(out[i], Shard):
                raise SpgemmConfigError(f"spec {spec!r} names axis {name!r} twice")
            out[i] = Shard(dim)
            idx.append(i)
        if idx != sorted(idx):
            raise SpgemmConfigError(
                f"spec {spec!r} splits dim {dim} over {names}, out of the mesh's order "
                f"{axis_names}")
    return tuple(Replicate() if n == 1 else q for q, n in zip(out, axis_sizes))


class AbstractMesh:
    """Axis names and sizes, no devices: what ``rules_for_mesh`` and
    ``spec_placements`` need."""

    def __init__(self, axis_shapes, axis_names):
        axis_shapes = tuple(int(s) for s in axis_shapes)
        axis_names = tuple(axis_names)
        if len(axis_shapes) != len(axis_names) or not axis_names:
            raise SpgemmConfigError(
                f"axis_shapes {axis_shapes} and axis_names {axis_names} must be non-empty "
                f"and of one length")
        if any(s < 1 for s in axis_shapes) or len(set(axis_names)) != len(axis_names):
            raise SpgemmConfigError(
                f"every axis needs a distinct name and at least one shard, got "
                f"{axis_names} {axis_shapes}")
        self.axis_names = axis_names
        self.axis_shapes = axis_shapes
        self.shape = dict(zip(axis_names, axis_shapes))
        self.size = math.prod(axis_shapes)

    def placements(self, spec) -> tuple:
        return spec_placements(spec, self.axis_names, self.axis_shapes)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class DTensorMesh(AbstractMesh):
    """A mesh of one shard a rank over a ``DeviceMesh`` with the same axis
    names (``device_mesh``), on this rank's ``device``."""

    def __init__(self, axis_shapes, axis_names, device_mesh, device):
        super().__init__(axis_shapes, axis_names)
        self.device_mesh = device_mesh
        self.device = torch.device(device)

    def distribute(self, x: torch.Tensor, spec):
        """``x`` (the whole tensor, the same on every rank) as a DTensor at
        ``spec``: each rank keeps its slice, nothing is sent (the port's
        ``jax.device_put`` with a ``NamedSharding``)."""
        if len(spec) > x.ndim:
            raise SpgemmConfigError(f"spec {spec!r} has more entries than the {x.ndim} dims "
                                    f"of a {tuple(x.shape)} tensor")
        return distribute_tensor(x.detach().to(self.device), self.device_mesh,
                                 self.placements(spec), src_data_rank=None)

    def zeros(self, shape, spec, dtype=torch.float32):
        """A zero DTensor of global ``shape`` at ``spec``, each rank
        allocating its slice only (on a ``meta`` mesh nothing is
        allocated)."""
        if self.device.type == "meta":
            return self.distribute(torch.zeros(tuple(shape), dtype=dtype, device="meta"), spec)
        return dtensor.zeros(tuple(shape), dtype=dtype, device_mesh=self.device_mesh,
                        placements=self.placements(spec))

    def local_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.device_mesh.get_local_rank(axis)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DTensorMesh`` (JAX's ``NamedSharding``): what
    ``ckpt.restore(shardings=)`` and ``models.place`` take a leaf to."""

    mesh: DTensorMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        return self.mesh.placements(self.spec)


def make_device_mesh(axis_shapes, axis_names, *, device=None) -> DTensorMesh:
    """The data x model mesh: a ``DeviceMesh`` of ``axis_shapes`` over the
    initialised default process group, one rank a shard (NCCL: the card;
    gloo: the CPU). Raises ``SpgemmConfigError`` without a process group or
    when the world size is not the product of the axes.

    ``device="meta"`` keeps the mesh's tensors on the ``meta`` device (a
    ``"cpu"`` ``DeviceMesh``, under any CPU backend): the dry run's mesh
    under the fake process group, where nothing is allocated or sent."""
    from torch.distributed.device_mesh import init_device_mesh

    axis_shapes, axis_names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    size = AbstractMesh(axis_shapes, axis_names).size  # and the shape checks
    if not (dist.is_available() and dist.is_initialized()):
        raise SpgemmConfigError(
            f"a {axis_shapes} {axis_names} mesh needs an initialised torch.distributed "
            f"process group of {size} ranks, one a shard")
    world = dist.get_world_size()
    if world != size:
        raise SpgemmConfigError(
            f"world size {world} is not the {size} shards of the {axis_shapes} "
            f"{axis_names} mesh")
    if dist.get_backend() == "nccl":
        device_type, own = "cuda", torch.device("cuda", torch.cuda.current_device())
    else:
        device_type, own = "cpu", torch.device("cpu")
    if device is not None:
        if torch.device(device).type != "meta" or device_type != "cpu":
            raise SpgemmConfigError(f"device={device!r}: a mesh's device is its group's, or "
                                    f"'meta' under a CPU group (gloo, fake)")
        own = torch.device("meta")
    dm = init_device_mesh(device_type, axis_shapes, mesh_dim_names=axis_names)
    return DTensorMesh(axis_shapes, axis_names, dm, own)


def local_range(x, dim: int) -> tuple:
    """(first index, count) of ``x``'s dim ``dim`` that this rank holds, for
    a DTensor ``x``: the mesh dims sharding ``dim`` split it in mesh order,
    each into ``torch.chunk``'s pieces (DTensor's own rule)."""
    first, count = 0, x.shape[dim]
    coord = x.device_mesh.get_coordinate()
    for mdim, placement in enumerate(x.placements):
        if isinstance(placement, Shard) and placement.dim == dim:
            n = x.device_mesh.size(mdim)
            chunk = -(-count // n)
            start = min(coord[mdim] * chunk, count)
            first, count = first + start, min(chunk, count - start)
    return first, count


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor the same on every rank (a position, a mask, a zero
    accumulator, made from shapes alone), as a replicated DTensor on
    ``like``'s mesh when ``like`` is a DTensor (nothing is sent); beside a
    plain tensor, ``t`` as it is."""
    if isinstance(like, DTensor):
        return DTensor.from_local(t, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                                  run_check=False)
    return t


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as the whole tensor on every rank (a collective); a plain
    tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x

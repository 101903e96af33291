"""Production mesh construction (spec'd shapes) + sharding-rule factory (port
of ``repro/launch/mesh.py``).

``make_production_mesh`` is a function, so importing this module builds
nothing. The data x model meshes are ``compat.DTensorMesh``es: one rank a
shard, over the initialised default process group (``make_device_mesh``
raises without one, or when the world size is not the product of the
axes). ``make_data_mesh`` is the sharded SpGEMM's one-axis mesh of local
stacks (``compat.make_mesh``). ``rules_for_mesh`` and ``dp_size`` read only
``shape`` and ``axis_names``, so they also take a ``compat.AbstractMesh``
of a mesh that is not built (``production_mesh_shape``).
"""
from __future__ import annotations

from repro_torch.compat import make_device_mesh, make_mesh
from repro_torch.models.sharding import ShardingRules

DP_AXES = ("pod", "data")


def production_mesh_shape(*, multi_pod: bool = False) -> tuple:
    """(axis sizes, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16 x 16 (2 x 16 x 16) mesh; ``device="meta"`` under the dry run's
    fake process group (``compat.make_device_mesh``)."""
    return make_device_mesh(*production_mesh_shape(multi_pod=multi_pod), device=device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *, device=None):
    """Small mesh for the 8-rank tests (and ``(1, 1)`` on one card)."""
    return make_device_mesh(shape, axes, device=device)


def make_data_mesh(num_devices: int | None = None, axis: str = "data", *, device=None):
    """1-D mesh of ``num_devices`` local-stack shards (default: the process
    group's world size, else 1) for sharded SpGEMM: the decomposition
    ``repro_torch.dist`` and ``spgemm(..., mesh=...)`` expect."""
    import torch.distributed as dist

    if num_devices is None:
        num_devices = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh((num_devices,), (axis,), device=device)


def rules_for_mesh(mesh) -> ShardingRules:
    names = mesh.axis_names
    if "model" in names:
        tp_axis = "model"
        tp_size = mesh.shape["model"]
    else:
        tp_axis, tp_size = None, 1
    dp_axes = tuple(n for n in names if n in DP_AXES)
    return ShardingRules(
        dp_axes=dp_axes or ("data",),
        tp_axis=tp_axis,
        tp_size=tp_size,
        dp_size=dp_size(mesh),
        enabled=True,
    )


def dp_size(mesh) -> int:
    out = 1
    for n in mesh.axis_names:
        if n in DP_AXES:
            out *= mesh.shape[n]
    return out

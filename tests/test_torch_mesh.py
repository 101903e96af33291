"""The port's data x model mesh in one process: ``launch/mesh.py``'s rules
against the reference's, and the one helper that turns specs into DTensor
placements (``compat.spec_placements``), on the production mesh shapes
(16, 16) and (2, 16, 16), built from their shapes alone
(``compat.AbstractMesh``; the reference's side on ``jax.sharding.AbstractMesh``,
which needs no devices).

For every architecture, every leaf of ``param_shardings``, of
``cache_shardings`` (both ``long_context`` values) and of ``zero1_shardings``
turns into placements, one a mesh dim, that shard each dim over exactly the
axes its spec names (in mesh order), and the dim divides by them. The typed
errors: a spec out of mesh order, an unknown or doubled axis, a data x model
mesh without a process group, or over a group of the wrong world size.
The 2 x 4 mesh itself runs in ``tests/test_torch_mesh_pg.py``.
"""
import dataclasses
import math

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro.launch.mesh as jmesh
import repro.models as jm
from repro.configs import get_config as j_get_config
from repro.train import optim as joptim
import repro_torch.models as tm
from repro_torch import _tree, compat
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.train import zero1_shardings

from torch_lm_common import one_rank_mesh

SHAPES = {"16x16": False, "2x16x16": True}
CAUSAL = [a for a in ARCH_IDS if get_config(a).causal]  # hubert, an encoder, has no cache


def _meshes(multi_pod: bool):
    shape, names = tmesh.production_mesh_shape(multi_pod=multi_pod)
    return compat.AbstractMesh(shape, names), jax.sharding.AbstractMesh(shape, names)


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _check(mesh, spec, shape, what):
    """The placements of ``spec`` shard each dim over the axes it names, in
    mesh order, and the dim divides by their sizes."""
    got = mesh.placements(spec)
    assert len(got) == len(mesh.axis_names), what
    for i, name in enumerate(mesh.axis_names):
        dims = [d for d, entry in enumerate(spec) if name in _axes(entry)]
        assert got[i] == (Shard(dims[0]) if dims else Replicate()), (what, spec, got)
    for d, entry in enumerate(spec):
        names = _axes(entry)
        assert list(names) == sorted(names, key=mesh.axis_names.index), (what, spec)
        assert shape[d] % math.prod(mesh.shape[n] for n in names) == 0, (what, spec, shape)


def _spec_leaves(specs, like) -> list:
    out = []
    _tree.map_specs(lambda spec, leaf: out.append((spec, tuple(leaf.shape))), specs, like)
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_rules_and_dp_size_are_the_references(shape):
    mesh, jmesh_ = _meshes(SHAPES[shape])
    assert dataclasses.asdict(tmesh.rules_for_mesh(mesh)) == dataclasses.asdict(
        jmesh.rules_for_mesh(jmesh_))
    assert tmesh.dp_size(mesh) == jmesh.dp_size(jmesh_) == mesh.size // 16


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_turn_into_placements(arch, shape):
    mesh, jmesh_ = _meshes(SHAPES[shape])
    rules, cfg = tmesh.rules_for_mesh(mesh), get_config(arch)
    specs = tm.param_shardings(cfg, rules)
    want = jm.param_shardings(j_get_config(arch), jmesh.rules_for_mesh(jmesh_))
    assert jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)) \
        == specs
    leaves = _spec_leaves(specs, tm.param_specs(cfg, rules))
    assert len(leaves) == len(jax.tree.leaves(tm.param_specs(cfg, rules)))
    for spec, leaf_shape in leaves:
        _check(mesh, spec, leaf_shape, arch)


@pytest.mark.parametrize("long_context", (False, True))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", CAUSAL)
def test_cache_specs_turn_into_placements(arch, shape, long_context):
    mesh, _ = _meshes(SHAPES[shape])
    rules, cfg = tmesh.rules_for_mesh(mesh), get_config(arch)
    batch = 1 if long_context else 2 * tmesh.dp_size(mesh)
    specs = tm.cache_shardings(cfg, rules, batch, 32_768, long_context=long_context)
    for spec, leaf_shape in _spec_leaves(specs, tm.cache_template(cfg, batch, 32_768)):
        _check(mesh, spec, leaf_shape, arch)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_specs_turn_into_placements(arch, shape):
    mesh, jmesh_ = _meshes(SHAPES[shape])
    rules, cfg = tmesh.rules_for_mesh(mesh), get_config(arch)
    like = tm.param_specs(cfg, rules)
    specs = zero1_shardings(tm.param_shardings(cfg, rules), rules.dp_axes, mesh.shape, like)
    jrules = jmesh.rules_for_mesh(jmesh_)
    want = joptim.zero1_shardings(jm.param_shardings(j_get_config(arch), jrules),
                                  jrules.dp_axes, dict(jmesh_.shape),
                                  jm.param_specs(j_get_config(arch), jrules))
    assert jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)) \
        == specs
    for spec, leaf_shape in _spec_leaves(specs, like):
        _check(mesh, spec, leaf_shape, arch)


def test_spec_placements_rules_and_typed_errors():
    names = ("pod", "data", "model")
    sizes = (2, 16, 16)
    assert compat.spec_placements((("pod", "data"), None, "model"), names, sizes) == (
        Shard(0), Shard(0), Shard(2))
    assert compat.spec_placements(((), None), names, sizes) == (Replicate(),) * 3
    # an axis of one shard: Replicate, the same layout
    assert compat.spec_placements(("data", "model"), names, (2, 1, 4)) == (
        Replicate(), Replicate(), Shard(1))
    for bad in ((("data", "pod"), None), ("data", "data"), ("expert",)):
        with pytest.raises(SpgemmConfigError):
            compat.spec_placements(bad, names, sizes)
    with pytest.raises(SpgemmConfigError):
        compat.AbstractMesh((2, 4), ("data",))


def test_a_data_x_model_mesh_needs_its_process_group(tmp_path):
    with pytest.raises(SpgemmConfigError, match="process group"):
        tmesh.make_test_mesh((2, 4))
    with pytest.raises(SpgemmConfigError, match="process group"):
        tmesh.make_production_mesh()
    with one_rank_mesh(tmp_path) as mesh:
        assert isinstance(mesh, compat.DTensorMesh) and mesh.shape == {"data": 1, "model": 1}
        assert mesh.device_mesh.mesh_dim_names == ("data", "model")
        for shape in ((2, 4), (1, 2)):
            with pytest.raises(SpgemmConfigError, match="world size 1"):
                tmesh.make_test_mesh(shape)
        # the sharded SpGEMM's mesh stays the local-stack one
        data = tmesh.make_data_mesh(device="cpu")
        assert isinstance(data, compat.Mesh) and data.shape == {"data": 1}
        x = torch.arange(12.0).view(3, 4)
        placed = mesh.distribute(x, ("data", "model"))
        assert torch.equal(placed.full_tensor(), x)
        with pytest.raises(SpgemmConfigError):
            mesh.distribute(x, ("data", None, None))
        with pytest.raises(SpgemmConfigError, match="data x model mesh"):
            tm.place({"x": x}, {"x": (None, None)}, data)


def test_a_plain_tensor_meeting_the_mesh_raises(tmp_path):
    """No implicit replication: a plain tensor that meets a DTensor in a
    model path raises (DTensor's own check), and the constants the model
    paths make from shapes are placed explicitly (``compat.replicated``),
    giving the plain path's values."""
    from repro_torch.models.layers import rope

    x = torch.randn(2, 4, 3, 8, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(4, dtype=torch.int32)
    assert compat.replicated(pos, x) is pos
    with one_rank_mesh(tmp_path) as mesh:
        xd = mesh.distribute(x, ("data", None, "model", None))
        with pytest.raises(RuntimeError, match="mixed torch.Tensor and DTensor"):
            rope(xd, pos, 10_000.0)
        placed = compat.replicated(pos, xd)
        assert tuple(placed.placements) == (Replicate(), Replicate())
        assert torch.equal(rope(xd, placed, 10_000.0).full_tensor(), rope(x, pos, 10_000.0))

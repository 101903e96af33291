"""Launchers and the dry run (port of ``repro/launch``): ``python -m
repro_torch.launch.train``; the meshes and sharding rules of ``mesh.py``;
the dry-run tooling, which needs no card: ``cells`` builds each
(arch x shape) cell on meta DTensors, ``op_cost`` counts one rank's flops,
bytes, collectives and peak memory of one run (the reference's
``hlo_cost``), ``roofline`` turns them into H100 terms and holds the LM
paths' bounds, ``python -m repro_torch.launch.dryrun`` surveys every cell
under a fake process group, ``reanalyze`` re-derives the terms from saved
counts and ``report`` renders the tables.

The submodules import the models and the training path; importing the
package imports none of them (``from repro_torch.launch import roofline``
imports one)."""

__all__ = ["cells", "dryrun", "mesh", "op_cost", "reanalyze", "report", "roofline", "train"]

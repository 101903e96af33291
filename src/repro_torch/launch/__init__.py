"""Launchers (port of ``repro/launch``): ``python -m
repro_torch.launch.train``, and the meshes and sharding rules of
``launch/mesh.py``. The reference's dry-run tooling is not ported yet."""

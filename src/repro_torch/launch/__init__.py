"""Launchers (port of ``repro/launch``): ``python -m
repro_torch.launch.train``. The reference's dry-run tooling is not ported
yet."""

"""Checkpoints (port of ``repro.ckpt``) in the reference's on-disk layout."""
from repro_torch.ckpt.checkpoint import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]

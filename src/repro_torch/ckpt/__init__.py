"""Atomic, elastic checkpoints in the reference's format."""
from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]

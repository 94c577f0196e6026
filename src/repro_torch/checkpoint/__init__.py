"""Checkpoints with bloom-clock lineage: ``CheckpointManager``."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]

"""Checkpointing of the port."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]

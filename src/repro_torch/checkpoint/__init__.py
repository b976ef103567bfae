"""Checkpointing with async saves, in the reference's on-disk format."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]

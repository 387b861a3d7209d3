"""Checkpoints with atomic publish and sha256 integrity (port of
``repro.checkpoint``)."""
from .manager import (CheckpointManager, CorruptCheckpointError,
                      load_manifest, restore_tree, save_tree)

__all__ = ["CheckpointManager", "CorruptCheckpointError", "load_manifest",
           "restore_tree", "save_tree"]

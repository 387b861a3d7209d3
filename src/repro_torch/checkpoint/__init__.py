"""Checkpoints with atomic publish and sha256 integrity, and the ZeRO
shard remap codec for data-parallel degree changes (port of
``repro.checkpoint``)."""
from .manager import (CheckpointManager, CorruptCheckpointError,
                      load_manifest, restore_tree, save_tree)
from .reshard import (ReshardError, remap_shards, reshard_tree,
                      shard_leaf, shard_tree, unshard_leaf, unshard_tree)

__all__ = ["CheckpointManager", "CorruptCheckpointError", "ReshardError",
           "load_manifest", "remap_shards", "reshard_tree",
           "restore_tree", "save_tree", "shard_leaf", "shard_tree",
           "unshard_leaf", "unshard_tree"]

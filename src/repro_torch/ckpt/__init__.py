"""Checkpoints in the JAX package's on-disk layout, with async save and
retention."""
from .checkpoint import CheckpointManager, clean_stale_tmp, latest_step, restore_tree, save_tree

__all__ = ["CheckpointManager", "save_tree", "restore_tree", "latest_step", "clean_stale_tmp"]

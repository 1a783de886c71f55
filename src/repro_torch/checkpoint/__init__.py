"""Checkpoint directories shared with the JAX package (``step_<n>/``
manifest + ``.npz``): atomic save, restore by path, async save, retention."""
from .store import (CheckpointManager, check_leaves_compat, latest_step,
                    restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "check_leaves_compat", "latest_step",
           "restore_pytree", "save_pytree"]

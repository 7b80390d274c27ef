"""Checkpoints of the port's train state, in the JAX manager's format."""

from repro_torch.checkpoint.manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]

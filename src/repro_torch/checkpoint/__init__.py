"""Checkpointing of the port (``repro.checkpoint``): step-indexed npz
snapshots of tensor trees, in the JAX package's file format."""
from repro_torch.checkpoint.npz import CheckpointManager

__all__ = ["CheckpointManager"]

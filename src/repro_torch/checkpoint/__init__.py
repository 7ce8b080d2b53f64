"""Fault-tolerant checkpointing: atomic npy files + manifest + checksums,
async save, keep-last-k — the JAX package's ``repro.checkpoint`` for trees
of tensors."""
from .store import CheckpointManager, latest_step, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint", "latest_step"]

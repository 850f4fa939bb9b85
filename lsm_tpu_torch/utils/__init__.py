"""Checkpointing."""

from .checkpoint import save_checkpoint, load_checkpoint

"""Checkpointing."""

"""Checkpointing, step monitoring and profiling."""

from .checkpoint import save_checkpoint, load_checkpoint
from .profiling import StepMonitor, trace, timed

"""Stencils, the padded layout and the CUDA kernel wrappers."""

from . import stencils

"""Shapes, velocity fields and the canonical benchmark configurations."""

from . import shapes
from . import benchmarks

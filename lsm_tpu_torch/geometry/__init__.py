"""Geometric queries and the implicit-domain quadrature."""

from .queries import (
    volume, perimeter, curvature, gradient, grad_norm, normal, hessian,
    union, intersection, complement, difference, smooth_heaviside, smooth_delta,
)
from .quadrature import quadrature, integrate, cell_quadrature

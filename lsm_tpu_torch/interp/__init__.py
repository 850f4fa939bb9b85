"""Continuous fields: Bernstein interpolation and the Newton signed distance."""

from .bernstein import (
    bernstein_basis, bernstein_eval, bernstein_value_grad, bernstein_value_grad_hess,
    bernstein_derivative, bernstein_bounds, bernstein_split, bernstein_face,
)
from .interpolation import InterpolatedField, interpolation_matrix
from .sdf import NewtonSDF, reinitialize_newton, hausdorff_distance

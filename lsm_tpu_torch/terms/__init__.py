"""Hamilton-Jacobi terms."""

from .terms import (
    AdvectionTerm, NormalMotionTerm, CurvatureTerm, EikonalReinitializationTerm,
    compute_cfl, total_rhs, update_terms,
)

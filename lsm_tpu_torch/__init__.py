"""lsm_tpu_torch — the PyTorch + CUDA port of :mod:`lsm_tpu`.

A second package beside the JAX one, with the same layout (``core``, ``ops``,
``terms``, ``integrators``, ``geometry``, ``reinit``, ``models``, ``utils``)
and the same semantics. Plain tensor code is PyTorch; each TPU kernel on a
ported path is a hand-written CUDA kernel for Hopper (``csrc/``, built with
nvcc on first use).

The ported slices are the dense 3D WENO5 advection path (``Grid``, BCs,
``MeshField`` / ``sample``, ``AdvectionTerm``, FE/RK2/RK3, and
``LevelSetEquation.integrate``, which on a CUDA state runs the fused stepper
through the stage kernel K1 and the ghost-refresh kernel K2) and its
gradient: ``rollout`` differentiates through the same stepper, whose
backward runs the ghost-cotangent fold K4, the stage adjoint K3 (one
advection term) or K3' (any other term list) and the shell zeroing K5; the
narrow band: ``integrate`` on a ``NarrowBandField`` runs the band stepper,
whose cost follows the interface, through the active-tile stage K6, the
gated shell refresh K7 and the incremental re-tube K8 (``last_fast_path ==
"band"``), and ``rollout`` differentiates through it (the backward is
autograd of the plain band composite, as JAX's is ``jax.vjp`` of its own);
the other term kinds: ``NormalMotionTerm``, ``CurvatureTerm`` and
``EikonalReinitializationTerm``, and any sum of terms, through the same K1
and K6; the general path and 2D fields: hooks, ``fast="off"`` and the term
lists the steppers do not take run the WENO5 advection stage through K10
(3D) and K11 (2D), a dense 2D field rides K1 and K2 as ``(1, n0, n1)``;
``reinitialize`` (PDE reinitialization), ``extend_along_normals`` and the
geometric queries and CSG in plain torch; and ``models.benchmarks``, the
canonical configurations 1 to 5 (configuration 5: shape optimisation
through a band rollout); and the sharded paths (:mod:`lsm_tpu_torch.parallel`:
an in-process mesh of torch devices, the halo exchange, the sharded general
and fused evolutions with the shell writer K9, the differentiable sharded
rollout); ``SemiImplicitI2OE`` (a matrix-free BiCGStab step, plain torch,
differentiable), ``InterpolatedField`` (piecewise Bernstein patches, eager
or lazy), ``NewtonSDF``, ``reinitialize_newton`` and ``hausdorff_distance``
(the high-order signed distance) and ``quadrature``/``integrate`` (cut-cell
quadrature on the host): with them the port exports JAX's 46 names. An
``Extrapolation`` of any degree takes the ghost kernels (above 7 their
weight-table route). Tensors go to the card unless the caller asks for the
CPU (``device="cpu"``).
"""

from .core.grid import Grid
from .core.bc import (
    BoundaryCondition,
    Periodic,
    Extrapolation,
    Neumann,
    LinearExtrapolation,
    Symmetry,
    normalize_bcs,
)
from .core.field import MeshField, sample
from .core.narrowband import NarrowBandField
from .terms.terms import (
    AdvectionTerm,
    CurvatureTerm,
    EikonalReinitializationTerm,
    NormalMotionTerm,
    compute_cfl,
)
from .integrators.explicit import ForwardEuler, RK2, RK3, TimeIntegrator
from .integrators.semi_implicit import SemiImplicitI2OE
from .integrators.loop import evolve, rollout, step
from .equation import LevelSetEquation
from .interp.interpolation import InterpolatedField
from .interp.sdf import NewtonSDF, reinitialize_newton, hausdorff_distance
from .reinit.eikonal import reinitialize
from .reinit.velocity_extension import extend_along_normals
from .geometry.quadrature import quadrature, integrate
from .geometry.queries import (
    volume,
    perimeter,
    curvature,
    gradient,
    grad_norm,
    normal,
    hessian,
    union,
    intersection,
    complement,
    difference,
    smooth_heaviside,
    smooth_delta,
)

__version__ = "0.1.0"

__all__ = [
    "Grid",
    "BoundaryCondition",
    "Periodic",
    "Extrapolation",
    "Neumann",
    "LinearExtrapolation",
    "Symmetry",
    "normalize_bcs",
    "MeshField",
    "sample",
    "NarrowBandField",
    "AdvectionTerm",
    "NormalMotionTerm",
    "CurvatureTerm",
    "EikonalReinitializationTerm",
    "compute_cfl",
    "ForwardEuler",
    "RK2",
    "RK3",
    "SemiImplicitI2OE",
    "TimeIntegrator",
    "step",
    "evolve",
    "rollout",
    "LevelSetEquation",
    "InterpolatedField",
    "NewtonSDF",
    "reinitialize_newton",
    "hausdorff_distance",
    "reinitialize",
    "extend_along_normals",
    "quadrature",
    "integrate",
    "volume",
    "perimeter",
    "curvature",
    "gradient",
    "grad_norm",
    "normal",
    "hessian",
    "union",
    "intersection",
    "complement",
    "difference",
    "smooth_heaviside",
    "smooth_delta",
]

"""Time integrators and the fused stepper."""

from .explicit import TimeIntegrator, ForwardEuler, RK2, RK3
from .loop import evolve, rollout, step
from .semi_implicit import SemiImplicitI2OE

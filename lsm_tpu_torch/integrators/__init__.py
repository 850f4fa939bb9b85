"""Time integrators and the fused stepper."""

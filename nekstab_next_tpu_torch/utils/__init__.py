from .diagnostics import (
    BoundaryQuadrature,
    boundary_quadrature,
    periods_from_signal,
    surface_force_and_torque,
    zero_crossings,
)
from .noise import make_seed, symmetric_seed, velocity_noise

__all__ = [
    "velocity_noise",
    "symmetric_seed",
    "make_seed",
    "BoundaryQuadrature",
    "boundary_quadrature",
    "surface_force_and_torque",
    "zero_crossings",
    "periods_from_signal",
]

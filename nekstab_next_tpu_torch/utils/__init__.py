from .diagnostics import (
    BoundaryQuadrature,
    SeriesWriter,
    StepMonitor,
    boundary_quadrature,
    define_objects,
    locate_probes,
    periods_from_signal,
    probe_values,
    surface_force_and_torque,
    total_energy,
    total_enstrophy,
    zero_crossings,
)
from .noise import make_seed, symmetric_seed, velocity_noise

__all__ = [
    "velocity_noise",
    "symmetric_seed",
    "make_seed",
    "total_energy",
    "total_enstrophy",
    "BoundaryQuadrature",
    "boundary_quadrature",
    "define_objects",
    "surface_force_and_torque",
    "locate_probes",
    "probe_values",
    "zero_crossings",
    "periods_from_signal",
    "StepMonitor",
    "SeriesWriter",
]

"""Post-processing: the velocity gradient, the sensitivity maps of the
cylinder pipeline (wavemaker, base-flow sensitivity) and the steady-force
sensitivity."""

from .sensitivity import (
    bf_sensitivity,
    biorthogonalize,
    delta_forcing,
    forced_tangent_response,
    steady_force_sensitivity,
    wave_maker,
)
from .vortex import velocity_gradient

__all__ = [
    "velocity_gradient",
    "biorthogonalize",
    "wave_maker",
    "bf_sensitivity",
    "delta_forcing",
    "forced_tangent_response",
    "steady_force_sensitivity",
]

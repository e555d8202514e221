"""Post-processing: the vortex criteria (``vortex.py``), running statistics
(``stats.py``), the perturbation energy budget (``budget.py``), and the
sensitivity maps of the cylinder pipeline (wavemaker, base-flow
sensitivity) and the steady-force sensitivity (``sensitivity.py``)."""

from .budget import EnergyBudget, energy_budget
from .sensitivity import (
    bf_sensitivity,
    biorthogonalize,
    delta_forcing,
    forced_tangent_response,
    steady_force_sensitivity,
    wave_maker,
)
from .stats import RunningStats
from .vortex import (
    antisymmetric_criterion,
    delta_criterion,
    lambda2_criterion,
    omega_criterion,
    q_criterion,
    swirling_strength,
    symmetric_criterion,
    velocity_gradient,
    vorticity,
)

__all__ = [
    "velocity_gradient",
    "vorticity",
    "q_criterion",
    "lambda2_criterion",
    "delta_criterion",
    "swirling_strength",
    "omega_criterion",
    "symmetric_criterion",
    "antisymmetric_criterion",
    "RunningStats",
    "EnergyBudget",
    "energy_budget",
    "biorthogonalize",
    "wave_maker",
    "bf_sensitivity",
    "delta_forcing",
    "forced_tangent_response",
    "steady_force_sensitivity",
]

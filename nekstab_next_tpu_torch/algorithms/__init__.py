from .newton import NewtonResult, newton_krylov
from .stability import (
    StabilityResult,
    gradient_energy_norm,
    linear_stability_analysis,
    transient_growth_analysis,
    velocity_space,
)

__all__ = [
    "newton_krylov",
    "NewtonResult",
    "linear_stability_analysis",
    "transient_growth_analysis",
    "gradient_energy_norm",
    "velocity_space",
    "StabilityResult",
]

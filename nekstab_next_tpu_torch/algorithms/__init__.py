from .fixed_point import FixedPointResult, boostconv_dns, sfd, tdf
from .harmonic import HarmonicResolventResult, harmonic_resolvent_analysis
from .newton import NewtonResult, newton_krylov
from .resolvent import (
    FloquetResolventOperator,
    ResolventOperator,
    ResolventResult,
    resolvent_analysis,
)
from .stability import (
    StabilityResult,
    TransientGrowthResult,
    coupled_space,
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
    "coupled_space",
    "StabilityResult",
    "TransientGrowthResult",
    "sfd",
    "boostconv_dns",
    "tdf",
    "FixedPointResult",
    "resolvent_analysis",
    "ResolventOperator",
    "FloquetResolventOperator",
    "ResolventResult",
    "harmonic_resolvent_analysis",
    "HarmonicResolventResult",
]

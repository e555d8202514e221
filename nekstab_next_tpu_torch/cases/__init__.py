from .bfs import BackwardFacingStepCase
from .cube import CubeRoughnessCase
from .cylinder import CylinderCase
from .rayleigh_benard import (
    K_CRITICAL,
    RA_CRITICAL,
    RayleighBenardCase,
    growth_rate_freeslip,
)

__all__ = ["BackwardFacingStepCase", "CubeRoughnessCase", "CylinderCase",
           "RayleighBenardCase", "growth_rate_freeslip", "RA_CRITICAL", "K_CRITICAL"]

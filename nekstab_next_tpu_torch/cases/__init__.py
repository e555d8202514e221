from .bfs import BackwardFacingStepCase
from .cube import CubeRoughnessCase
from .cylinder import CylinderCase

__all__ = ["BackwardFacingStepCase", "CubeRoughnessCase", "CylinderCase"]

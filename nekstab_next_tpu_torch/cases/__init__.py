from .cube import CubeRoughnessCase
from .cylinder import CylinderCase

__all__ = ["CubeRoughnessCase", "CylinderCase"]

from .cylinder import CylinderCase

__all__ = ["CylinderCase"]

"""Post-processing: the velocity gradient and the sensitivity maps of the
cylinder pipeline (wavemaker, base-flow sensitivity)."""

from .sensitivity import bf_sensitivity, biorthogonalize, wave_maker
from .vortex import velocity_gradient

__all__ = ["velocity_gradient", "biorthogonalize", "wave_maker", "bf_sensitivity"]

from .state import FlowState, initial_state
from .navier_stokes import NavierStokes

__all__ = ["FlowState", "initial_state", "NavierStokes"]

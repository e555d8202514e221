from .core import SEM
from .cg import cg_solve, pcg

__all__ = ["SEM", "cg_solve", "pcg"]

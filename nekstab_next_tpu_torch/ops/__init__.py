from .core import SEM
from .core3 import SEM3
from .cg import cg_solve, pcg

__all__ = ["SEM", "SEM3", "cg_solve", "pcg"]

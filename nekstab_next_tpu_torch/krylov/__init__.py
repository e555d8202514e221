from .arnoldi import arnoldi_factorization, arnoldi_step, orthogonalize
from .gmres import gmres
from .krylov_schur import EigenResult, eigs
from .svd import SVDResult, svds, svds_normal
from .vector import Basis, VectorSpace

__all__ = [
    "VectorSpace",
    "Basis",
    "orthogonalize",
    "arnoldi_step",
    "arnoldi_factorization",
    "eigs",
    "EigenResult",
    "gmres",
    "svds",
    "svds_normal",
    "SVDResult",
]

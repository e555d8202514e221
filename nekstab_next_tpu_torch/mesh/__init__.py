from .gll import diff_matrix, gauss_points_weights, gll_points_weights, lagrange_interp_matrix
from .mesh import BoundaryCondition, Mesh2D, build_mesh
from .cylinder import cylinder_mesh

__all__ = [
    "gll_points_weights",
    "gauss_points_weights",
    "diff_matrix",
    "lagrange_interp_matrix",
    "Mesh2D",
    "BoundaryCondition",
    "build_mesh",
    "cylinder_mesh",
]

from .gll import diff_matrix, gauss_points_weights, gll_points_weights, lagrange_interp_matrix
from .mesh import BoundaryCondition, Mesh2D, build_mesh
from .box import box_mesh_2d
from .cylinder import cylinder_mesh
from .mesh3 import Mesh3D, box_mesh_3d, build_mesh_3d, face_node_indices
from .re2 import Re2Data, mesh3_from_re2, mesh_from_re2, read_re2, write_re2

__all__ = [
    "gll_points_weights",
    "gauss_points_weights",
    "diff_matrix",
    "lagrange_interp_matrix",
    "Mesh2D",
    "BoundaryCondition",
    "build_mesh",
    "box_mesh_2d",
    "cylinder_mesh",
    "Mesh3D",
    "build_mesh_3d",
    "box_mesh_3d",
    "face_node_indices",
    "Re2Data",
    "read_re2",
    "write_re2",
    "mesh_from_re2",
    "mesh3_from_re2",
]

"""Cylinder-in-crossflow O-mesh generator (numpy copy of
``nekstab_next_tpu/mesh/cylinder.py``; must stay bit-identical to it).

The flagship validation case of the reference (examples/cylinder: Re=50 base
flow, Re=60 direct modes; SURVEY.md section 6).  The reference ships a binary
``1cyl.re2`` mesh; here we generate our own curved O-mesh — an annulus of
``nr x ntheta`` elements with geometric radial grading — since the goal is to
match the *continuous* operator's eigenvalues, not Nek's mesh bit-for-bit.

Far-field boundary: Dirichlet (u = U_inf) on the upstream arc, outflow on a
downstream arc of half-angle ``outflow_half_angle`` so the wake can exit.
"""

from __future__ import annotations

import numpy as np

from .gll import gll_points_weights
from .mesh import BoundaryCondition as BC
from .mesh import Mesh2D, build_mesh


def cylinder_mesh(
    nr: int = 12,
    ntheta: int = 32,
    order: int = 6,
    radius: float = 0.5,
    outer_radius: float = 40.0,
    grading: float = 40.0,
    outflow_half_angle: float = 70.0,
) -> Mesh2D:
    """O-mesh annulus around a cylinder of ``radius`` (diameter = 1 when
    radius=0.5, matching the Re = U D / nu convention of the reference)."""
    n = order + 1
    z, _ = gll_points_weights(n)

    # radial breakpoints with geometric grading (fine at the cylinder)
    r = grading ** (1.0 / max(nr - 1, 1))
    sizes = r ** np.arange(nr)
    cum = np.concatenate([[0.0], np.cumsum(sizes)])
    br = radius + (outer_radius - radius) * cum / cum[-1]
    # theta breakpoints: start at the downstream direction (theta = 0 = +x)
    bt = np.linspace(0.0, 2.0 * np.pi, ntheta + 1)

    elems_x, elems_y, ebc = [], [], []
    half = np.deg2rad(outflow_half_angle)
    for er in range(nr):
        ra, rb = br[er], br[er + 1]
        for et in range(ntheta):
            ta, tb = bt[et], bt[et + 1]
            rr = ra + 0.5 * (z + 1.0) * (rb - ra)
            tt = ta + 0.5 * (z + 1.0) * (tb - ta)
            R, T = np.meshgrid(rr, tt, indexing="ij")
            elems_x.append(R * np.cos(T))
            elems_y.append(R * np.sin(T))
            # edges: 0 eta=-1 (theta=ta side), 1 xi=+1 (r=rb), 2 eta=+1, 3 xi=-1 (r=ra)
            tc = 0.5 * (ta + tb)
            # wrap to (-pi, pi]: downstream arc is |angle| < half
            ang = np.angle(np.exp(1j * tc))
            outer = BC.OUTFLOW if abs(ang) < half else BC.DIRICHLET
            tags = [
                BC.INTERNAL,  # theta- side (periodic wrap merges via coords)
                outer if er == nr - 1 else BC.INTERNAL,
                BC.INTERNAL,
                BC.WALL if er == 0 else BC.INTERNAL,
            ]
            ebc.append(tags)

    x = np.stack(elems_x)
    y = np.stack(elems_y)
    edge_bc = np.empty((x.shape[0], 4), dtype=object)
    for e, tags in enumerate(ebc):
        edge_bc[e, :] = tags
    return build_mesh(x, y, edge_bc, order)

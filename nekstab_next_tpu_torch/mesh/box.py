"""Structured 2-D box mesh generator (numpy copy of
``nekstab_next_tpu/mesh/box.py``): periodic boxes, channels, cavities, and
boxes with carved-out elements.  The port's tests use it for the affine
meshes on which the ``'laplacian'`` pressure scheme is safe."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np

from .gll import gll_points_weights
from .mesh import BoundaryCondition as BC
from .mesh import Mesh2D, build_mesh


def _breakpoints(lo: float, hi: float, n: int, grading: Union[None, float, Sequence[float]]) -> np.ndarray:
    if grading is None:
        return np.linspace(lo, hi, n + 1)
    if np.isscalar(grading):
        # geometric grading: ratio of last to first element size
        r = float(grading) ** (1.0 / max(n - 1, 1))
        sizes = r ** np.arange(n)
        cum = np.concatenate([[0.0], np.cumsum(sizes)])
        return lo + (hi - lo) * cum / cum[-1]
    pts = np.asarray(grading, dtype=np.float64)
    assert len(pts) == n + 1
    return pts


def box_mesh_2d(
    nx: int,
    ny: int,
    order: int,
    x0: float = 0.0,
    x1: float = 1.0,
    y0: float = 0.0,
    y1: float = 1.0,
    bc: Optional[dict] = None,
    periodic_x: bool = False,
    periodic_y: bool = False,
    grading_x: Union[None, float, Sequence[float]] = None,
    grading_y: Union[None, float, Sequence[float]] = None,
    mask: Optional[Callable[[float, float], bool]] = None,
    mask_bc: BC = BC.WALL,
) -> Mesh2D:
    """Tensor-product box of ``nx * ny`` elements on [x0,x1] x [y0,y1].

    ``bc`` maps side names ('left','right','bottom','top') to
    :class:`BoundaryCondition`; periodic directions override side tags.
    ``mask(xc, yc) -> bool`` drops elements whose center satisfies it,
    exposing new boundary edges with ``mask_bc``.
    """
    bc = bc or {}
    side_bc = {
        "left": bc.get("left", BC.WALL),
        "right": bc.get("right", BC.WALL),
        "bottom": bc.get("bottom", BC.WALL),
        "top": bc.get("top", BC.WALL),
    }
    n = order + 1
    z, _ = gll_points_weights(n)
    bx = _breakpoints(x0, x1, nx, grading_x)
    by = _breakpoints(y0, y1, ny, grading_y)

    keep = np.ones((nx, ny), dtype=bool)
    if mask is not None:
        for ex in range(nx):
            for ey in range(ny):
                xc = 0.5 * (bx[ex] + bx[ex + 1])
                yc = 0.5 * (by[ey] + by[ey + 1])
                if mask(xc, yc):
                    keep[ex, ey] = False

    elems_x, elems_y, ebc = [], [], []
    for ex in range(nx):
        for ey in range(ny):
            if not keep[ex, ey]:
                continue
            xa, xb = bx[ex], bx[ex + 1]
            ya, yb = by[ey], by[ey + 1]
            xi = xa + 0.5 * (z + 1.0) * (xb - xa)
            et = ya + 0.5 * (z + 1.0) * (yb - ya)
            X, Y = np.meshgrid(xi, et, indexing="ij")
            elems_x.append(X)
            elems_y.append(Y)

            def nb(dx, dy):
                jx, jy = ex + dx, ey + dy
                if 0 <= jx < nx and 0 <= jy < ny:
                    return bool(keep[jx, jy])
                return None  # domain boundary

            tags = []
            # edge 0: eta=-1 (bottom), 1: xi=+1 (right), 2: eta=+1 (top), 3: xi=-1 (left)
            for (dx, dy, side, per) in (
                (0, -1, "bottom", periodic_y),
                (1, 0, "right", periodic_x),
                (0, 1, "top", periodic_y),
                (-1, 0, "left", periodic_x),
            ):
                inside = nb(dx, dy)
                if inside is True:
                    tags.append(BC.INTERNAL)
                elif inside is False:
                    tags.append(mask_bc)  # edge exposed by a masked-out element
                else:
                    tags.append(BC.PERIODIC if per else side_bc[side])
            ebc.append(tags)

    x = np.stack(elems_x)
    y = np.stack(elems_y)
    edge_bc = np.empty((x.shape[0], 4), dtype=object)
    for e, tags in enumerate(ebc):
        edge_bc[e, :] = tags

    Lx, Ly = x1 - x0, y1 - y0

    def coord_key(cx, cy):
        kx = cx.copy()
        ky = cy.copy()
        if periodic_x:
            kx = x0 + np.mod(kx - x0, Lx)
            kx[np.isclose(kx - x0, Lx, atol=1e-12 * Lx)] = x0
        if periodic_y:
            ky = y0 + np.mod(ky - y0, Ly)
            ky[np.isclose(ky - y0, Ly, atol=1e-12 * Ly)] = y0
        return kx, ky

    need_key = periodic_x or periodic_y
    return build_mesh(x, y, edge_bc, order, coord_key=coord_key if need_key else None)

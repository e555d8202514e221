"""Spectral-element mesh: nodal coordinates, connectivity, metrics, masks.

Numpy copy of ``nekstab_next_tpu/mesh/mesh.py``; everything is precomputed
host-side and the port's ``SEM`` holds tensor copies of the factors.  The one
change is :func:`global_numbering`, which replaces the JAX package's native
gslib-setup library with numpy and numbers nodes in the same order.

Data layout: every field is ``(nelem, n, n)`` with the element axis first
and the two tensor-product node axes last.  Index convention: ``u[e, i, j]``
with ``i`` the xi-direction node index and ``j`` the eta-direction index.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .gll import diff_matrix, gll_points_weights


class BoundaryCondition(enum.Enum):
    """Edge tags, mirroring Nek5000 character BCs used by the reference cases
    (examples/cylinder/1cyl.usr boundary setup)."""

    INTERNAL = "E"
    WALL = "W"  # no-slip: u = 0
    DIRICHLET = "v"  # inflow: u = given profile
    OUTFLOW = "O"  # do-nothing: natural BC + pressure pinned to 0
    SYMMETRY = "SYM"  # u.n = 0 on an axis-aligned edge
    PERIODIC = "P"  # handled by connectivity, no mask


# Edge -> (i indices, j indices) on the reference element, counterclockwise:
# edge 0: eta=-1 (j=0), edge 1: xi=+1 (i=n-1), edge 2: eta=+1, edge 3: xi=-1.
def edge_node_indices(edge: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    r = np.arange(n)
    if edge == 0:
        return r, np.zeros(n, dtype=int)
    if edge == 1:
        return np.full(n, n - 1, dtype=int), r
    if edge == 2:
        return r, np.full(n, n - 1, dtype=int)
    if edge == 3:
        return np.zeros(n, dtype=int), r
    raise ValueError(edge)


def global_numbering(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Global node numbering from quantized coordinate keys (nkeys, nd).

    Returns ``(gid, counts)``: ``gid`` (nkeys,) int32 in FIRST-OCCURRENCE
    order and ``counts`` (nglobal,) int32 multiplicities — the numbering of
    the JAX package's native ``gs_number`` (native/gs_setup.cpp), which its
    meshes use wherever a C++ compiler exists, so both packages share ``gid``
    exactly.  (Its numpy fallback numbers in sorted-key order instead.)"""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if keys.ndim == 1:
        keys = keys[:, None]
    _, first, inverse, counts = np.unique(
        keys, axis=0, return_index=True, return_inverse=True,
        return_counts=True,
    )
    order = np.argsort(first, kind="stable")  # unique keys by first sighting
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    gid = rank[inverse.reshape(-1)].astype(np.int32)
    return gid, counts[order].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """Immutable 2-D spectral-element mesh with precomputed factors."""

    order: int  # polynomial order p (n = p+1 GLL nodes per direction)
    x: np.ndarray  # (nelem, n, n) node x-coordinates
    y: np.ndarray  # (nelem, n, n)
    gid: np.ndarray  # (nelem, n, n) int32 global node number
    nglobal: int  # number of distinct global nodes
    edge_bc: np.ndarray  # (nelem, 4) BC enum values (object array of BoundaryCondition)
    # geometric factors (all (nelem, n, n)):
    jac: np.ndarray  # Jacobian determinant
    rx: np.ndarray  # d(xi)/dx
    ry: np.ndarray  # d(xi)/dy
    sx: np.ndarray  # d(eta)/dx
    sy: np.ndarray  # d(eta)/dy
    bm: np.ndarray  # local (unassembled) mass:  w_i w_j |J|  — the reference's bm1
    mult: np.ndarray  # node multiplicity = dssum(1); for dsavg
    # stiffness geometric factors  G = w_i w_j |J| (grad xi_a . grad xi_b):
    g11: np.ndarray
    g12: np.ndarray
    g22: np.ndarray
    # masks (1.0 = free dof, 0.0 = Dirichlet), consistent across shared nodes:
    vmask: np.ndarray  # (nelem, n, n, 2) velocity component masks
    pmask: np.ndarray  # (nelem, n, n) pressure mask (0 at outflow nodes)
    tmask: np.ndarray  # (nelem, n, n) scalar/temperature mask
    has_pressure_dirichlet: bool  # False -> pure-Neumann Poisson (project mean)
    # boundary node flags per BC kind (nelem, n, n) booleans:
    dirichlet_nodes: np.ndarray  # WALL + DIRICHLET nodes (velocity BCs applied here)
    outflow_nodes: np.ndarray

    @property
    def n(self) -> int:
        return self.order + 1

    @property
    def nelem(self) -> int:
        return self.x.shape[0]

    @property
    def npoints(self) -> int:
        return self.x.size

    def min_spacing(self) -> float:
        """Minimum GLL node spacing — for CFL-targeted dt (reference
        core/matvec.f90:27-46 recomputes dt from a CFL target)."""
        dx = np.diff(self.x, axis=1) ** 2 + np.diff(self.y, axis=1) ** 2
        dy = np.diff(self.x, axis=2) ** 2 + np.diff(self.y, axis=2) ** 2
        return float(np.sqrt(min(dx.min(), dy.min())))

    def integrate(self, f: np.ndarray) -> float:
        """Quadrature integral of a nodal field (counts shared nodes once by
        construction: local bm weights sum to the assembled weight)."""
        return float(np.sum(f * self.bm))


def build_mesh(
    x: np.ndarray,
    y: np.ndarray,
    edge_bc: np.ndarray,
    order: int,
    coord_key: Optional[Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]] = None,
    tol: float = 1e-8,
) -> Mesh2D:
    """Assemble a :class:`Mesh2D` from nodal coordinates + edge tags.

    ``coord_key`` maps physical coords to the key-space used for global node
    matching — identity by default; periodic meshes pass a wrap (e.g.
    ``x mod Lx``) so opposite faces share global ids.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    nelem, n, _ = x.shape
    assert n == order + 1

    # ---- global numbering by coordinate hashing -------------------------
    kx, ky = (coord_key(x, y) if coord_key is not None else (x, y))
    scale = max(kx.max() - kx.min(), ky.max() - ky.min(), 1.0)
    q = tol * scale
    keys = np.stack(
        [np.round(kx.ravel() / q).astype(np.int64), np.round(ky.ravel() / q).astype(np.int64)],
        axis=1,
    )
    gid_flat, counts = global_numbering(keys)
    gid = gid_flat.reshape(nelem, n, n).astype(np.int32)
    nglobal = int(counts.size)
    mult = counts[gid_flat].reshape(nelem, n, n).astype(np.float64)

    # ---- geometric factors ---------------------------------------------
    D = diff_matrix(n)
    _, w = gll_points_weights(n)
    xr = np.einsum("ai,eij->eaj", D, x)
    xs = np.einsum("bj,eij->eib", D, x)
    yr = np.einsum("ai,eij->eaj", D, y)
    ys = np.einsum("bj,eij->eib", D, y)
    jac = xr * ys - xs * yr
    if np.any(jac <= 0):
        bad = int(np.sum(np.any(jac <= 0, axis=(1, 2))))
        raise ValueError(f"{bad} elements with non-positive Jacobian")
    rx, ry = ys / jac, -xs / jac
    sx, sy = -yr / jac, xr / jac
    w2 = np.outer(w, w)[None, :, :]
    bm = w2 * jac
    g11 = w2 * jac * (rx * rx + ry * ry)
    g12 = w2 * jac * (rx * sx + ry * sy)
    g22 = w2 * jac * (sx * sx + sy * sy)

    # ---- boundary masks (node-consistent via global ids) ----------------
    def nodeset(tags) -> np.ndarray:
        """Boolean (nelem,n,n): nodes lying on any edge with tag in ``tags``,
        propagated through shared global ids so corners are consistent."""
        flag = np.zeros(nglobal, dtype=bool)
        for e in range(nelem):
            for edge in range(4):
                if edge_bc[e, edge] in tags:
                    ii, jj = edge_node_indices(edge, n)
                    flag[gid[e, ii, jj]] = True
        return flag[gid]

    dirichlet = nodeset({BoundaryCondition.WALL, BoundaryCondition.DIRICHLET})
    outflow = nodeset({BoundaryCondition.OUTFLOW})
    sym = nodeset({BoundaryCondition.SYMMETRY})
    # Dirichlet wins over outflow at shared corners (Nek convention: the
    # stronger BC governs the node).
    outflow = outflow & ~dirichlet

    vmask = np.ones((nelem, n, n, 2))
    vmask[dirichlet, :] = 0.0
    # symmetry: zero only the normal component; detect edge orientation from
    # the edge index (axis-aligned assumption, as for Nek 'SYM' on box sides).
    if sym.any():
        sym_n = np.zeros((nelem, n, n, 2), dtype=bool)
        for e in range(nelem):
            for edge in range(4):
                if edge_bc[e, edge] is BoundaryCondition.SYMMETRY:
                    ii, jj = edge_node_indices(edge, n)
                    comp = 1 if edge in (0, 2) else 0  # horizontal edge -> v=0
                    sym_n[e, ii, jj, comp] = True
        # propagate through shared nodes per component
        for comp in range(2):
            flag = np.zeros(nglobal, dtype=bool)
            np.logical_or.at(flag, gid.ravel(), sym_n[..., comp].ravel())
            sym_n[..., comp] = flag[gid]
        vmask[sym_n & ~dirichlet[..., None]] = 0.0

    pmask = np.ones((nelem, n, n))
    pmask[outflow] = 0.0
    tmask = np.ones((nelem, n, n))
    tmask[dirichlet] = 0.0

    return Mesh2D(
        order=order,
        x=x,
        y=y,
        gid=gid,
        nglobal=nglobal,
        edge_bc=edge_bc,
        jac=jac,
        rx=rx,
        ry=ry,
        sx=sx,
        sy=sy,
        bm=bm,
        mult=mult,
        g11=g11,
        g12=g12,
        g22=g22,
        vmask=vmask,
        pmask=pmask,
        tmask=tmask,
        has_pressure_dirichlet=bool(outflow.any()),
        dirichlet_nodes=dirichlet,
        outflow_nodes=outflow,
    )

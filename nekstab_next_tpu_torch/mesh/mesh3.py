"""3-D spectral-element mesh (hexahedral elements).

Numpy copy of ``nekstab_next_tpu/mesh/mesh3.py``; the port's ``SEM3`` holds
tensor copies of its factors.  Layout: fields are ``(nelem, n, n, n)`` with
node axes (i, j, k) along (xi, eta, zeta).  The global numbering is the JAX
copy's own (``np.unique`` over quantized coordinates, sorted-key order), so
both packages share ``gid`` exactly."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from .gll import diff_matrix, gll_points_weights
from .mesh import BoundaryCondition


# Face -> fixed axis and side. Faces: 0:x- 1:x+ 2:y- 3:y+ 4:z- 5:z+
_FACE_AXIS = [(0, 0), (0, -1), (1, 0), (1, -1), (2, 0), (2, -1)]


def face_node_indices(face: int, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i, j, k) index arrays (each (n, n)) of the nodes on a face."""
    axis, side = _FACE_AXIS[face]
    r = np.arange(n)
    a, b = np.meshgrid(r, r, indexing="ij")
    fixed = np.full_like(a, 0 if side == 0 else n - 1)
    if axis == 0:
        return fixed, a, b
    if axis == 1:
        return a, fixed, b
    return a, b, fixed


@dataclasses.dataclass(frozen=True)
class Mesh3D:
    """Immutable 3-D spectral-element mesh with precomputed factors."""

    order: int
    x: np.ndarray  # (nelem, n, n, n)
    y: np.ndarray
    z: np.ndarray
    gid: np.ndarray  # (nelem, n, n, n) int32
    nglobal: int
    face_bc: np.ndarray  # (nelem, 6) BoundaryCondition
    jac: np.ndarray
    # inverse-metric entries d(xi_a)/d(x_b), each (nelem, n, n, n):
    drdx: np.ndarray
    drdy: np.ndarray
    drdz: np.ndarray
    dsdx: np.ndarray
    dsdy: np.ndarray
    dsdz: np.ndarray
    dtdx: np.ndarray
    dtdy: np.ndarray
    dtdz: np.ndarray
    bm: np.ndarray  # local mass  w_i w_j w_k |J|
    mult: np.ndarray
    # stiffness geometric factors g_ab = w |J| grad(xi_a).grad(xi_b):
    g11: np.ndarray
    g12: np.ndarray
    g13: np.ndarray
    g22: np.ndarray
    g23: np.ndarray
    g33: np.ndarray
    vmask: np.ndarray  # (nelem, n, n, n, 3)
    pmask: np.ndarray  # (nelem, n, n, n)
    tmask: np.ndarray
    has_pressure_dirichlet: bool
    dirichlet_nodes: np.ndarray
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

    @property
    def ndim(self) -> int:
        return 3

    def min_spacing(self) -> float:
        d2 = []
        for ax in (1, 2, 3):
            d2.append(
                np.diff(self.x, axis=ax) ** 2
                + np.diff(self.y, axis=ax) ** 2
                + np.diff(self.z, axis=ax) ** 2
            )
        return float(np.sqrt(min(d.min() for d in d2)))

    def integrate(self, f: np.ndarray) -> float:
        return float(np.sum(f * self.bm))


def build_mesh_3d(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    face_bc: np.ndarray,
    order: int,
    coord_key: Optional[Callable] = None,
    tol: float = 1e-8,
) -> Mesh3D:
    """Assemble a :class:`Mesh3D` from nodal coordinates + face tags (same
    coordinate-hash global numbering as the 2-D mesh, with ``coord_key``
    wrapping periodic directions)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    nelem, n, _, _ = x.shape
    assert n == order + 1

    # ---- global numbering ------------------------------------------------
    if coord_key is not None:
        kx, ky, kz = coord_key(x, y, z)
    else:
        kx, ky, kz = x, y, z
    scale = max(kx.max() - kx.min(), ky.max() - ky.min(), kz.max() - kz.min(), 1.0)
    q = tol * scale
    keys = np.stack(
        [
            np.round(kx.ravel() / q).astype(np.int64),
            np.round(ky.ravel() / q).astype(np.int64),
            np.round(kz.ravel() / q).astype(np.int64),
        ],
        axis=1,
    )
    _, gid_flat, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    gid = gid_flat.reshape(nelem, n, n, n).astype(np.int32)
    nglobal = int(counts.size)
    mult = counts[gid_flat].reshape(nelem, n, n, n).astype(np.float64)

    # ---- geometric factors -------------------------------------------------
    D = diff_matrix(n)
    _, w = gll_points_weights(n)

    def dref(a, axis):
        sub = "ai,eijk->eajk" if axis == 0 else (
            "aj,eijk->eiak" if axis == 1 else "ak,eijk->eija")
        return np.einsum(sub, D, a)

    xr, xs, xt = dref(x, 0), dref(x, 1), dref(x, 2)
    yr, ys, yt = dref(y, 0), dref(y, 1), dref(y, 2)
    zr, zs, zt = dref(z, 0), dref(z, 1), dref(z, 2)

    jac = (
        xr * (ys * zt - yt * zs)
        - xs * (yr * zt - yt * zr)
        + xt * (yr * zs - ys * zr)
    )
    if np.any(jac <= 0):
        bad = int(np.sum(np.any(jac <= 0, axis=(1, 2, 3))))
        raise ValueError(f"{bad} elements with non-positive Jacobian")

    # inverse metric by adjugate / det
    drdx = (ys * zt - yt * zs) / jac
    drdy = -(xs * zt - xt * zs) / jac
    drdz = (xs * yt - xt * ys) / jac
    dsdx = -(yr * zt - yt * zr) / jac
    dsdy = (xr * zt - xt * zr) / jac
    dsdz = -(xr * yt - xt * yr) / jac
    dtdx = (yr * zs - ys * zr) / jac
    dtdy = -(xr * zs - xs * zr) / jac
    dtdz = (xr * ys - xs * yr) / jac

    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :])[None]
    bm = w3 * jac

    def gab(ax, ay, az, bx, by, bz):
        return w3 * jac * (ax * bx + ay * by + az * bz)

    g11 = gab(drdx, drdy, drdz, drdx, drdy, drdz)
    g12 = gab(drdx, drdy, drdz, dsdx, dsdy, dsdz)
    g13 = gab(drdx, drdy, drdz, dtdx, dtdy, dtdz)
    g22 = gab(dsdx, dsdy, dsdz, dsdx, dsdy, dsdz)
    g23 = gab(dsdx, dsdy, dsdz, dtdx, dtdy, dtdz)
    g33 = gab(dtdx, dtdy, dtdz, dtdx, dtdy, dtdz)

    # ---- masks ------------------------------------------------------------
    BC = BoundaryCondition

    def nodeset(tags) -> np.ndarray:
        flag = np.zeros(nglobal, dtype=bool)
        for e in range(nelem):
            for face in range(6):
                if face_bc[e, face] in tags:
                    ii, jj, kk = face_node_indices(face, n)
                    flag[gid[e, ii, jj, kk]] = True
        return flag[gid]

    dirichlet = nodeset({BC.WALL, BC.DIRICHLET})
    outflow = nodeset({BC.OUTFLOW})
    sym = nodeset({BC.SYMMETRY})
    outflow = outflow & ~dirichlet

    vmask = np.ones((nelem, n, n, n, 3))
    vmask[dirichlet, :] = 0.0
    if sym.any():
        sym_n = np.zeros((nelem, n, n, n, 3), dtype=bool)
        for e in range(nelem):
            for face in range(6):
                if face_bc[e, face] is BC.SYMMETRY:
                    ii, jj, kk = face_node_indices(face, n)
                    comp = _FACE_AXIS[face][0]
                    sym_n[e, ii, jj, kk, comp] = True
        for comp in range(3):
            flag = np.zeros(nglobal, dtype=bool)
            np.logical_or.at(flag, gid.ravel(), sym_n[..., comp].ravel())
            sym_n[..., comp] = flag[gid]
        vmask[sym_n & ~dirichlet[..., None]] = 0.0

    pmask = np.ones((nelem, n, n, n))
    pmask[outflow] = 0.0
    tmask = np.ones((nelem, n, n, n))
    tmask[dirichlet] = 0.0

    return Mesh3D(
        order=order, x=x, y=y, z=z, gid=gid, nglobal=nglobal, face_bc=face_bc,
        jac=jac,
        drdx=drdx, drdy=drdy, drdz=drdz,
        dsdx=dsdx, dsdy=dsdy, dsdz=dsdz,
        dtdx=dtdx, dtdy=dtdy, dtdz=dtdz,
        bm=bm, mult=mult,
        g11=g11, g12=g12, g13=g13, g22=g22, g23=g23, g33=g33,
        vmask=vmask, pmask=pmask, tmask=tmask,
        has_pressure_dirichlet=bool(outflow.any()),
        dirichlet_nodes=dirichlet, outflow_nodes=outflow,
    )


def box_mesh_3d(
    nx: int,
    ny: int,
    nz: int,
    order: int,
    x0: float = 0.0,
    x1: float = 1.0,
    y0: float = 0.0,
    y1: float = 1.0,
    z0: float = 0.0,
    z1: float = 1.0,
    bc: Optional[dict] = None,
    periodic_x: bool = False,
    periodic_y: bool = False,
    periodic_z: bool = False,
    mask: Optional[Callable[[float, float, float], bool]] = None,
    mask_bc: BoundaryCondition = BoundaryCondition.WALL,
) -> Mesh3D:
    """Tensor-product hex box; ``mask(xc, yc, zc)`` carves elements (the
    cube-roughness case), exposing new faces tagged ``mask_bc``.

    ``bc`` keys: 'left'/'right' (x), 'bottom'/'top' (y), 'front'/'back' (z).
    """
    BC = BoundaryCondition
    bc = bc or {}
    side = {
        "left": bc.get("left", BC.WALL),
        "right": bc.get("right", BC.WALL),
        "bottom": bc.get("bottom", BC.WALL),
        "top": bc.get("top", BC.WALL),
        "front": bc.get("front", BC.WALL),
        "back": bc.get("back", BC.WALL),
    }

    n = order + 1
    zg, _ = gll_points_weights(n)
    t = 0.5 * (zg + 1.0)

    xb = np.linspace(x0, x1, nx + 1)
    yb = np.linspace(y0, y1, ny + 1)
    zb = np.linspace(z0, z1, nz + 1)

    keep = []
    for ex in range(nx):
        for ey in range(ny):
            for ez in range(nz):
                xc = 0.5 * (xb[ex] + xb[ex + 1])
                yc = 0.5 * (yb[ey] + yb[ey + 1])
                zc = 0.5 * (zb[ez] + zb[ez + 1])
                if mask is not None and mask(xc, yc, zc):
                    continue
                keep.append((ex, ey, ez))
    keepset = set(keep)
    nelem = len(keep)

    X = np.empty((nelem, n, n, n))
    Y = np.empty((nelem, n, n, n))
    Z = np.empty((nelem, n, n, n))
    fbc = np.empty((nelem, 6), dtype=object)

    def neighbor(ex, ey, ez, face):
        d = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)][face]
        return ex + d[0], ey + d[1], ez + d[2]

    for e, (ex, ey, ez) in enumerate(keep):
        ex0, ex1_ = xb[ex], xb[ex + 1]
        ey0, ey1_ = yb[ey], yb[ey + 1]
        ez0, ez1_ = zb[ez], zb[ez + 1]
        X[e] = (ex0 + (ex1_ - ex0) * t)[:, None, None] * np.ones((1, n, n))
        Y[e] = (ey0 + (ey1_ - ey0) * t)[None, :, None] * np.ones((n, 1, n))
        Z[e] = (ez0 + (ez1_ - ez0) * t)[None, None, :] * np.ones((n, n, 1))
        for face in range(6):
            nx_, ny_, nz_ = neighbor(ex, ey, ez, face)
            inx = (0 <= nx_ < nx) or (periodic_x and face in (0, 1))
            iny = (0 <= ny_ < ny) or (periodic_y and face in (2, 3))
            inz = (0 <= nz_ < nz) or (periodic_z and face in (4, 5))
            wrapped = (nx_ % nx, ny_ % ny, nz_ % nz)
            if inx and iny and inz:
                if wrapped in keepset:
                    fbc[e, face] = BC.INTERNAL
                else:
                    fbc[e, face] = mask_bc
            else:
                name = ["left", "right", "bottom", "top", "front", "back"][face]
                fbc[e, face] = side[name]

    Lx, Ly, Lz = x1 - x0, y1 - y0, z1 - z0

    def coord_key(xx, yy, zz):
        kx = np.mod(xx - x0, Lx) + x0 if periodic_x else xx
        ky = np.mod(yy - y0, Ly) + y0 if periodic_y else yy
        kz = np.mod(zz - z0, Lz) + z0 if periodic_z else zz
        return kx, ky, kz

    ck = coord_key if (periodic_x or periodic_y or periodic_z) else None
    return build_mesh_3d(X, Y, Z, fbc, order, coord_key=ck)

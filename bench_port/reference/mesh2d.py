"""Plain numpy 2-D spectral-element meshes for the benchmark's reference.

The reference builds its own mesh from a configuration file: the nodal
coordinates of every element, the connectivity of shared nodes, the
geometric factors and the masks.  It imports nothing of the program.  The
construction follows the published definitions of the two cases (GLL
nodes of order N, an isoparametric map from the nodal coordinates, a
velocity Dirichlet mask on walls and inflow, a smooth-step sponge), so the
discrete operators equal the program's up to round-off.

Layout: every field is ``(nelem, n, n)``, ``u[e, i, j]`` with ``i`` the
xi-direction node and ``j`` the eta-direction node; vector fields carry a
trailing component axis.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

WALL, INFLOW, OUTFLOW, INTERNAL = "W", "v", "O", "E"


def gll(n: int):
    """The n Gauss-Lobatto-Legendre points and weights on [-1, 1] (Newton
    on (1 - x^2) P'_{n-1}, Chebyshev-Lobatto start)."""
    p = n - 1
    x = np.cos(np.pi * np.arange(n) / p)[::-1].copy()
    P = np.zeros((n, n))
    x_old = np.full(n, 2.0)
    while np.max(np.abs(x - x_old)) > 1e-15:
        x_old = x.copy()
        P[:, 0], P[:, 1] = 1.0, x
        for k in range(2, n):
            P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
        x = x_old - (x * P[:, p] - P[:, p - 1]) / (n * P[:, p])
    P[:, 0], P[:, 1] = 1.0, x
    for k in range(2, n):
        P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
    w = 2.0 / (p * n * P[:, p] ** 2)
    x[0], x[-1] = -1.0, 1.0
    return x, w


def _bary(x: np.ndarray) -> np.ndarray:
    c = np.ones(len(x))
    for i in range(len(x)):
        for j in range(len(x)):
            if i != j:
                c[i] *= x[i] - x[j]
    return c


def diff(n: int) -> np.ndarray:
    """Spectral differentiation on the n GLL points."""
    x, _ = gll(n)
    c = _bary(x)
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                D[i, j] = c[i] / (c[j] * (x[i] - x[j]))
    D[np.arange(n), np.arange(n)] = -D.sum(axis=1)
    return D


def interp(x_from: np.ndarray, x_to: np.ndarray) -> np.ndarray:
    """Lagrange interpolation matrix (len(x_to), len(x_from))."""
    w = 1.0 / _bary(x_from)
    J = np.zeros((len(x_to), len(x_from)))
    for k, xt in enumerate(x_to):
        d = xt - x_from
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            J[k, np.argmax(hit)] = 1.0
        else:
            t = w / d
            J[k] = t / t.sum()
    return J


def smooth_step(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _edge_nodes(edge: int, n: int):
    r = np.arange(n)
    return {0: (r, np.zeros(n, int)), 1: (np.full(n, n - 1), r),
            2: (r, np.full(n, n - 1)), 3: (np.zeros(n, int), r)}[edge]


@dataclasses.dataclass
class Mesh:
    """Nodal coordinates, connectivity, geometry and masks of one mesh."""

    n: int
    x: np.ndarray
    y: np.ndarray
    gid: np.ndarray  # (nelem, n, n) global node of every local node
    nglobal: int
    jac: np.ndarray
    rx: np.ndarray
    ry: np.ndarray
    sx: np.ndarray
    sy: np.ndarray
    bm: np.ndarray  # local mass w_i w_j |J|
    g11: np.ndarray
    g12: np.ndarray
    g22: np.ndarray
    vmask: np.ndarray  # (nelem, n, n): 0 on wall and inflow nodes
    sponge: np.ndarray  # (nelem, n, n) sponge strength

    @property
    def nelem(self) -> int:
        return self.x.shape[0]

    @property
    def bms(self) -> np.ndarray:
        """The energy weight with the sponge region taken out."""
        return np.where(self.sponge > 0.0, 0.0, self.bm)


def assemble(x: np.ndarray, y: np.ndarray, edge_bc: list, n: int) -> Mesh:
    """Connectivity by matching coordinates, isoparametric geometry and
    the velocity mask (wall and inflow edges, consistent at shared
    nodes).  The sponge is zero; the case sets it."""
    nelem = x.shape[0]
    scale = max(np.ptp(x), np.ptp(y), 1.0)
    q = 1e-8 * scale
    keys = np.stack([np.round(x.ravel() / q), np.round(y.ravel() / q)], 1).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    gid = inv.reshape(nelem, n, n)
    nglobal = int(gid.max()) + 1

    D = diff(n)
    _, w = gll(n)
    xr = np.einsum("ai,eij->eaj", D, x)
    xs = np.einsum("bj,eij->eib", D, x)
    yr = np.einsum("ai,eij->eaj", D, y)
    ys = np.einsum("bj,eij->eib", D, y)
    jac = xr * ys - xs * yr
    if np.any(jac <= 0):
        raise ValueError("an element with a non-positive Jacobian")
    rx, ry, sx, sy = ys / jac, -xs / jac, -yr / jac, xr / jac
    w2 = np.outer(w, w)[None]
    bm = w2 * jac

    dirichlet = np.zeros(nglobal, bool)
    for e in range(nelem):
        for edge in range(4):
            if edge_bc[e][edge] in (WALL, INFLOW):
                ii, jj = _edge_nodes(edge, n)
                dirichlet[gid[e, ii, jj]] = True
    vmask = np.where(dirichlet[gid], 0.0, 1.0)
    return Mesh(n=n, x=x, y=y, gid=gid, nglobal=nglobal, jac=jac, rx=rx, ry=ry,
                sx=sx, sy=sy, bm=bm, g11=bm * (rx * rx + ry * ry),
                g12=bm * (rx * sx + ry * sy), g22=bm * (sx * sx + sy * sy),
                vmask=vmask, sponge=np.zeros_like(bm))


def cylinder(cfg: dict) -> Mesh:
    """The O-mesh about a cylinder of diameter 2 ``radius``: ``nr`` rings
    geometrically graded by ``grading`` out to ``outer_radius``,
    ``ntheta`` sectors from the downstream axis; the outer arc is outflow
    within ``outflow_half_angle`` of downstream and inflow elsewhere; a
    smooth-step sponge from ``sponge_start_frac`` of the outer radius."""
    n = cfg["order"] + 1
    z, _ = gll(n)
    nr, nt = cfg["nr"], cfg["ntheta"]
    R0, R1 = cfg["radius"], cfg["outer_radius"]
    g = cfg["grading"] ** (1.0 / max(nr - 1, 1))
    cum = np.concatenate([[0.0], np.cumsum(g ** np.arange(nr))])
    br = R0 + (R1 - R0) * cum / cum[-1]
    bt = np.linspace(0.0, 2.0 * np.pi, nt + 1)
    half = np.deg2rad(cfg["outflow_half_angle"])
    xs, ys, bcs = [], [], []
    for er in range(nr):
        for et in range(nt):
            rr = br[er] + 0.5 * (z + 1.0) * (br[er + 1] - br[er])
            tt = bt[et] + 0.5 * (z + 1.0) * (bt[et + 1] - bt[et])
            Rg, Tg = np.meshgrid(rr, tt, indexing="ij")
            xs.append(Rg * np.cos(Tg))
            ys.append(Rg * np.sin(Tg))
            ang = np.angle(np.exp(1j * 0.5 * (bt[et] + bt[et + 1])))
            outer = OUTFLOW if abs(ang) < half else INFLOW
            bcs.append([INTERNAL, outer if er == nr - 1 else INTERNAL, INTERNAL,
                        WALL if er == 0 else INTERNAL])
    m = assemble(np.stack(xs), np.stack(ys), bcs, n)
    r = np.sqrt(m.x ** 2 + m.y ** 2)
    if cfg["sponge_strength"] > 0:
        r0 = cfg["sponge_start_frac"] * R1
        m.sponge = cfg["sponge_strength"] * smooth_step((r - r0) / (R1 - r0))
    return m


def _graded(x0: float, x1: float, nel: int, h0: float) -> np.ndarray:
    """nel-element breakpoints on [x0, x1] growing geometrically from a
    first cell of width h0 at x0 (bisection for the growth factor)."""
    L = x1 - x0
    if h0 * nel >= L:
        return np.linspace(x0, x1, nel + 1)
    lo, hi = 1.0 + 1e-12, 10.0
    for _ in range(80):
        g = 0.5 * (lo + hi)
        if h0 * (g ** nel - 1.0) / (g - 1.0) < L:
            lo = g
        else:
            hi = g
    sizes = h0 * g ** np.arange(nel)
    sizes *= L / sizes.sum()
    return x0 + np.concatenate([[0.0], np.cumsum(sizes)])


def backward_facing_step(cfg: dict) -> Mesh:
    """The backward-facing step of expansion ratio 2: the channel
    y in [-1, 1] from x = -inflow_length to outflow_length with the block
    x < 0, y < 0 carved out; inflow on the left, outflow on the right,
    walls elsewhere; x breakpoints graded into the step corner from a
    first cell of ``step_dx``, y uniform; smooth-step sponges of
    ``sponge_left``/``sponge_right`` length at both ends."""
    n = cfg["order"] + 1
    z, _ = gll(n)
    Li, Lo = cfg["inflow_length"], cfg["outflow_length"]
    eu, ed, ey = cfg["elems_upstream"], cfg["elems_downstream"], cfg["elems_y"]
    up = _graded(0.0, Li, eu, cfg["step_dx"])
    bx = np.concatenate([(-up[::-1])[:-1], _graded(0.0, Lo, ed, cfg["step_dx"])])
    by = np.linspace(-1.0, 1.0, ey + 1)
    nx = eu + ed
    keep = np.array([[not (0.5 * (bx[i] + bx[i + 1]) < 0 and 0.5 * (by[j] + by[j + 1]) < 0)
                      for j in range(ey)] for i in range(nx)])
    side = {"bottom": WALL, "right": OUTFLOW, "top": WALL, "left": INFLOW}
    xs, ys, bcs = [], [], []
    for i in range(nx):
        for j in range(ey):
            if not keep[i, j]:
                continue
            X, Y = np.meshgrid(bx[i] + 0.5 * (z + 1.0) * (bx[i + 1] - bx[i]),
                               by[j] + 0.5 * (z + 1.0) * (by[j + 1] - by[j]), indexing="ij")
            xs.append(X)
            ys.append(Y)
            tags = []
            for dx, dy, s in ((0, -1, "bottom"), (1, 0, "right"), (0, 1, "top"),
                              (-1, 0, "left")):
                a, b = i + dx, j + dy
                if 0 <= a < nx and 0 <= b < ey:
                    tags.append(INTERNAL if keep[a, b] else WALL)
                else:
                    tags.append(side[s])
            bcs.append(tags)
    m = assemble(np.stack(xs), np.stack(ys), bcs, n)
    if cfg["sponge"]:
        xl = -Li + cfg["sponge_left"]
        xr = Lo - cfg["sponge_right"]
        lam = np.zeros_like(m.x)
        if cfg["sponge_left"] > 0:
            lam += smooth_step((xl - m.x) / cfg["sponge_left"])
        if cfg["sponge_right"] > 0:
            lam += smooth_step((m.x - xr) / cfg["sponge_right"])
        m.sponge = cfg["sponge_strength"] * lam
    return m


MESHES = {"cylinder": cylinder, "backward_facing_step": backward_facing_step}


def build(cfg: dict) -> Mesh:
    """The mesh a configuration names in ``case``."""
    return MESHES[cfg["case"]](cfg)


def dealias_points(n: int) -> int:
    """The 3/2-rule over-integration grid: ceil(3 n / 2) Gauss points."""
    return int(math.ceil(3 * n / 2))

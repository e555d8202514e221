"""Aerodynamic forces on a body and the period of a signal (port of
``BoundaryQuadrature``, ``boundary_quadrature``, ``surface_force_and_torque``,
``zero_crossings`` and ``periods_from_signal`` from
``nekstab_next_tpu/utils/diagnostics.py``; the reference's
``nekStab_torque``/``drgtrq`` and ``zero_crossing``).  The quadrature is
built on the host from the mesh (numpy); the force is evaluated on the SEM's
device.  The period helpers are host numpy copies."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..mesh.gll import diff_matrix, gll_points_weights
from ..mesh.mesh import BoundaryCondition as BC, Mesh2D, edge_node_indices
from ..postproc.vortex import velocity_gradient


@dataclasses.dataclass
class BoundaryQuadrature:
    """Precomputed edge quadrature on a set of boundary edges: gather indices
    into (nelem, n, n) fields plus arc-length weights and body-outward unit
    normals (pointing from the body INTO the fluid)."""

    elems: np.ndarray  # (nedges,)
    ii: np.ndarray  # (nedges, n) i-index of each edge node
    jj: np.ndarray  # (nedges, n)
    ds: np.ndarray  # (nedges, n) arclength quadrature weight
    normal: np.ndarray  # (nedges, n, 2) unit normal into the fluid


def boundary_quadrature(
    mesh: Mesh2D,
    tags: Sequence[BC] = (BC.WALL,),
    region=None,
) -> BoundaryQuadrature:
    """Surface quadrature over all edges tagged in ``tags``; ``region``
    optionally filters by an edge-midpoint predicate ``f(x, y) -> bool``."""
    n = mesh.n
    D1 = diff_matrix(n)
    _, w1 = gll_points_weights(n)
    tags = set(tags)

    elems, iis, jjs, dss, nrms = [], [], [], [], []
    for e in range(mesh.nelem):
        cx, cy = mesh.x[e].mean(), mesh.y[e].mean()
        for edge in range(4):
            if mesh.edge_bc[e, edge] not in tags:
                continue
            ii, jj = edge_node_indices(edge, n)
            ex, ey = mesh.x[e, ii, jj], mesh.y[e, ii, jj]
            if region is not None and not region(ex.mean(), ey.mean()):
                continue
            tx, ty = D1 @ ex, D1 @ ey  # tangent d(x,y)/ds along the edge
            tnorm = np.hypot(tx, ty)
            ds = tnorm * w1
            # rotate the tangent; orient toward the element interior, i.e.
            # into the fluid (body-outward)
            nx, ny = ty / tnorm, -tx / tnorm
            sgn = np.sign((cx - ex) * nx + (cy - ey) * ny)
            sgn[sgn == 0] = 1.0
            nx, ny = nx * sgn, ny * sgn
            elems.append(e)
            iis.append(ii)
            jjs.append(jj)
            dss.append(ds)
            nrms.append(np.stack([nx, ny], axis=-1))

    if not elems:
        raise ValueError(f"no boundary edges with tags {tags}")
    return BoundaryQuadrature(
        elems=np.asarray(elems),
        ii=np.asarray(iis),
        jj=np.asarray(jjs),
        ds=np.asarray(dss),
        normal=np.asarray(nrms),
    )


def surface_force_and_torque(
    sem,
    bq: BoundaryQuadrature,
    u: torch.Tensor,
    p: torch.Tensor,
    viscosity: float,
    center: Tuple[float, float] = (0.0, 0.0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Fx, Fy, Mz): force and torque exerted BY the fluid ON the body
    bounded by the quadrature edges.  t_i = [-p delta_ij + nu (du_i/dx_j +
    du_j/dx_i)] n_j with n pointing from the body into the fluid.  A Gauss
    (PnPn-2) pressure is interpolated to the GLL nodes first.  The torque
    reads the node coordinates of ``sem.mesh``."""
    mesh = sem.mesh
    if tuple(p.shape) != tuple(sem.bm.shape):
        p = sem.p_to_gll(p)
    G = velocity_gradient(sem, u)  # du_a/dx_b, C0-smoothed
    dev, dt = G.device, G.dtype
    el = torch.as_tensor(bq.elems, device=dev)[:, None]
    ii = torch.as_tensor(bq.ii, device=dev)
    jj = torch.as_tensor(bq.jj, device=dev)

    def gather(f):
        return f[el, ii, jj]

    pg = gather(p)
    Gg = gather(G)  # (nedges, n, 2, 2)
    nrm = torch.as_tensor(bq.normal, dtype=dt, device=dev)
    ds = torch.as_tensor(bq.ds, dtype=dt, device=dev)

    S2 = Gg + Gg.transpose(-1, -2)  # 2 S
    trac = -pg[..., None] * nrm + viscosity * torch.einsum("knab,knb->kna", S2, nrm)
    F = torch.sum(trac * ds[..., None], dim=(0, 1))
    xg = gather(torch.as_tensor(mesh.x, dtype=dt, device=dev)) - center[0]
    yg = gather(torch.as_tensor(mesh.y, dtype=dt, device=dev)) - center[1]
    Mz = torch.sum((xg * trac[..., 1] - yg * trac[..., 0]) * ds)
    return F[0], F[1], Mz


def zero_crossings(times: np.ndarray, signal: np.ndarray) -> np.ndarray:
    """Upward zero-crossing instants by linear interpolation (the
    Poincare-section period tracker, the reference's ``zero_crossing``
    writing zc_period.dat); successive differences estimate the period."""
    times = np.asarray(times)
    s = np.asarray(signal)
    idx = np.where((s[:-1] <= 0.0) & (s[1:] > 0.0))[0]
    frac = -s[idx] / (s[idx + 1] - s[idx])
    return times[idx] + frac * (times[idx + 1] - times[idx])


def periods_from_signal(times, signal) -> np.ndarray:
    """Periods between the upward crossings of the signal's mean."""
    return np.diff(zero_crossings(times, np.asarray(signal) - np.mean(signal)))

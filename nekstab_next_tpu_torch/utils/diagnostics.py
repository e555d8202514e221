"""Runtime diagnostics (port of ``nekstab_next_tpu/utils/diagnostics.py``):
global invariants (energy, enstrophy), aerodynamic forces per immersed
object, probes, period tracking and step monitoring (the reference's
energy/enstrophy series, ``nekStab_torque``/``drgtrq``, ``pointcheck``,
``zero_crossing`` and ``nekStab_comment``).  The quadrature, the object
grouping and the probe locator are built on the host from the mesh
(numpy); the invariants and the force are evaluated on the SEM's device.
The period helpers, the monitor and the series writer are host copies."""

from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..mesh.gll import diff_matrix, gll_points_weights
from ..mesh.mesh import BoundaryCondition as BC, Mesh2D, edge_node_indices


def total_energy(sem, u: torch.Tensor) -> torch.Tensor:
    """E = 1/2 int |u|^2."""
    return 0.5 * sum(sem.glsum(sem.bm * u[..., d] ** 2) for d in range(u.shape[-1]))


def total_enstrophy(sem, u: torch.Tensor) -> torch.Tensor:
    """Z = 1/2 int |curl u|^2 (2-D: scalar vorticity)."""
    w = sem.dsavg(sem.curl(u[..., 0], u[..., 1]))
    return 0.5 * sem.glsum(sem.bm * w * w)


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


def define_objects(
    mesh: Mesh2D,
    tags: Sequence[BC] = (BC.WALL,),
    classify=None,
) -> List[BoundaryQuadrature]:
    """Partition the tagged boundary into immersed OBJECTS and return one
    :class:`BoundaryQuadrature` per object — the reference's multi-object
    machinery (``nekStab_define_obj`` groups boundary faces into objects
    and ``nekStab_torque`` reports drag/lift/torque per object,
    core/utils.f90:718-895).

    Default grouping: connected components of the tagged edge graph (two
    edges belong to the same object iff they share a mesh vertex — each
    closed body surface becomes one object).  ``classify(xmid, ymid) ->
    int`` overrides with explicit object ids."""
    bq = boundary_quadrature(mesh, tags=tags)
    ne = len(bq.elems)
    gid = np.asarray(mesh.gid)

    if classify is not None:
        labels = np.array([
            int(classify(float(mesh.x[bq.elems[k], bq.ii[k], bq.jj[k]].mean()),
                         float(mesh.y[bq.elems[k], bq.ii[k], bq.jj[k]].mean())))
            for k in range(ne)
        ])
    else:
        # union-find over shared edge-endpoint global ids
        parent = np.arange(ne)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        end_ids = {}
        for k in range(ne):
            e = bq.elems[k]
            for end in (0, -1):
                g = int(gid[e, bq.ii[k, end], bq.jj[k, end]])
                if g in end_ids:
                    ra, rb = find(end_ids[g]), find(k)
                    parent[rb] = ra
                else:
                    end_ids[g] = k
        roots = np.array([find(k) for k in range(ne)])
        _, labels = np.unique(roots, return_inverse=True)

    out = []
    for lab in np.unique(labels):
        sel = labels == lab
        out.append(BoundaryQuadrature(
            elems=bq.elems[sel], ii=bq.ii[sel], jj=bq.jj[sel],
            ds=bq.ds[sel], normal=bq.normal[sel],
        ))
    return out


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
    # here, not at the top: postproc imports the stepper, whose solves
    # import utils (tracing)
    from ..postproc.vortex import velocity_gradient

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


def locate_probes(mesh, points) -> list:
    """Nearest-GLL-node probe locator — the reference's ``pointcheck``
    (core/utils.f90:5-27): for each requested (x, y[, z]) return
    ``(elem, flat_node_index, distance)`` of the closest grid node, so
    time-series probes read ``field[elem].reshape(-1)[node]``."""
    coords = [np.asarray(mesh.x), np.asarray(mesh.y)]
    if getattr(mesh, "ndim", 2) == 3 or hasattr(mesh, "z"):
        z = getattr(mesh, "z", None)
        if z is not None:
            coords.append(np.asarray(z))
    nelem = coords[0].shape[0]
    flat = np.stack([c.reshape(nelem, -1) for c in coords], axis=-1)
    out = []
    for pt in np.atleast_2d(np.asarray(points, dtype=np.float64)):
        d2 = np.sum((flat - pt[: flat.shape[-1]]) ** 2, axis=-1)
        e, node = np.unravel_index(np.argmin(d2), d2.shape)
        out.append((int(e), int(node), float(np.sqrt(d2[e, node]))))
    return out


def probe_values(field, locs, vector: bool = False) -> np.ndarray:
    """Sample a field (nelem, *spatial[, comp]) at ``locate_probes``
    locations (a tensor is copied to the host); ``vector=True`` keeps the
    trailing component axis."""
    f = field.detach().cpu().numpy() if isinstance(field, torch.Tensor) else np.asarray(field)
    nelem = f.shape[0]
    if vector:
        flat = f.reshape(nelem, -1, f.shape[-1])
        return np.array([flat[e, n, :] for (e, n, _) in locs])
    flat = f.reshape(nelem, -1)
    return np.array([flat[e, n] for (e, n, _) in locs])


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


class StepMonitor:
    """Per-step wall-clock accounting + CFL guard (the reference's
    ``nekStab_comment``: mean step cost, time per nondimensional time unit,
    ETA, abort at CFL > 10 — utils.f90:538-598)."""

    def __init__(self, total_steps: int, dt: float, cfl_abort: float = 10.0,
                 log=print, every: int = 100):
        self.total = int(total_steps)
        self.dt = float(dt)
        self.cfl_abort = float(cfl_abort)
        self.log = log
        self.every = max(int(every), 1)
        self._t0 = _time.perf_counter()
        self.steps_done = 0

    def step(self, cfl: Optional[float] = None) -> None:
        self.steps_done += 1
        if cfl is not None and cfl > self.cfl_abort:
            raise RuntimeError(
                f"CFL {cfl:.2f} > {self.cfl_abort} at step {self.steps_done} "
                "— diverged (reference aborts identically, utils.f90:550-557)"
            )
        if self.steps_done % self.every == 0:
            el = _time.perf_counter() - self._t0
            per = el / self.steps_done
            eta = per * (self.total - self.steps_done)
            self.log(
                f"step {self.steps_done}/{self.total}  t={self.steps_done*self.dt:.4f}  "
                f"{per*1e3:.1f} ms/step  t/t_nd={per/self.dt:.2f} s  ETA {eta:.0f}s"
                + (f"  CFL={cfl:.3f}" if cfl is not None else "")
            )


class SeriesWriter:
    """Append-mode structured time-series files in the reference's formats
    (residu.dat, total_energy.dat, lift_drag.dat ... SURVEY.md section 5)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def write(self, *cols) -> None:
        self._fh.write(" ".join(f"{float(c):.15E}" for c in cols) + "\n")

    def close(self) -> None:
        self._fh.close()

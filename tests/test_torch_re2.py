"""The port's Nek5000 ``.re2`` reader and writer (``mesh/re2.py``, a numpy
copy of the JAX package's) against the JAX package's, on generated files:
a 2-D two-element mesh, two stacked hexes, an extruded annulus with
circular 'C' edges and a cubed-sphere shell patch with 's' faces (the
fixtures of ``tests/test_re2.py`` and ``tests/test_re2_curved3d.py``).

Each file is written by the port, read back by the port (round trip) and by
the JAX package, and meshed by both: the same global numbering, the same
coordinates to 1e-13.
"""

import os

import numpy as np
import pytest

from nekstab_next_tpu.mesh.re2 import mesh3_from_re2 as jax_mesh3_from_re2
from nekstab_next_tpu.mesh.re2 import mesh_from_re2 as jax_mesh_from_re2
from nekstab_next_tpu.mesh.re2 import read_re2 as jax_read_re2
from nekstab_next_tpu_torch.mesh import (
    Re2Data, mesh3_from_re2, mesh_from_re2, read_re2, write_re2)

WALL = ("W", np.zeros(5))


def two_element() -> Re2Data:
    """Two unit squares side by side: inflow left, outflow right, walls."""
    c1 = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    corners = np.stack([c1, c1 + [1, 0]])
    bcs = {(0, 3): ("v", np.zeros(5)), (1, 1): ("O", np.zeros(5)),
           (0, 0): WALL, (1, 0): WALL, (0, 2): WALL, (1, 2): WALL}
    return Re2Data(nelem=2, ndim=2, corners=corners, curves={}, bcs=bcs)


def two_hex() -> Re2Data:
    """Two unit cubes stacked in x (Nek faces 1=eta-, 2=xi+, 3=eta+, 4=xi-,
    5=zeta-, 6=zeta+; 0-based here)."""
    base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    corners = np.stack([base, base + [1, 0, 0]])
    bcs = {(e, sd): WALL for e in (0, 1) for sd in (0, 2, 4, 5)}
    bcs[(0, 3)] = ("v", np.zeros(5))
    bcs[(1, 1)] = ("O", np.zeros(5))
    return Re2Data(nelem=2, ndim=3, corners=corners, curves={}, bcs=bcs)


def ring(ntheta=12, r1=1.0, r2=2.0, h=1.0) -> Re2Data:
    """Extruded annulus: circular 'C' edges on the inner and outer surfaces
    at both z levels, walls on the curved surfaces and the z ends."""
    th = np.linspace(0.0, 2 * np.pi, ntheta + 1)
    corners = np.zeros((ntheta, 8, 3))
    curves, bcs = {}, {}
    for e in range(ntheta):
        t0, t1 = th[e], th[e + 1]
        pts = [(r1 * np.cos(t0), r1 * np.sin(t0)), (r2 * np.cos(t0), r2 * np.sin(t0)),
               (r2 * np.cos(t1), r2 * np.sin(t1)), (r1 * np.cos(t1), r1 * np.sin(t1))]
        for k, (x, y) in enumerate(pts):
            corners[e, k] = (x, y, 0.0)
            corners[e, k + 4] = (x, y, h)
        for edge, rad in ((1, r2), (3, -r1), (5, r2), (7, -r1)):
            curves[(e, edge)] = ("C", np.array([rad, 0, 0, 0, 0.0]))
        for sd in (3, 1, 4, 5):
            bcs[(e, sd)] = WALL
    return Re2Data(nelem=ntheta, ndim=3, corners=corners, curves=curves, bcs=bcs)


def shell(r1=1.0, r2=2.0, nt=2) -> Re2Data:
    """Cubed-sphere +z panel, radial extent [r1, r2], 's' records on the
    inner and outer faces."""
    a = np.linspace(-0.4, 0.4, nt + 1)
    corners = np.zeros((nt * nt, 8, 3))
    curves, bcs = {}, {}
    e = 0
    for i in range(nt):
        for j in range(nt):
            quad = [(a[i], a[j]), (a[i + 1], a[j]), (a[i + 1], a[j + 1]), (a[i], a[j + 1])]
            for k, (x, y) in enumerate(quad):
                d = np.array([x, y, 1.0])
                d /= np.linalg.norm(d)
                corners[e, k] = r1 * d
                corners[e, k + 4] = r2 * d
            curves[(e, 4)] = ("s", np.array([r1, 0.0, 0.0, 0.0, 0.0]))
            curves[(e, 5)] = ("s", np.array([r2, 0.0, 0.0, 0.0, 0.0]))
            for f in range(6):
                bcs[(e, f)] = WALL
            e += 1
    return Re2Data(nelem=nt * nt, ndim=3, corners=corners, curves=curves, bcs=bcs)


CASES = {"two_element": (two_element, 4), "two_hex": (two_hex, 3),
         "ring": (ring, 6), "shell": (shell, 5)}


def same_records(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k][0] == b[k][0], k
        np.testing.assert_array_equal(a[k][1], b[k][1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_write_read_round_trip(tmp_path, name):
    data = CASES[name][0]()
    path = os.path.join(tmp_path, name + ".re2")
    write_re2(path, data)
    for back in (read_re2(path), jax_read_re2(path)):
        assert back.nelem == data.nelem and back.ndim == data.ndim
        np.testing.assert_array_equal(back.corners, data.corners)
        same_records(back.curves, data.curves)
        same_records(back.bcs, data.bcs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_matches_jax(tmp_path, name):
    build, order = CASES[name]
    data = build()
    path = os.path.join(tmp_path, name + ".re2")
    write_re2(path, data)
    if data.ndim == 2:
        mesh, ref = mesh_from_re2(path, order=order), jax_mesh_from_re2(path, order=order)
        coords = ("x", "y")
        bc_key = "edge_bc"
    else:
        mesh, ref = mesh3_from_re2(path, order=order), jax_mesh3_from_re2(path, order=order)
        coords = ("x", "y", "z")
        bc_key = "face_bc"
    assert mesh.nelem == ref.nelem and mesh.nglobal == ref.nglobal
    np.testing.assert_array_equal(mesh.gid, np.asarray(ref.gid))
    np.testing.assert_array_equal(getattr(mesh, bc_key).astype(str),
                                  getattr(ref, bc_key).astype(str))
    np.testing.assert_array_equal(mesh.vmask, np.asarray(ref.vmask))
    for key in coords + ("jac", "bm"):
        got, want = getattr(mesh, key), np.asarray(getattr(ref, key))
        assert np.max(np.abs(got - want)) <= 1e-13 * max(np.max(np.abs(want)), 1.0), key
    assert mesh.jac.min() > 0.0


def test_curved_ring_dns_step(tmp_path):
    """``tests/test_re2_curved3d.py``'s check on the port: the curved ring
    assembles and takes 3 steps of the default 3-D PnPn-2 step, with a
    swirling start on no-slip walls: finite, the energy decays."""
    import torch

    from nekstab_next_tpu_torch.ops.core3 import SEM3
    from nekstab_next_tpu_torch.stepper import NavierStokes

    path = os.path.join(tmp_path, "ring.re2")
    write_re2(path, ring(ntheta=8))
    mesh = mesh3_from_re2(path, order=4)
    sem = SEM3(mesh, device="cpu")
    ns = NavierStokes(sem, viscosity=0.05, dt=5e-3)
    th = np.arctan2(mesh.y, mesh.x)
    u0 = sem.vmask * torch.as_tensor(np.stack([-np.sin(th), np.cos(th), np.zeros_like(th)], -1))
    energy = lambda u: float(sum(sem.inner(u[..., d], u[..., d]) for d in range(3)))
    st = ns.advance(ns.make_state(u0), 3)
    assert bool(torch.isfinite(st.u).all())
    assert energy(st.u) < energy(u0)
    div = sem.divv(st.u)
    assert float(torch.sqrt(sem.inner(div, div))) < 0.1

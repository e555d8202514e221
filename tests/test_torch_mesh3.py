"""The port's 3-D mesh, 2-D box mesh, 3-D FDM/coarse setup and SEM3
operators against the JAX package.

Both packages build the same carved cube (the cube-roughness geometry on a
5 x 3 x 3 lattice at order 3, one element carved out, z periodic, outflow
at x = Lx) and the same graded 2-D box; inputs come from numpy with a seed
and pass between the packages as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.mesh.mesh3 import face_node_indices as jax_face_node_indices
from nekstab_next_tpu_torch.interop import sem3_arrays, sem3_from_arrays
from nekstab_next_tpu_torch.mesh import box_mesh_2d, box_mesh_3d, face_node_indices
from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
from nekstab_next_tpu_torch.ops.core3 import FLOAT_KEYS3, SEM3

# the cube case's geometry at test size: 45 lattice elements, 1 carved
CUBE = dict(reynolds=60.0, h=1.0, lx=5.0, ly=3.0, lz=3.0, cube_x=2.5,
            nx=5, ny=3, nz=3, order=3, delta=1.0, target_cfl=0.2)
# f64 operators: the same arithmetic in another summation order
OP_RTOL = 1e-12
# host factors: the same numpy code on the same inputs (the dealiased
# factors contract one axis at a time here): a few roundoffs of 1e-16
FACTOR_RTOL = 1e-13


def port_cube_mesh(c=CUBE):
    h = c["h"]
    x0c, x1c = c["cube_x"] - h / 2, c["cube_x"] + h / 2
    zc0 = c["lz"] / 2
    z0c, z1c = zc0 - h / 2, zc0 + h / 2
    return box_mesh_3d(
        c["nx"], c["ny"], c["nz"], order=c["order"], x1=c["lx"], y1=c["ly"], z1=c["lz"],
        bc={"left": BC.DIRICHLET, "right": BC.OUTFLOW, "bottom": BC.WALL,
            "top": BC.DIRICHLET},
        periodic_z=True,
        mask=lambda xc, yc, zc: (x0c < xc < x1c) and (yc < h) and (z0c < zc < z1c),
        mask_bc=BC.WALL,
    )


@pytest.fixture(scope="module")
def cube():
    jcase = JaxCube(**CUBE)
    jsem = jcase.sem
    mesh = port_cube_mesh()
    own = SEM3(mesh, device="cpu")
    return jcase, mesh, own, sem3_from_arrays(sem3_arrays(jsem), device="cpu")


def relerr(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-300))


def test_cube_mesh_carves_and_numbers_as_jax(cube):
    jcase, mesh, _, _ = cube
    jm = jcase.mesh
    assert mesh.nelem == jm.nelem == 5 * 3 * 3 - 1
    assert mesh.nglobal == jm.nglobal
    np.testing.assert_array_equal(mesh.gid, np.asarray(jm.gid))
    np.testing.assert_array_equal(mesh.face_bc.astype(str), jm.face_bc.astype(str))
    assert mesh.has_pressure_dirichlet == jm.has_pressure_dirichlet is True
    for key in ("mult", "vmask", "pmask", "tmask", "dirichlet_nodes", "outflow_nodes"):
        np.testing.assert_array_equal(getattr(mesh, key), getattr(jm, key))


MESH3_FLOATS = ("x", "y", "z", "jac", "drdx", "drdy", "drdz", "dsdx", "dsdy", "dsdz",
                "dtdx", "dtdy", "dtdz", "bm", "g11", "g12", "g13", "g22", "g23", "g33")


@pytest.mark.parametrize("key", MESH3_FLOATS)
def test_cube_mesh_factor_matches_jax(cube, key):
    jcase, mesh, _, _ = cube
    assert relerr(getattr(jcase.mesh, key), getattr(mesh, key)) <= FACTOR_RTOL


def test_face_node_indices_match_jax():
    for face in range(6):
        for a, b in zip(face_node_indices(face, 5), jax_face_node_indices(face, 5)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(nx=3, ny=3, order=6, grading_x=1.3),
    dict(nx=3, ny=2, order=5, x1=2 * np.pi, y1=2 * np.pi, periodic_x=True, periodic_y=True),
    dict(nx=4, ny=3, order=4, bc={"left": BC.DIRICHLET, "right": BC.OUTFLOW},
         mask=lambda x, y: x < 0.3 and y < 0.4),
], ids=["graded", "periodic", "carved"])
def test_box_mesh_2d_matches_jax(kw):
    from nekstab_next_tpu.mesh.mesh import BoundaryCondition as JaxBC

    jkw = dict(kw)
    if "bc" in kw:
        jkw["bc"] = {k: JaxBC(v.value) for k, v in kw["bc"].items()}
    jm, m = jax_box_mesh_2d(**jkw), box_mesh_2d(**kw)
    assert m.nglobal == jm.nglobal
    np.testing.assert_array_equal(m.gid, np.asarray(jm.gid))
    for key in ("vmask", "pmask", "mult"):
        np.testing.assert_array_equal(getattr(m, key), getattr(jm, key))
    for key in ("x", "y", "jac", "rx", "ry", "sx", "sy", "bm", "g11", "g12", "g22"):
        assert relerr(getattr(jm, key), getattr(m, key)) <= FACTOR_RTOL


@pytest.mark.parametrize("key", FLOAT_KEYS3)
def test_sem3_own_factor_matches_jax(cube, key):
    jcase, _, own, _ = cube
    assert relerr(getattr(jcase.sem, key), getattr(own, key).numpy()) <= FACTOR_RTOL


def test_sem3_ints_match_jax(cube):
    jcase, _, own, _ = cube
    np.testing.assert_array_equal(own.gid.numpy(), np.asarray(jcase.sem.gid))
    np.testing.assert_array_equal(own.pc_cid.numpy(), np.asarray(jcase.sem.pc_cid))
    assert own.pc_nc == jcase.sem.pc_nc and own.nglobal == jcase.sem.nglobal


def test_sem3_from_arrays_installs_factors(cube):
    jcase, _, _, port = cube
    for key in FLOAT_KEYS3:
        np.testing.assert_array_equal(getattr(port, key).numpy(),
                                      np.asarray(getattr(jcase.sem, key)))
    f32 = sem3_from_arrays(sem3_arrays(jcase.sem), device="cpu", dtype=torch.float32)
    assert f32.bm.dtype == torch.float32 and f32.gid.dtype == torch.int64
    with pytest.raises(KeyError, match="missing"):
        sem3_from_arrays({"D": np.eye(4)}, device="cpu")


def _inputs(jsem):
    rng = np.random.default_rng(0)
    return rng.standard_normal(tuple(jsem.bm.shape) + (3,))


# each case: the same call on the JAX SEM3 and the port's, velocity u (E,n,n,n,3)
OPS = {
    "dssum": lambda s, u: s.dssum(u),
    "dsavg": lambda s, u: s.dsavg(u),
    "dsavg_mass": lambda s, u: s.dsavg_mass(u),
    "grad": lambda s, u: s.grad(u[..., 0])[0] + 2.0 * s.grad(u[..., 0])[1]
    - s.grad(u[..., 0])[2],
    "gradv": lambda s, u: s.gradv(u[..., 1]),
    "divv": lambda s, u: s.divv(u),
    "stiffness_local": lambda s, u: s.stiffness_local(u[..., 1]),
    "stiffness_diag": lambda s, u: s.stiffness_diag(),
    "helmholtz_local": lambda s, u: s.helmholtz_local(u[..., 2], 0.0167, 100.0),
    "fdm_apply": lambda s, u: s.fdm_apply(u, 0.0167, 100.0),
    "fdm_apply_h2_zero": lambda s, u: s.fdm_apply(u[..., 0], 1.0, 0.0),
    "coarse_apply_pressure": lambda s, u: s.coarse_apply_pressure(u[..., 1]),
    "convect": lambda s, u: s.convect(u, u[..., 1]),
    "inner": lambda s, u: s.inner(u, 2.0 * u + 1.0),
    "norm_unmasked": lambda s, u: s.norm(u, masked=False),
    "glsum": lambda s, u: s.glsum(u[..., 0]),
    "mean": lambda s, u: s.mean(u[..., 2]),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_sem3_operator_matches_jax(cube, name):
    jcase, _, _, port = cube
    u = _inputs(jcase.sem)
    ref = OPS[name](jcase.sem, jnp.asarray(u))
    got = OPS[name](port, torch.as_tensor(u))
    assert relerr(ref, got.numpy()) <= OP_RTOL


def test_sem3_dssum_copies_bit_identical(cube):
    # the gather sums every copy of a global node in the same order
    _, _, _, port = cube
    s = port.dssum(torch.as_tensor(_inputs(port))).reshape(-1, 3).numpy()
    gid = port.gid_np
    for g in np.unique(gid[np.bincount(gid)[gid] > 1])[:200]:
        rows = s[gid == g]
        assert (rows == rows[0]).all()


def test_sem3_set_sponge_matches_jax():
    jsem = JaxCube(**CUBE).sem
    port = SEM3(port_cube_mesh(), device="cpu")
    lam = np.clip(np.asarray(jsem.mesh.x) - 3.0, 0.0, None)
    jsem.set_sponge(lam)
    port.set_sponge(lam)
    np.testing.assert_array_equal(port.bms.numpy(), np.asarray(jsem.bms))
    np.testing.assert_array_equal(port.sponge.numpy(), np.asarray(jsem.sponge))


@pytest.mark.parametrize("call", [
    lambda s, u: s.div_to_p(u), lambda s, u: s.p_to_gll(s.restrict_p(u[..., 0])),
    lambda s, u: torch.zeros(s.p_shape), lambda s, u: s.setup_pressure_blocks(),
    lambda s, u: s.pressure_precond_pnpn2(s.restrict_p(u[..., 0])),
    lambda s, u: s.curl(u[..., 0], u[..., 1], u[..., 2]),
    lambda s, u: s.cfl(u, 0.1), lambda s, u: s.convect_colloc(u, u[..., 0]),
], ids=["div_to_p", "p_to_gll", "p_shape", "blocks", "pnpn2_precond", "curl", "cfl",
        "convect_colloc"])
def test_sem3_unported_raise(cube, call):
    # the pieces that raised before the 3-D PnPn-2 port now run on a fresh
    # SEM3 and give finite values (tests/test_torch_sem3_pnpn2.py holds
    # them against JAX)
    port = sem3_from_arrays(sem3_arrays(cube[0].sem), device="cpu")
    out = call(port, torch.as_tensor(_inputs(port)))
    if out is None:  # a set-up
        assert torch.isfinite(port.pblock_inv).all()
        return
    parts = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(torch.as_tensor(x)).all() for x in parts)

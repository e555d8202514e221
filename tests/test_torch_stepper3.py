"""The port's 3-D PnPn-2 step (``pressure_operator='pnpn2'``, the f64
default) against the JAX package's, and the exact-solution checks of
``tests/test_3d.py`` on the port.

Two meshes: ``tests/test_3d.py``'s ``periodic3`` (3 x 3 x 3 elements on the
2 pi periodic box at order 5) and the tiny cube of
``tests/test_cube_case.py`` (6 x 2 x 2 lattice minus the block, order 4,
Re = 200, inflow, outflow and walls).  The port's SEM3 takes the JAX SEM3's
factors (``interop``); both run 5 steps at inner tolerances of 1e-12 from
the same seeded start.  Solved that far, a step does not depend on its
preconditioners, so the port's step under each preconditioner is held to
the JAX step under the default ``'fdm'`` ones (JAX's SEM3 has no
``setup_velocity_blocks`` for a 3-D velocity ``'block'`` step of its own);
``tests/test_torch_sem3_pnpn2.py`` holds each preconditioner's apply to
JAX's.  ``dealias=False`` is held to JAX's ``dealias=False`` step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_3d as jax_box_mesh_3d
from nekstab_next_tpu.ops import SEM3 as JaxSEM3
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem3_arrays, sem3_from_arrays
from nekstab_next_tpu_torch.mesh import box_mesh_3d
from nekstab_next_tpu_torch.ops.core3 import SEM3
from nekstab_next_tpu_torch.stepper import NavierStokes

TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=2000,
             velocity_maxiter=2000)
NSTEPS = 5
# f64 steps on the same factors, solves at 1e-12
RTOL = 1e-10
# the tiny cube of tests/test_cube_case.py
TINY_CUBE = dict(reynolds=200.0, h=1.0, lx=6.0, ly=2.0, lz=2.0, cube_x=2.5, cube_z=0.5,
                 nx=6, ny=2, nz=2, order=4, delta=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and no ``opt_einsum`` path search while this
    module runs (see ``tests/test_torch_orbit.py``)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


def periodic3_mesh(box=jax_box_mesh_3d):
    L = 2 * np.pi
    return box(3, 3, 3, order=5, x1=L, y1=L, z1=L,
               periodic_x=True, periodic_y=True, periodic_z=True)


def _periodic3():
    """(JAX SEM3, nu, dt, u_bc, seeded start): a Taylor-Green vortex with a
    spanwise wave on top."""
    mesh = periodic3_mesh()
    u0 = np.stack([-np.cos(mesh.x) * np.sin(mesh.y), np.sin(mesh.x) * np.cos(mesh.y),
                   0.1 * np.sin(mesh.z + mesh.x)], axis=-1)
    u0 = u0 + 0.01 * np.random.default_rng(1).standard_normal(u0.shape)
    return JaxSEM3(mesh), 0.1, 0.01, None, u0


def _cube():
    jcase = JaxCube(**TINY_CUBE)
    u0 = np.asarray(jcase.initial_flow())
    u0 = u0 + 0.01 * np.random.default_rng(2).standard_normal(u0.shape) * np.asarray(
        jcase.sem.vmask)
    return jcase.sem, jcase.h / jcase.reynolds, jcase.dt, np.array(jcase.u_bc), u0


MESHES = {"periodic3": _periodic3, "cube": _cube}
CONFIGS = {
    "fdm": dict(),
    "block": dict(pressure_precond="block"),
    "schwarz": dict(pressure_precond="schwarz"),
    "velocity_block": dict(velocity_precond="block"),
    "no_dealias": dict(dealias=False),
}
# every preconditioner on the cube; on periodic3 every element touches all
# 26 others, so each exact-block set-up there extracts one column per
# element and local dof (25-35 s a case in the two packages): periodic3
# holds the default step and the collocated convection
CASES = [("cube", c) for c in sorted(CONFIGS)] + [
    ("periodic3", "fdm"), ("periodic3", "no_dealias")]


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.fixture(scope="module")
def jax_steps():
    """(mesh inputs, the JAX state after NSTEPS default steps) by (mesh,
    dealias), each run once."""
    runs = {}

    def get(mesh: str, dealias: bool):
        if (mesh, dealias) not in runs:
            jsem, nu, dt, u_bc, u0 = MESHES[mesh]()
            jns = JaxNavierStokes(jsem, viscosity=nu, dt=dt,
                                  solver=JaxSolverConfig(**TIGHT, dealias=dealias),
                                  u_bc=None if u_bc is None else jnp.asarray(u_bc))
            ref = jax.jit(lambda st: jns.advance(st, NSTEPS))(jns.make_state(jnp.asarray(u0)))
            runs[(mesh, dealias)] = ((jsem, nu, dt, u_bc, u0), ref)
        return runs[(mesh, dealias)]

    return get


@pytest.mark.parametrize("mesh,config", CASES)
def test_pnpn2_steps_match_jax(jax_steps, mesh, config):
    cfg = dict(TIGHT, **CONFIGS[config])
    (jsem, nu, dt, u_bc, u0), ref = jax_steps(mesh, cfg.get("dealias", True))
    sem = sem3_from_arrays(sem3_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=nu, dt=dt, solver=SolverConfig(**cfg),
                      u_bc=None if u_bc is None else torch.as_tensor(u_bc))
    assert ns._scheme == "pnpn2" and ns.p_shape == sem.p_shape
    got = ns.advance(ns.make_state(torch.as_tensor(u0)), NSTEPS)
    assert rel(ref.u, got.u) < RTOL, (mesh, config, rel(ref.u, got.u))
    assert rel(ref.p, got.p) < RTOL, (mesh, config, rel(ref.p, got.p))
    assert rel(ref.dp, got.dp) < 1e-8, (mesh, config, rel(ref.dp, got.dp))


@pytest.fixture(scope="module")
def periodic3():
    mesh = periodic3_mesh(box_mesh_3d)
    return mesh, SEM3(mesh, device="cpu")


def test_stokes_decay_3d(periodic3):
    """``tests/test_3d.py``'s check on the port: a Fourier mode of tiny
    amplitude decays at nu |k|^2 through 30 steps of the default step."""
    mesh, sem = periodic3
    nu, dt, nsteps = 0.05, 0.01, 30
    amp = 1e-8
    u0 = amp * np.stack([np.sin(mesh.y), np.zeros_like(mesh.y), np.zeros_like(mesh.y)],
                        axis=-1)
    ns = NavierStokes(sem, viscosity=nu, dt=dt)
    u0 = torch.as_tensor(u0)
    out = ns.advance(ns.make_state(u0), nsteps)
    ratio = float(sem.norm(out.u[..., 0], masked=False) / sem.norm(u0[..., 0], masked=False))
    expected = np.exp(-nu * dt * nsteps)
    assert abs(ratio - expected) < 2e-4, (ratio, expected)


def test_taylor_green_embedded_3d(periodic3):
    """``tests/test_3d.py``'s check on the port: the 2-D Taylor-Green
    vortex embedded in 3-D stays an exact solution (the JAX bound 2e-2, the
    P_(N-2) floor at order 5) and w stays zero."""
    mesh, sem = periodic3
    nu, dt, nsteps = 0.1, 0.01, 20
    tg = np.stack([-np.cos(mesh.x) * np.sin(mesh.y), np.sin(mesh.x) * np.cos(mesh.y),
                   np.zeros_like(mesh.x)], axis=-1)
    ns = NavierStokes(sem, viscosity=nu, dt=dt)
    out = ns.advance(ns.make_state(torch.as_tensor(tg)), nsteps)
    err = float(torch.max(torch.abs(out.u - torch.as_tensor(tg) * np.exp(-2 * nu * nsteps * dt))))
    assert err < 2e-2, err
    assert float(torch.max(torch.abs(out.u[..., 2]))) < 1e-7


def test_fused_solves_run_the_plain_3d_step(periodic3):
    # once refused: JAX builds no kernel on a 3-D step and runs the plain
    # solves, and so does the port (the same step as without fused_solves)
    sem = periodic3[1]
    ns = NavierStokes(sem, viscosity=0.1, dt=0.01, solver=SolverConfig(fused_solves=True))
    plain = NavierStokes(sem, viscosity=0.1, dt=0.01)
    assert ns.fused_v is None and ns.fused_p is None
    u0 = torch.zeros(tuple(sem.bm.shape) + (3,), dtype=sem.dtype)
    u0[..., 0] = 1.0
    assert torch.equal(ns.step(ns.make_state(u0)).u, plain.step(plain.make_state(u0)).u)

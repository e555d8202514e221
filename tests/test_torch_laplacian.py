"""One step of the port's 'laplacian' and mixed-precision Navier-Stokes
steps against the JAX package, 2-D and 3-D, and the constructor's choice of
path.

2-D: test_pallas.py:87-111's periodic Taylor-Green box (enclosed: the
pressure mean is projected out).  3-D: the cube-roughness geometry at test
size (44 elements, order 3; inflow, walls, outflow, z periodic).  Both
steppers run on identical factors (the port's SEMs are built from the JAX
SEMs' arrays) and the same SolverConfig.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.ops.core import SEM as JaxSEM
from nekstab_next_tpu.stepper.navier_stokes import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import (
    sem3_arrays,
    sem3_from_arrays,
    sem_arrays,
    sem_from_arrays,
)
from nekstab_next_tpu_torch.ops.core3 import SEM3
from nekstab_next_tpu_torch.stepper import NavierStokes

CUBE = dict(reynolds=60.0, h=1.0, lx=5.0, ly=3.0, lz=3.0, cube_x=2.5,
            nx=5, ny=3, nz=3, order=3, delta=1.0, target_cfl=0.2)
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=600,
             velocity_maxiter=300)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def taylor_green():
    mesh = jax_box_mesh_2d(3, 3, order=5, x1=2 * np.pi, y1=2 * np.pi,
                           periodic_x=True, periodic_y=True)
    u0 = np.stack([-np.cos(mesh.x) * np.sin(mesh.y),
                   np.sin(mesh.x) * np.cos(mesh.y)], axis=-1)
    return JaxSEM(mesh), u0, dict(viscosity=0.05, dt=0.01), None


def cube():
    jcase = JaxCube(**CUBE)
    return (jcase.sem, np.array(jcase.initial_flow()),
            dict(viscosity=jcase.h / jcase.reynolds, dt=jcase.dt), np.array(jcase.u_bc))


CASES = {"2d": taylor_green, "3d": cube}


def both(name, mixed, cfg):
    """(JAX stepper, port stepper, u0) on one mesh, config and mode."""
    jsem, u0, kw, u_bc = CASES[name]()
    jns = JaxNavierStokes(jsem, **kw, solver=cfg, mixed_precision=mixed,
                          u_bc=None if u_bc is None else jnp.asarray(u_bc))
    to_port = sem_from_arrays if jsem.ndim == 2 else sem3_from_arrays
    arrays = sem_arrays(jsem) if jsem.ndim == 2 else sem3_arrays(jsem)
    ns = NavierStokes(to_port(arrays, device="cpu"), **kw, mixed_precision=mixed,
                      solver=SolverConfig(**dataclasses.asdict(cfg)),
                      u_bc=None if u_bc is None else torch.as_tensor(u_bc))
    return jns, ns, u0


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("name", sorted(CASES))
def test_laplacian_step_matches_jax_f64(name):
    cfg = JaxSolverConfig(**TIGHT, pressure_operator="laplacian")
    jns, ns, u0 = both(name, False, cfg)
    jst = jax.jit(jns.step)(jns.make_state(jnp.asarray(u0)))
    st = ns.step(ns.make_state(torch.as_tensor(u0)))
    assert tuple(st.p.shape) == tuple(jst.p.shape) == tuple(ns.sem.bm.shape)
    # both solve every inner system to 1e-12: f64 roundoff in another
    # summation order (measured <= 2e-14)
    assert rel(jst.u, st.u.numpy()) <= 1e-11
    assert rel(jst.p, st.p.numpy()) <= 1e-11
    assert rel(jst.dp, st.dp.numpy()) <= 1e-11


@pytest.mark.parametrize("name", sorted(CASES))
def test_mixed_step_matches_jax(name):
    # the legacy mixed path on both sides: f32 inner CG (JAX: the Pallas
    # kernel in interpret mode; the port: K4's plain version), f64
    # refinement; the SolverConfig defaults of test_pallas.py:87-111
    cfg = JaxSolverConfig()
    jns, ns, u0 = both(name, True, cfg)
    assert ns.mixed is not None and jns.mixed is not None
    jst = jns.step(jns.make_state(jnp.asarray(u0)))
    st = ns.step(ns.make_state(torch.as_tensor(u0)))
    du = float(np.max(np.abs(np.asarray(jst.u) - st.u.numpy())))
    scale = float(np.max(np.abs(np.asarray(jst.u))))
    # both refine to f64 (3 cycles at inner accuracy 3e-6): the gate of
    # test_pallas.py:111 between the mixed and the f64 steps (measured 7e-16)
    assert du <= 1e-8 * scale
    assert rel(jst.p, st.p.numpy()) <= 1e-8
    # the mixed branch carries dp but takes no warm start from it
    assert tuple(st.dp.shape) == tuple(ns.sem.bm.shape)
    assert ns.mixed.fused.launches == 0  # CPU: K4's plain version


def test_mixed_3d_step_matches_f64_laplacian():
    # the mixed step holds the f64 'laplacian' step it refines toward
    jns, ns64, u0 = both("3d", False, JaxSolverConfig(**TIGHT, pressure_operator="laplacian"))
    _, nsmx, _ = both("3d", True, JaxSolverConfig())
    a = ns64.step(ns64.make_state(torch.as_tensor(u0)))
    b = nsmx.step(nsmx.make_state(torch.as_tensor(u0)))
    assert float((a.u - b.u).abs().max()) <= 1e-8 * float(a.u.abs().max())


def _port_sem(dim):
    jsem = taylor_green()[0] if dim == 2 else JaxCube(**CUBE).sem
    if dim == 2:
        return sem_from_arrays(sem_arrays(jsem), device="cpu")
    return sem3_from_arrays(sem3_arrays(jsem), device="cpu")


@pytest.mark.parametrize("dim,cfg,mixed", [
    (2, dict(), True),                                  # fused_solves=False: legacy
    (2, dict(pressure_operator="laplacian", fused_solves=True), True),
    (3, dict(), True),                                  # every 3-D mesh: legacy
    (3, dict(fused_solves=True), True),
    (2, dict(pressure_operator="laplacian"), False),    # f64 'laplacian'
    (3, dict(pressure_operator="laplacian"), False),
])
def test_path_choice_follows_jax(dim, cfg, mixed):
    sem = _port_sem(dim)
    ns = NavierStokes(sem, viscosity=0.05, dt=0.01, solver=SolverConfig(**cfg),
                      mixed_precision=mixed)
    assert (ns.mixed is not None) == mixed
    assert ns._scheme == "laplacian" and ns.p_shape == tuple(sem.bm.shape)
    assert ns.fused_v is None and ns.fused_p is None
    st = ns.make_state(torch.zeros(tuple(sem.bm.shape) + (dim,), dtype=torch.float64))
    assert tuple(st.u.shape[-1:]) == (dim,) and tuple(st.p.shape) == tuple(sem.bm.shape)


def test_fused_ir_path_on_the_taylor_green_box():
    # 2-D 'pnpn2' + fused_solves + mixed: the box's exchange shift-decomposes,
    # so JAX takes its fused-IR path (f64 state on the PnPn-2 step, K1/K2
    # as the inner solves of refinement), and so does the port
    jsem = taylor_green()[0]
    cfg = dict(fused_solves=True)
    jns = JaxNavierStokes(jsem, viscosity=0.05, dt=0.01, solver=JaxSolverConfig(**cfg),
                          mixed_precision=True)
    sem = _port_sem(2)
    ns = NavierStokes(sem, viscosity=0.05, dt=0.01, solver=SolverConfig(**cfg),
                      mixed_precision=True)
    assert jns._mixed_ir and ns._mixed_ir and ns.mixed is None
    assert ns._scheme == jns._scheme == "pnpn2" and ns.p_shape == sem.p_shape
    assert ns.fused_v is not None and ns.fused_p.project_mean


# once refused as not ported (NotImplementedError): ``fused_solves`` where the
# JAX constructor builds K1 alone or no kernel
# (nekstab_next_tpu/stepper/navier_stokes.py:193-223).  The port selects as
# JAX does: K1 for the velocity of a 2-D float32 'laplacian' or 'consistent'
# step (on the CPU its plain version runs, held to the plain-solve step),
# the plain solves on 3-D and float64 steps (the same step as without it).
F32 = dict(velocity_tol=1e-6, pressure_tol=1e-5)


@pytest.mark.parametrize("dim,cfg,dtype", [
    (3, dict(), torch.float64),                                      # 3-D PnPn-2
    (2, dict(F32, pressure_operator="consistent"), torch.float32),
    (3, dict(pressure_operator="laplacian"), torch.float64),
    (2, dict(F32, pressure_operator="laplacian"), torch.float32),
    (2, dict(), torch.float64),                                      # f64 PnPn-2
], ids=["3d_pnpn2", "2d_consistent_f32", "3d_laplacian", "2d_laplacian_f32", "2d_pnpn2_f64"])
def test_fused_solves_select_kernels_as_jax(dim, cfg, dtype):
    jsem = taylor_green()[0] if dim == 2 else JaxCube(**CUBE).sem
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    if dtype == torch.float32:
        jsem = JaxSEM(jsem.mesh, dtype=jdtype)
    jns = JaxNavierStokes(jsem, viscosity=0.05, dt=0.01,
                          solver=JaxSolverConfig(**cfg, fused_solves=True))
    to_port = sem_from_arrays if dim == 2 else sem3_from_arrays
    sem = to_port(sem_arrays(jsem) if dim == 2 else sem3_arrays(jsem), dtype=dtype,
                  device="cpu")
    ns = NavierStokes(sem, viscosity=0.05, dt=0.01,
                      solver=SolverConfig(**cfg, fused_solves=True))
    plain = NavierStokes(sem, viscosity=0.05, dt=0.01, solver=SolverConfig(**cfg))
    assert (ns.fused_v is not None) == (jns._fused_v is not None) == (dtype == torch.float32)
    assert ns.fused_p is None and jns._fused_p is None
    calls = []
    if ns.fused_v is not None:
        solve = ns.fused_v.solve
        ns.fused_v.solve = lambda *a: calls.append(1) or solve(*a)
    u0 = torch.as_tensor(_field_like(sem), dtype=dtype)
    a = ns.step(ns.make_state(u0))
    b = plain.step(plain.make_state(u0))
    if dtype == torch.float64:
        # the same plain solves
        assert torch.equal(a.u, b.u) and torch.equal(a.p, b.p)
    else:
        # K1's plain version (one call a step, no launch on the CPU) against
        # the plain f32 solves, both to velocity_tol 1e-6
        assert len(calls) == 1 and ns.fused_v.launches == 0
        assert float((a.u - b.u).abs().max()) <= 1e-5 * float(b.u.abs().max())


def _field_like(sem):
    """A smooth divergence-carrying start on the Taylor-Green box, the cube's
    inflow on the cube."""
    if sem.ndim == 3:
        return np.array(JaxCube(**CUBE).initial_flow())
    return taylor_green()[1]


def test_sem3_step_inputs_have_three_components():
    sem = _port_sem(3)
    assert isinstance(sem, SEM3)
    ns = NavierStokes(sem, viscosity=0.05, dt=0.01, mixed_precision=True)
    assert tuple(ns.u_bc.shape) == tuple(sem.bm.shape) + (3,)

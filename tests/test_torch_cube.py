"""The port's cube-roughness case and its mixed-precision tangent propagator
against the JAX package.

The cube geometry at test size: a 5 x 3 x 3 lattice at order 3 with one
element carved out (44 elements, 4,928 velocity dof).  The tangent is the
JAX package's ``jax.linearize`` of the mixed step (the Pallas kernel in
interpret mode inside the refined solves) against the port's written-out
tangent step (K4's plain version on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu.stepper.navier_stokes import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem3_arrays, sem3_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

CUBE = dict(reynolds=60.0, h=1.0, lx=5.0, ly=3.0, lz=3.0, cube_x=2.5,
            nx=5, ny=3, nz=3, order=3, delta=1.0, target_cfl=0.2)
# the example's tolerances (examples/cube_transient_growth.py:70-71)
EXAMPLE = dict(pressure_tol=1e-7, velocity_tol=1e-8, pressure_maxiter=300,
               velocity_maxiter=120)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jcase():
    return JaxCube(**CUBE, solver=JaxSolverConfig(**EXAMPLE))


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_cube_case_matches_jax(jcase):
    case = CubeRoughnessCase(**CUBE, solver=SolverConfig(**EXAMPLE), device="cpu")
    assert case.mesh.nelem == jcase.mesh.nelem == 44
    assert case.dt == jcase.dt
    np.testing.assert_array_equal(case.u_bc.numpy(), np.asarray(jcase.u_bc))
    np.testing.assert_array_equal(case.initial_flow().numpy(),
                                  np.asarray(jcase.initial_flow()))
    ns0 = case.make_ns()  # the f64 default: the 3-D 'pnpn2' step
    assert ns0._scheme == "pnpn2" and ns0.p_shape == case.sem.p_shape
    ns = CubeRoughnessCase(**CUBE, device="cpu", solver=SolverConfig(
        **EXAMPLE, pressure_operator="laplacian")).make_ns()
    assert ns.nu == pytest.approx(case.h / case.reynolds) and ns.mixed is None
    mixed = NavierStokes(case.sem, viscosity=ns.nu, dt=case.dt, u_bc=case.u_bc,
                         solver=case.solver, mixed_precision=True)
    assert mixed.mixed is not None and mixed._scheme == "laplacian"


def _matvecs(jcase, mixed, nsteps, seed=0):
    """JAX and port tangent matvecs at the initial flow on identical
    factors; returns (ref, got, port operator)."""
    base = np.array(jcase.initial_flow())
    cfg = jcase.solver
    nu = jcase.h / jcase.reynolds
    if not mixed:
        cfg = dataclasses.replace(cfg, pressure_operator="laplacian", pressure_tol=1e-12,
                                  velocity_tol=1e-12, pressure_maxiter=600,
                                  velocity_maxiter=300)
    jns = JaxNavierStokes(jcase.sem, viscosity=nu, dt=jcase.dt, u_bc=jcase.u_bc,
                          solver=cfg, mixed_precision=mixed)
    q = np.asarray(jcase.sem.vmask) * np.random.default_rng(seed).standard_normal(base.shape)
    ref = JaxLinearizedOperator(jns, jnp.asarray(base), nsteps=nsteps).matvec(jnp.asarray(q))
    ns = NavierStokes(sem3_from_arrays(sem3_arrays(jcase.sem), device="cpu"),
                      viscosity=nu, dt=jcase.dt, u_bc=torch.as_tensor(np.array(jcase.u_bc)),
                      solver=SolverConfig(**dataclasses.asdict(cfg)), mixed_precision=mixed)
    op = LinearizedOperator(ns, torch.as_tensor(base), nsteps=nsteps)
    got = op.matvec(torch.as_tensor(q))
    return np.asarray(ref), got.numpy(), op


def test_cube_mixed_tangent_matvec_matches_jax(jcase):
    ref, got, op = _matvecs(jcase, mixed=True, nsteps=3)
    assert got.shape == ref.shape and np.isfinite(got).all()
    # both refine every inner solve to f64 (3 cycles at inner accuracy
    # 3e-6; measured 7e-16)
    assert rel(ref, got) <= 1e-8
    assert op.ns.mixed.fused.launches == 0  # CPU: K4's plain version


def test_cube_laplacian_tangent_matvec_matches_jax_f64(jcase):
    ref, got, _ = _matvecs(jcase, mixed=False, nsteps=3)
    # exact tangent against jax.linearize, inner solves at 1e-12 (measured 5e-13)
    assert rel(ref, got) <= 1e-9


def test_cube_mixed_tangent_is_linear(jcase):
    # relative inner-solve tolerances: the tangent scales exactly up to
    # roundoff, and the zero lift makes it vanish at q = 0
    case = CubeRoughnessCase(**CUBE, solver=SolverConfig(**EXAMPLE), device="cpu")
    ns = NavierStokes(case.sem, viscosity=case.h / case.reynolds, dt=case.dt,
                      u_bc=case.u_bc, solver=case.solver, mixed_precision=True)
    op = LinearizedOperator(ns, case.initial_flow(), nsteps=2)
    q = case.sem.vmask * torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(case.sem.bm.shape) + (3,)))
    a, b = op.matvec(q), op.matvec(-2.0 * q)
    assert float((b + 2.0 * a).norm() / b.norm()) < 1e-12
    assert float(op.matvec(torch.zeros_like(q)).abs().max()) == 0.0

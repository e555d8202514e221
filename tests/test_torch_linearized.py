"""The port's tangent propagator (stepper/linearized.py) against the JAX
package's ``LinearizedOperator`` (``jax.linearize`` of the step), on the
32-element cylinder case with identical factors and config.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

MESH = dict(nr=4, ntheta=8, order=6)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_stepper(jcase, jns, dtype):
    """The port's stepper on the JAX case's factors and config."""
    sem = sem_from_arrays(sem_arrays(jcase.sem), dtype=dtype, device="cpu")
    return NavierStokes(
        sem, viscosity=jns.nu, dt=jns.dt,
        u_bc=torch.as_tensor(np.array(jcase.u_bc)),
        sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
        solver=SolverConfig(**dataclasses.asdict(jns.solver)),
    )


def both_matvecs(cfg, dtype, nsteps, seed=1):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jcase = JaxCylinderCase(**MESH, solver=cfg, dtype=jdt)
    jns = jcase.make_ns()
    ns = port_stepper(jcase, jns, dtype)
    base = np.array(jcase.uniform_flow())
    vmask = np.asarray(jcase.sem.vmask)
    q = (vmask * np.random.default_rng(seed).standard_normal(base.shape)).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    ref = JaxLinearizedOperator(jns, jnp.asarray(base), nsteps=nsteps).matvec(
        jnp.asarray(q, jdt))
    op = LinearizedOperator(ns, torch.as_tensor(base), nsteps=nsteps)
    got = op.matvec(torch.as_tensor(q, dtype=dtype))
    return np.asarray(ref, np.float64), got.double().numpy(), (op, q)


def rel(ref, got) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_matvec_matches_jax_f64():
    cfg = JaxSolverConfig(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=400,
                          velocity_maxiter=200, pressure_precond="block")
    ref, got, _ = both_matvecs(cfg, torch.float64, 5)
    # exact tangent against jax.linearize, inner solves at 1e-12: f64
    # roundoff through 5 steps (measured ~3e-14)
    assert rel(ref, got) <= 1e-9


def test_matvec_fused_plain_matches_jax_f32():
    # the port's plain kernel versions against the JAX Pallas kernels
    # (interpret mode) at test_fused_cg.py:160-177's settings
    cfg = JaxSolverConfig(pressure_tol=1e-6, velocity_tol=1e-7, pressure_maxiter=80,
                          velocity_maxiter=40, pressure_precond="block",
                          fused_solves=True)
    ref, got, (op, _) = both_matvecs(cfg, torch.float32, 3)
    # that test's own bound between two f32 paths (measured 4e-5)
    assert rel(ref, got) < 1e-4
    assert op.ns.fused_v.launches == 0 and op.ns.fused_p.launches == 0


def test_matvec_fused_plain_matches_jax_f32_bench_caps():
    # bench caps 16/10.  Capped CG iterates amplify roundoff, by an amount
    # that depends on the input: on this 32-element mesh a 1e-7 relative
    # perturbation of bench.py's input q = vmask * base moves the port's own
    # 3-step f32 tangent by 2.2e-3, so no two f32 implementations agree
    # there to 1e-3.  The test takes a seed whose tangent is well
    # conditioned (measured 1.3e-5 under the same perturbation; JAX and the
    # port agree to 1.2e-5) and asserts that conditioning first.
    cfg = JaxSolverConfig(pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=16,
                          velocity_maxiter=10, pressure_precond="block",
                          fused_solves=True)
    ref, got, (op, q) = both_matvecs(cfg, torch.float32, 3, seed=12)
    noise = np.random.default_rng(99).standard_normal(q.shape).astype(np.float32)
    moved = op.matvec(torch.as_tensor(q * (1 + 1e-7 * noise))).double().numpy()
    assert rel(got, moved) < 1e-4
    assert rel(ref, got) < 1e-3


def test_matvec_is_linear():
    # the inner CG's exit test is relative (||r|| <= tol ||b||), so the
    # tangent map scales exactly up to roundoff
    case = CylinderCase(**MESH, device="cpu", solver=SolverConfig(
        pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=16,
        velocity_maxiter=10, pressure_precond="block"))
    op = LinearizedOperator(case.make_ns(), case.uniform_flow(), nsteps=3)
    q = case.sem.vmask * torch.as_tensor(
        np.random.default_rng(2).standard_normal(tuple(case.sem.bm.shape) + (2,)))
    a, b = op.matvec(q), op.matvec(4.0 * q)
    assert float((b - 4.0 * a).norm() / b.norm()) < 1e-12


def test_adjoint_and_forcing_raise():
    # once refused, both ported: the adjoint about the legacy
    # mixed-precision step (its refined solve is symmetric, held to JAX's in
    # tests/test_torch_adjoint.py) and the tangent of a forcing hook
    # (tests/test_torch_orbit.py): a hook whose tangent vanishes leaves the
    # operator as it was, bit for bit
    mixed = CylinderCase(nr=2, ntheta=4, order=4, device="cpu", mixed_precision=True)
    op = LinearizedOperator(mixed.make_ns(), mixed.uniform_flow(), nsteps=2)
    w = mixed.uniform_flow()
    got = op.rmatvec(w)
    assert got.shape == w.shape and bool(torch.isfinite(got).all())
    case = CylinderCase(nr=2, ntheta=4, order=4, device="cpu")
    ns = case.make_ns()
    u = case.uniform_flow()
    plain = LinearizedOperator(ns, u, nsteps=2)
    assert plain.rmatvec(u).shape == u.shape
    ns.forcing = lambda v, t: 0.0 * v
    forced = LinearizedOperator(ns, u, nsteps=2)
    assert torch.equal(forced.matvec(u), plain.matvec(u))
    assert torch.equal(forced.rmatvec(u), plain.rmatvec(u))

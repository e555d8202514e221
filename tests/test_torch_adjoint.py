"""The port's adjoint propagator (``LinearizedOperator.rmatvec``) and the
differentiable solve (``ops/cg.py`` ``SymmetricSolve``) against the JAX
package's ``rmatvec`` (``jax.linear_transpose`` of the tangent) and against
the adjoint identity, on the 4x4 cavity box of ``tests/test_linearized.py``
and on the 32-element cylinder."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.ops.cg import cg_solve
from nekstab_next_tpu_torch.ops.elliptic import elliptic_solve
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import (
    LinearizedOperator,
    make_tangent_propagator,
)

TIGHT = dict(velocity_tol=1e-13, pressure_tol=1e-13)
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


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def continuous(jsem, seed, amp=1.0):
    """tests/test_linearized.py's perturbation: C0 (dsavg), masked."""
    vm = np.asarray(jsem.vmask)
    q = amp * np.random.default_rng(seed).standard_normal(vm.shape)
    q = np.stack([np.asarray(jsem.dsavg(jnp.asarray(q[..., d]))) for d in range(2)], -1)
    return vm * q


@pytest.fixture(scope="module")
def cavity():
    """The cavity of tests/test_linearized.py (walls all round, nu 0.05,
    dt 0.01, a random C0 base of amplitude 0.1) with solves at 1e-13, in
    both packages on identical factors."""
    mesh = box_mesh_2d(4, 4, order=5, x0=0, x1=1, y0=0, y1=1)
    jsem = JaxSEM(mesh)
    jns = JaxNavierStokes(jsem, viscosity=0.05, dt=0.01, solver=JaxSolverConfig(**TIGHT))
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=0.05, dt=0.01, solver=SolverConfig(**TIGHT))
    return jsem, jns, ns, continuous(jsem, 0, 0.1)


def test_cavity_adjoint_identity(cavity):
    # <M q, w>_B = <q, M* w>_B down to the solver tolerance (1e-13): every
    # solve's transpose is the same symmetric solve
    jsem, _, ns, base = cavity
    op = LinearizedOperator(ns, torch.as_tensor(base), nsteps=3)
    q, w = (torch.as_tensor(continuous(jsem, s)) for s in (2, 3))
    bm = ns.sem.bm[..., None]
    a = float(torch.sum(op.matvec(q) * w * bm))
    b = float(torch.sum(q * op.rmatvec(w) * bm))
    assert abs(a - b) <= 1e-12 * max(abs(a), 1.0), (a, b)


def test_cavity_rmatvec_matches_jax(cavity):
    jsem, jns, ns, base = cavity
    w = continuous(jsem, 3)
    ref = JaxLinearizedOperator(jns, jnp.asarray(base), nsteps=3).rmatvec(jnp.asarray(w))
    got = LinearizedOperator(ns, torch.as_tensor(base), nsteps=3).rmatvec(torch.as_tensor(w))
    # measured 5.5e-14
    assert rel(got, ref) <= 1e-10


@pytest.fixture(scope="module")
def cylinder():
    """The 32-element cylinder (sponge on) in both packages, f64, solves at
    1e-13, about the uniform flow."""
    cfg = JaxSolverConfig(**TIGHT, pressure_precond="block")
    jcase = JaxCylinderCase(**MESH, solver=cfg)
    jns = jcase.make_ns()
    sem = sem_from_arrays(sem_arrays(jcase.sem), device="cpu")
    ns = NavierStokes(sem, viscosity=jns.nu, dt=jns.dt,
                      u_bc=torch.as_tensor(np.array(jcase.u_bc)),
                      sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
                      solver=SolverConfig(**dataclasses.asdict(cfg)))
    return jcase, jns, ns, np.array(jcase.uniform_flow())


def test_cylinder_adjoint_identity_and_jax(cylinder):
    # in the sponge-masked product the identity holds for perturbations
    # outside the sponge (M* = W^+ M^T W projects onto them)
    jcase, jns, ns, base = cylinder
    outside = np.asarray(jcase.sem.bms > 0)[..., None]
    q, w = (outside * continuous(jcase.sem, s) for s in (4, 5))
    op = LinearizedOperator(ns, torch.as_tensor(base), nsteps=2)
    Mw = op.rmatvec(torch.as_tensor(w))
    bms = ns.sem.bms[..., None]
    a = float(torch.sum(op.matvec(torch.as_tensor(q)) * torch.as_tensor(w) * bms))
    b = float(torch.sum(torch.as_tensor(q) * Mw * bms))
    assert abs(a - b) <= 1e-12 * max(abs(a), 1.0), (a, b)
    ref = JaxLinearizedOperator(jns, jnp.asarray(base), nsteps=2).rmatvec(jnp.asarray(w))
    assert rel(Mw, ref) <= 1e-10


def test_cylinder_f32_fused_rmatvec_matches_jax():
    # the f32 fused rmatvec: here the kernels' plain versions (CPU tensors),
    # in JAX the Pallas kernels in interpret mode.  Capped f32 solves are
    # roundoff-sensitive (tests/test_torch_linearized.py), so the input's
    # conditioning is checked first: a 1e-7 relative perturbation moves the
    # port's own rmatvec by less than 1e-4
    cfg = JaxSolverConfig(pressure_tol=1e-6, velocity_tol=1e-7, pressure_maxiter=80,
                          velocity_maxiter=40, pressure_precond="block", fused_solves=True)
    jcase = JaxCylinderCase(**MESH, solver=cfg, dtype=jnp.float32)
    jns = jcase.make_ns()
    sem = sem_from_arrays(sem_arrays(jcase.sem), dtype=torch.float32, device="cpu")
    ns = NavierStokes(sem, viscosity=jns.nu, dt=jns.dt,
                      u_bc=torch.as_tensor(np.array(jcase.u_bc)),
                      sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
                      solver=SolverConfig(**dataclasses.asdict(cfg)))
    base = np.array(jcase.uniform_flow())
    w = continuous(jcase.sem, 6).astype(np.float32)
    op = LinearizedOperator(ns, torch.as_tensor(base), nsteps=2)
    got = op.rmatvec(torch.as_tensor(w))
    assert got.dtype == torch.float32
    assert ns.fused_v.launches == 0 and ns.fused_p.launches == 0
    noise = np.random.default_rng(99).standard_normal(w.shape).astype(np.float32)
    moved = op.rmatvec(torch.as_tensor(w * (1 + 1e-7 * noise)))
    assert rel(moved, got) < 1e-4
    ref = JaxLinearizedOperator(jns, jnp.asarray(base), nsteps=2).rmatvec(jnp.asarray(w))
    # two f32 implementations at solver tolerances 1e-6/1e-7 (the matvec's
    # bound in tests/test_torch_linearized.py)
    assert rel(got, ref) < 1e-4


@pytest.fixture(scope="module")
def small_case():
    return CylinderCase(**MESH, device="cpu", solver=SolverConfig(
        pressure_tol=1e-10, velocity_tol=1e-10, pressure_precond="block"))


def test_cg_solve_backward_is_a_resolve(small_case):
    # the velocity Helmholtz solve of the stepper: the gradient of <x, g>
    # with respect to b is the same solve applied to g (up to roundoff:
    # elliptic_solve projects b before cg_solve, and the backward pass
    # projects after it; the projection P is idempotent and symmetric)
    sem = small_case.sem
    rng = np.random.default_rng(7)
    shape = tuple(sem.bm.shape) + (2,)

    def solve(rhs):
        op = lambda w: torch.stack([sem.helmholtz_local(w[..., d], 0.02, 150.0)
                                    for d in range(2)], -1)
        return elliptic_solve(sem, op, rhs, sem.vmask, tol=1e-12, maxiter=200,
                              fdm=(0.02, 150.0))

    b = torch.tensor(rng.standard_normal(shape), requires_grad=True)
    g = torch.as_tensor(rng.standard_normal(shape))
    x = solve(b)
    assert x.grad_fn is not None
    (grad,) = torch.autograd.grad(x, b, grad_outputs=g)
    with torch.no_grad():
        again = solve(g)
    close = lambda a: float((a - again).norm() / again.norm()) < 1e-13
    assert close(grad)
    # torch.func.vjp and torch.func.jvp take the same route
    _, vjp = torch.func.vjp(solve, b.detach())
    assert torch.equal(vjp(g)[0], grad)
    _, tangent = torch.func.jvp(solve, (b.detach(),), (g,))
    assert torch.equal(tangent, again)
    # no tape without a gradient
    assert solve(g).grad_fn is None


def test_cg_solve_backward_with_projection():
    # the pressure-style solve: a projected SPD system (mean removed)
    rng = np.random.default_rng(3)
    A0 = rng.standard_normal((12, 12))
    A = torch.as_tensor(A0 @ A0.T + 12 * np.eye(12))
    project = lambda q: q - q.mean()
    solve = lambda rhs: cg_solve(lambda x: A @ x, rhs, tol=1e-14, maxiter=100,
                                 project=project)
    b = torch.tensor(rng.standard_normal(12), requires_grad=True)
    g = torch.as_tensor(rng.standard_normal(12))
    (grad,) = torch.autograd.grad(solve(b), b, grad_outputs=g)
    assert torch.equal(grad, solve(g).detach())
    # the solve is symmetric: <solve(b), g> = <b, solve(g)>
    assert abs(float(solve(b).detach() @ g - b.detach() @ grad)) < 1e-12


def test_dssum_backward_is_dssum(small_case):
    sem = small_case.sem
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.standard_normal(tuple(sem.bm.shape) + (2,)), requires_grad=True)
    g = torch.as_tensor(rng.standard_normal(tuple(sem.bm.shape) + (2,)))
    (grad,) = torch.autograd.grad(sem.dssum(u), u, grad_outputs=g)
    assert torch.equal(grad, sem.dssum(g))
    assert torch.equal(sem.dssum(u).detach(), sem.dssum(u.detach()))


def test_tangent_propagator_and_dt_override(small_case):
    ns = small_case.make_ns()
    base = small_case.uniform_flow()
    q = small_case.sem.vmask * torch.as_tensor(
        np.random.default_rng(2).standard_normal(tuple(base.shape)))
    dt = 0.7 * ns.dt
    got = make_tangent_propagator(ns, 3)(base, None, q, dt)
    ns2 = dataclasses.replace(small_case, dt=dt).make_ns()
    ref = LinearizedOperator(ns2, base, nsteps=3).matvec(q)
    assert torch.allclose(got, ref, rtol=0, atol=1e-14 * float(ref.abs().max()))
    op = LinearizedOperator(ns, base, nsteps=3, dt=dt)
    assert op.T == pytest.approx(3 * dt)


def test_mixed_rmatvec_matches_jax():
    # once refused (NotImplementedError): the legacy mixed-precision step's
    # adjoint.  Its refined solve now runs inside SymmetricSolve, as JAX's
    # inside lax.custom_linear_solve(symmetric=True): the transpose of each
    # solve is the same refined solve (K4's plain version on the CPU).  A
    # 3 x 3 periodic box at order 4, 3 steps, about a random C0 base
    mesh = box_mesh_2d(3, 3, order=4, x1=2 * np.pi, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    jsem = JaxSEM(mesh)
    jns = JaxNavierStokes(jsem, viscosity=0.05, dt=0.01, mixed_precision=True)
    ns = NavierStokes(sem_from_arrays(sem_arrays(jsem), device="cpu"), viscosity=0.05,
                      dt=0.01, mixed_precision=True)
    assert jns.mixed is not None and ns.mixed is not None and ns._scheme == "laplacian"
    base, q, w = continuous(jsem, 0, 0.1), continuous(jsem, 2), continuous(jsem, 3)
    ref = JaxLinearizedOperator(jns, jnp.asarray(base), nsteps=3).rmatvec(jnp.asarray(w))
    op = LinearizedOperator(ns, torch.as_tensor(base), nsteps=3)
    got = op.rmatvec(torch.as_tensor(w))
    assert rel(got, ref) <= 1e-10, rel(got, ref)
    assert ns.mixed.fused.launches == 0  # CPU: K4's plain version
    bms = ns.sem.bms[..., None]
    a = float(torch.sum(op.matvec(torch.as_tensor(q)) * torch.as_tensor(w) * bms))
    b = float(torch.sum(torch.as_tensor(q) * got * bms))
    assert abs(a - b) <= 1e-12 * max(abs(a), 1.0), (a, b)

"""On a Kovasznay flow (Re 5, Dirichlet data on every side, 3 x 3 elements
at order 4, f64): the port's ``FiniteDifferenceOperator`` against the JAX
package's and against the exact tangent, and ``linear_stability_analysis``
selecting it through ``SolverConfig.finite_difference``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.mesh.mesh import BoundaryCondition as JaxBC
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.stepper.linearized import (
    FiniteDifferenceOperator as JaxFiniteDifferenceOperator,
)
from nekstab_next_tpu_torch.algorithms.stability import linear_stability_analysis
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import (
    FiniteDifferenceOperator,
    make_orbit_tangent_propagator,
)

RE, DT = 5.0, 0.01
CFG = dict(pressure_precond="block", pressure_tol=1e-10, velocity_tol=1e-10)
# the differences divide the propagators' disagreement by eps ~ 1e-6: the
# two packages' solves run to 1e-13 for them
FD_CFG = dict(CFG, pressure_tol=1e-13, velocity_tol=1e-13)
NSTEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and no ``opt_einsum`` path search while this
    module runs (the test suite runs several worker processes at once)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


def kovasznay(x, y):
    lam = RE / 2.0 - np.sqrt(RE ** 2 / 4.0 + 4.0 * np.pi ** 2)
    return np.stack([1.0 - np.exp(lam * x) * np.cos(2 * np.pi * y),
                     lam / (2 * np.pi) * np.exp(lam * x) * np.sin(2 * np.pi * y)], axis=-1)


@pytest.fixture(scope="module")
def kov():
    dirichlet = {side: JaxBC.DIRICHLET for side in ("left", "right", "bottom", "top")}
    mesh = box_mesh_2d(3, 3, order=4, x0=-0.5, x1=1.0, y0=-0.5, y1=1.5, bc=dirichlet)
    jsem = JaxSEM(mesh)
    exact = kovasznay(mesh.x, mesh.y)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=1.0 / RE, dt=DT, u_bc=torch.as_tensor(exact),
                      solver=SolverConfig(**CFG))
    jns = JaxNavierStokes(jsem, viscosity=1.0 / RE, dt=DT, u_bc=jnp.asarray(exact),
                          solver=JaxSolverConfig(**FD_CFG))
    rng = np.random.default_rng(0)
    u0 = exact + np.asarray(jsem.vmask) * np.asarray(
        jsem.dsavg(jnp.asarray(0.02 * rng.standard_normal(exact.shape))))
    q = np.asarray(jsem.vmask) * rng.standard_normal(exact.shape)
    return jns, ns, sem, u0, q


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("order", [2, 4])
def test_finite_difference_operator_matches_jax_and_the_tangent(kov, order):
    """Central differences of the propagator about the perturbed flow: the
    JAX operator's to 1e-10 (the same eps, the same perturbed runs), the
    exact tangent to the differences' accuracy (1e-6), also at the default
    eps."""
    jns, ns, sem, u0, q = kov
    ns = NavierStokes(sem, viscosity=1.0 / RE, dt=DT, u_bc=ns.u_bc, solver=SolverConfig(**FD_CFG))
    # at the default eps_base 1e-6 the two packages' propagators, equal to
    # roundoff, give differences that part at 4e-10 (roundoff / eps); at
    # 1e-4 the roundoff floor sits below the 1e-10 gate
    fd = FiniteDifferenceOperator(ns, torch.as_tensor(u0), nsteps=NSTEPS, order=order,
                                  eps_base=1e-4)
    got = fd.matvec(torch.as_tensor(q)).numpy()
    ref = JaxFiniteDifferenceOperator(jns, jnp.asarray(u0), nsteps=NSTEPS, order=order,
                                      eps_base=1e-4).matvec(jnp.asarray(q))
    assert rel(got, ref) <= 1e-10
    # the propagator's exact Jacobian: the tangent along its trajectory (the
    # perturbed flow is not steady)
    exact = make_orbit_tangent_propagator(ns, NSTEPS)(
        torch.as_tensor(u0), None, torch.as_tensor(q), DT, 0.0)
    assert rel(got, exact.numpy()) <= 1e-6
    default = FiniteDifferenceOperator(ns, torch.as_tensor(u0), nsteps=NSTEPS, order=order)
    assert rel(default.matvec(torch.as_tensor(q)).numpy(), exact.numpy()) <= 1e-6
    with pytest.raises(NotImplementedError, match="no adjoint"):
        fd.rmatvec(torch.as_tensor(q))
    with pytest.raises(ValueError, match="order"):
        FiniteDifferenceOperator(ns, torch.as_tensor(u0), order=3)


def test_stability_analysis_selects_the_finite_difference_operator(kov):
    """``SolverConfig.finite_difference`` routes the direct analysis through
    the finite differences: the same leading eigenvalue as the tangent
    about the frozen base to 1e-3 (the differences follow the evolving
    trajectory from the perturbed flow, the frozen tangent does not)."""
    jns, ns, sem, u0, q = kov
    nsf = NavierStokes(sem, viscosity=1.0 / RE, dt=DT, u_bc=ns.u_bc,
                       solver=SolverConfig(**CFG, finite_difference=True))
    kw = dict(horizon=NSTEPS * DT, nsteps=NSTEPS, k_dim=6, nev=1, tol=1e-6, max_restarts=0)
    a = linear_stability_analysis(nsf, torch.as_tensor(u0), **kw)
    b = linear_stability_analysis(ns, torch.as_tensor(u0), **kw)
    assert abs(a.mu[0] - b.mu[0]) <= 1e-3 * abs(b.mu[0])

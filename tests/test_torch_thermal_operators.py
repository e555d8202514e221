"""The port's coupled ``(u, T)`` tangent operators (``stepper/linearized.py``
with a thermal stepper) against the JAX package's ``jax.linearize`` /
``jax.linear_transpose`` operators on the Rayleigh-Benard case of
``tests/test_scalars.py`` (4 x 2 elements, order 6, f64, solves at
1e-13): the frozen-base ``LinearizedOperator`` and the ``FloquetOperator``
along a short evolving orbit, matvec and rmatvec, and the coupled adjoint
identity."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.rayleigh_benard import RayleighBenardCase as JaxRB
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.stepper.linearized import FloquetOperator as JaxFloquetOperator
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu_torch.cases.rayleigh_benard import RayleighBenardCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import thermal_case_arrays, thermal_case_from_arrays
from nekstab_next_tpu_torch.stepper.linearized import FloquetOperator, LinearizedOperator

TIGHT = dict(velocity_tol=1e-13, pressure_tol=1e-13, scalar_tol=1e-13)
RB = dict(rayleigh=2000.0, prandtl=1.0, nx=4, ny=2, order=6, dt=2.5e-3)
NSTEPS = 5
ORBIT_STEPS = 4


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


@pytest.fixture(scope="module")
def rb():
    """Both packages' RB cases on one SEM, their steppers and two seeded
    admissible coupled vectors (numpy)."""
    jcase = JaxRB(**RB, solver=JaxSolverConfig(**TIGHT))
    case = thermal_case_from_arrays(
        RayleighBenardCase(**RB, solver=SolverConfig(**TIGHT), device="cpu"),
        thermal_case_arrays(jcase))
    s = jcase.sem
    rng = np.random.default_rng(7)
    vm, tm = np.asarray(s.vmask), np.asarray(s.tmask)[..., None]
    mk = lambda: (vm * rng.standard_normal(vm.shape), tm * rng.standard_normal(tm.shape))
    return jcase, jcase.make_ns(), case, case.make_ns(), mk(), mk()


def rel(got, ref) -> float:
    got = np.concatenate([np.asarray(x, np.float64).ravel() for x in got])
    ref = np.concatenate([np.asarray(x, np.float64).ravel() for x in ref])
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def tt(pair):
    return tuple(torch.as_tensor(x) for x in pair)


def jj(pair):
    return tuple(jnp.asarray(x) for x in pair)


def ip(sem, a, b) -> float:
    """The unmasked energy product over both blocks (JAX's test's)."""
    return float(sem.inner(a[0], b[0], masked=False) + sem.inner(a[1], b[1], masked=False))


def test_coupled_linearized_matches_jax_and_adjoint_identity(rb):
    """matvec and rmatvec about the conduction state against JAX's to
    1e-10; <M q, w> = <q, M* w> to 1e-11 (JAX's gate)."""
    jcase, jns, case, ns, q, w = rb
    jop = JaxLinearizedOperator(jns, jcase.base_u, base_T=jcase.base_T, nsteps=NSTEPS)
    op = LinearizedOperator(ns, case.base_u, base_T=case.base_T, nsteps=NSTEPS)
    Mq, Mw = op.matvec(tt(q)), op.rmatvec(tt(w))
    assert isinstance(Mq, tuple) and Mq[1].shape == case.base_T.shape
    assert rel([x.numpy() for x in Mq], jop.matvec(jj(q))) <= 1e-10
    assert rel([x.numpy() for x in Mw], jop.rmatvec(jj(w))) <= 1e-10
    lhs, rhs = ip(case.sem, Mq, tt(w)), ip(case.sem, tt(q), Mw)
    assert abs(lhs - rhs) <= 1e-11 * max(abs(lhs), abs(rhs)), (lhs, rhs)


def test_coupled_floquet_matches_jax(rb):
    """Along the orbit launched from a perturbed conduction state (the base
    evolves: u and T stored each step), matvec and rmatvec against JAX's
    ``jax.linearize`` / ``linear_transpose`` of the trajectory to 1e-10, and
    the monodromy drift."""
    jcase, jns, case, ns, q, w = rb
    b_u = 0.5 * q[0]
    b_T = np.asarray(jcase.base_T) + 0.2 * q[1]
    jop = JaxFloquetOperator(jns, jnp.asarray(b_u), base_T=jnp.asarray(b_T),
                             nsteps=ORBIT_STEPS)
    op = FloquetOperator(ns, torch.as_tensor(b_u), base_T=torch.as_tensor(b_T),
                         nsteps=ORBIT_STEPS)
    Mq, Mw = op.matvec(tt(q)), op.rmatvec(tt(w))
    assert rel([x.numpy() for x in Mq], jop.matvec(jj(q))) <= 1e-10
    assert rel([x.numpy() for x in Mw], jop.rmatvec(jj(w))) <= 1e-10
    assert abs(op.monodromy_drift - float(jop.monodromy_drift)) <= 1e-12 * op.monodromy_drift
    # the orbit differs from the frozen base: the frozen operator is off
    frozen = LinearizedOperator(ns, torch.as_tensor(b_u), base_T=torch.as_tensor(b_T),
                                nsteps=ORBIT_STEPS).matvec(tt(q))
    assert rel([x.numpy() for x in frozen], [x.numpy() for x in Mq]) > 1e-8

"""The port's tangent along an evolving base (``stepper/linearized.py``:
``make_orbit_tangent_propagator``, ``FloquetOperator``, the forcing hook of
``LinearizedOperator``) against central finite differences and against the
JAX package's ``jax.jvp``/``jax.linearize`` operators, on the decaying
Taylor-Green box of ``tests/test_forced_upo.py`` (4 x 4 elements, order 4),
f64, solves at 1e-12."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.stepper.linearized import FloquetOperator as JaxFloquetOperator
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu.stepper.linearized import (
    make_orbit_tangent_propagator as jax_orbit_tangent)
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import (
    FloquetOperator,
    LinearizedOperator,
    make_orbit_tangent_propagator,
)

NU, DT, NSTEPS = 0.1, 0.02, 5
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores.  And no
    ``opt_einsum`` path search: on these tiny tensors it is most of the
    plain step's host time (it changes only the contraction order)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


@pytest.fixture(scope="module")
def box():
    """Both packages' steppers on the Taylor-Green box, the decaying vortex
    (an evolving base) and two seeded perturbations."""
    mesh = box_mesh_2d(4, 4, order=4, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    jsem = JaxSEM(mesh)
    cfg = JaxSolverConfig(**TIGHT)
    jns = JaxNavierStokes(jsem, viscosity=NU, dt=DT, solver=cfg)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=NU, dt=DT, solver=SolverConfig(**dataclasses.asdict(cfg)))
    u0 = np.stack([-np.cos(mesh.x) * np.sin(mesh.y), np.sin(mesh.x) * np.cos(mesh.y)], axis=-1)
    rng = np.random.default_rng(3)
    q, w = (rng.standard_normal(u0.shape) for _ in range(2))
    return mesh, jsem, jns, sem, ns, u0, q, w


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def dot(sem, a, b) -> float:
    """The sponge-masked energy product (bms) of the stability operators."""
    return float(sum(sem.inner(a[..., d], b[..., d]) for d in range(2)))


def test_orbit_tangent_matches_finite_difference_and_jax(box):
    """Along the decaying vortex the stored-orbit tangent is the exact
    Jacobian of the nonlinear propagator: central differences (JAX's gate,
    1e-6) and JAX's ``jax.jvp`` through the trajectory (1e-10); the
    frozen-base tangent is far off there."""
    mesh, jsem, jns, sem, ns, u0, q, _ = box
    tangent = make_orbit_tangent_propagator(ns, NSTEPS)
    u, dq = torch.as_tensor(u0), torch.as_tensor(q)
    got = tangent(u, None, dq, DT, 0.0).numpy()
    eps = 1e-5
    fd = ((ns.propagator(u + eps * dq, NSTEPS, dt=DT)
           - ns.propagator(u - eps * dq, NSTEPS, dt=DT)) / (2 * eps)).numpy()
    err = np.abs(got - fd).max() / np.abs(fd).max()
    assert err < 1e-6, err
    ref = jax_orbit_tangent(jns, NSTEPS)(jnp.asarray(u0), jnp.zeros(jns.p_shape),
                                          jnp.asarray(q), jnp.asarray(DT), jnp.asarray(0.0))
    assert rel(got, ref) <= 1e-10
    frozen = LinearizedOperator(ns, u, nsteps=NSTEPS).matvec(dq).numpy()
    assert rel(frozen, fd) > 1e-4
    # the stored orbit is replayed: a second call equals the first, bit for bit
    assert np.array_equal(tangent(u, None, dq, DT, 0.0).numpy(), got)


def test_floquet_matches_jax_and_its_adjoint_identity(box):
    """FloquetOperator's matvec and rmatvec (W^+ M^T W, W = diag(bms))
    against JAX's ``jax.linearize`` / ``linear_transpose`` on the decaying
    vortex (1e-10), and the adjoint identity in the bms product (1e-12)."""
    mesh, jsem, jns, sem, ns, u0, q, w = box
    jop = JaxFloquetOperator(jns, jnp.asarray(u0), nsteps=NSTEPS)
    op = FloquetOperator(ns, torch.as_tensor(u0), nsteps=NSTEPS)
    dq, dw = torch.as_tensor(q), torch.as_tensor(w)
    Mq, Mw = op.matvec(dq), op.rmatvec(dw)
    assert rel(Mq.numpy(), jop.matvec(jnp.asarray(q))) <= 1e-10
    assert rel(Mw.numpy(), jop.rmatvec(jnp.asarray(w))) <= 1e-10
    assert abs(op.monodromy_drift - float(jop.monodromy_drift)) <= 1e-12
    a, b = dot(sem, Mq, dw), dot(sem, dq, Mw)
    assert abs(a - b) <= 1e-12 * abs(a), (a, b)


def test_floquet_on_a_steady_base_is_the_linearized_operator(box):
    """About a uniform flow (a steady state of the periodic box) the orbit
    is constant, so the Floquet operator is the frozen-base one, forward and
    adjoint (the analog of tests/test_linearized.py:91)."""
    mesh, jsem, jns, sem, ns, u0, q, w = box
    base = torch.zeros(u0.shape, dtype=torch.float64)
    base[..., 0], base[..., 1] = 1.0, 0.5
    flo = FloquetOperator(ns, base, nsteps=NSTEPS)
    lin = LinearizedOperator(ns, base, nsteps=NSTEPS)
    dq, dw = torch.as_tensor(q), torch.as_tensor(w)
    assert rel(flo.matvec(dq).numpy(), lin.matvec(dq).numpy()) <= 1e-12
    assert rel(flo.rmatvec(dw).numpy(), lin.rmatvec(dw).numpy()) <= 1e-12
    assert flo.monodromy_drift <= 1e-12


def test_linearized_operator_with_a_forcing_hook_matches_jax(box):
    """A pointwise, time-dependent, nonlinear forcing hook: JAX linearizes
    it at the frozen base and at t0 for every step; so does the port
    (``torch.func.jvp`` of the hook).  Its adjoint satisfies the identity
    (JAX's transpose is not compiled: it would add 14 s to the test)."""
    mesh, jsem, jns, sem, ns, u0, q, w = box
    t0 = 0.3
    jns_f = JaxNavierStokes(jsem, viscosity=NU, dt=DT, solver=jns.solver,
                            forcing=lambda u, t: -0.5 * jnp.cos(t) * u ** 3)
    ns_f = NavierStokes(sem, viscosity=NU, dt=DT, solver=ns.solver,
                        forcing=lambda u, t: -0.5 * math.cos(t) * u ** 3)
    jop = JaxLinearizedOperator(jns_f, jnp.asarray(u0), nsteps=3, t0=t0)
    op = LinearizedOperator(ns_f, torch.as_tensor(u0), nsteps=3, t0=t0)
    got = op.matvec(torch.as_tensor(q)).numpy()
    assert rel(got, jop.matvec(jnp.asarray(q))) <= 1e-10
    dq, dw = torch.as_tensor(q), torch.as_tensor(w)
    a, b = dot(sem, op.matvec(dq), dw), dot(sem, dq, op.rmatvec(dw))
    assert abs(a - b) <= 1e-12 * abs(a), (a, b)
    # the hook's tangent is in: the unforced operator differs
    plain = LinearizedOperator(ns, torch.as_tensor(u0), nsteps=3, t0=t0)
    assert rel(plain.matvec(torch.as_tensor(q)).numpy(), got) > 1e-3

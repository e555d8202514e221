"""The port's resolvent (``algorithms/resolvent.py``) against the analytic
Stokes resolvent, against the JAX package's ``ResolventOperator.matvec``
(host GMRES) on the same seeded inputs, and against its own adjoint
identity; f64, solves at 1e-12, on periodic boxes cut from the JAX
tests' 4 x 4 elements at order 6 for the test's time (2 x 2 at order 6
for the analytic gate, at order 4 on seeded noise).

``resolvent_analysis`` is tested in ``tests/test_torch_resolvent_analysis.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms.resolvent import ResolventOperator as JaxResolventOperator
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.algorithms.resolvent import (
    FloquetResolventOperator,
    ResolventOperator,
)
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes

NU, OMEGA = 0.5, 0.7
OMEGA_C = 4.0  # the seeded-noise tests: T = 1.57, 8 steps, CFL ~0.3
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


def make_box(order):
    mesh = box_mesh_2d(2, 2, order=order, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    jsem = JaxSEM(mesh)
    cfg = JaxSolverConfig(**TIGHT)
    jns = JaxNavierStokes(jsem, viscosity=NU, dt=0.01, solver=cfg)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=NU, dt=0.01, solver=SolverConfig(**dataclasses.asdict(cfg)))
    return mesh, jsem, jns, sem, ns


@pytest.fixture(scope="module")
def box():
    return make_box(6)


@pytest.fixture(scope="module")
def small_box():
    return make_box(4)


def drift(sem):
    """A uniform base flow (convection in the tangent), slow enough for the
    CFL number of 8 steps a period at OMEGA_C."""
    base = torch.zeros(tuple(sem.bm.shape) + (2,), dtype=torch.float64)
    base[..., 0], base[..., 1] = 0.2, 0.1
    return base


def shear_forcing(mesh):
    """fhat = (0, e^{i x}): the k = (1, 0) shear mode."""
    x = torch.as_tensor(mesh.x)
    zero = torch.zeros_like(x)
    return torch.stack([zero, torch.cos(x)], -1), torch.stack([zero, torch.sin(x)], -1)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def cdot(sem, a, b) -> float:
    """<a, b> in the plain mass product bm over (re, im) pairs."""
    return float(sum(sem.inner(x[..., d], y[..., d], masked=False)
                     for x, y in zip(a, b) for d in range(2)))


def test_resolvent_matvec_analytic(box):
    """tests/test_resolvent.py:22: the Stokes resolvent of the shear mode,
    uhat = fhat / (i w + nu), at 64 steps a period (the real part is
    third order in dt, the imaginary part second: the quarter-period
    propagation restarts the BDF ramp)."""
    mesh, _, _, sem, ns = box
    base = torch.zeros(tuple(sem.bm.shape) + (2,), dtype=torch.float64)
    op = ResolventOperator(ns, base, OMEGA, steps_per_period=64, gmres_kdim=20,
                           gmres_tol=1e-10)
    f_re, f_im = shear_forcing(mesh)
    u_re, u_im = op.matvec((f_re, f_im))
    uhat = 1.0 / (1j * OMEGA + NU)
    x = torch.as_tensor(mesh.x)
    ue_re = uhat.real * torch.cos(x) - uhat.imag * torch.sin(x)
    ue_im = uhat.real * torch.sin(x) + uhat.imag * torch.cos(x)
    scale = float(sem.norm(ue_re))
    assert float(sem.norm(u_re[..., 1] - ue_re)) / scale < 1.5e-3
    assert float(sem.norm(u_im[..., 1] - ue_im)) / scale < 5e-3
    assert float(sem.norm(u_re[..., 0])) < 1e-10 * scale


def test_matvec_matches_jax_and_floquet_on_a_steady_base(small_box):
    """R(omega) about a uniform flow on seeded forcing, 8 steps a period,
    GMRES to 1e-12: the port against JAX's ``matvec`` (1e-8); the Floquet
    resolvent about that steady orbit equals the steady one
    (tests/test_resolvent.py:62), and a frequency that is no harmonic of
    the base period is refused."""
    mesh, jsem, jns, sem, ns = small_box
    base = drift(sem)
    rng = np.random.default_rng(5)
    f = [rng.standard_normal(tuple(base.shape)) for _ in range(2)]
    kw = dict(steps_per_period=8, gmres_kdim=20, gmres_tol=1e-12)
    ref = JaxResolventOperator(jns, jnp.asarray(base.numpy()), OMEGA_C, **kw).matvec(
        tuple(jnp.asarray(x) for x in f))
    fpair = tuple(torch.as_tensor(x) for x in f)
    got = ResolventOperator(ns, base, OMEGA_C, **kw).matvec(fpair)
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r) <= 1e-8
    # the Floquet operator's forced and homogeneous integrations (all
    # that R(omega) is made of) are the steady operator's
    steady = ResolventOperator(ns, base, OMEGA_C, **kw)
    flo = FloquetResolventOperator(ns, base, OMEGA_C, **kw)
    assert flo.monodromy_drift < 1e-12
    assert rel(flo._apply(fpair).numpy(), steady._apply(fpair).numpy()) <= 1e-12
    assert rel(flo._homogeneous(fpair[0]).numpy(),
               steady._homogeneous(fpair[0]).numpy()) <= 1e-12
    with pytest.raises(ValueError, match="not a harmonic"):
        FloquetResolventOperator(ns, base, OMEGA_C, base_period=10.0, steps_per_period=16)


def test_resolvent_adjoint_identity(small_box):
    """<R f, u> = <f, R* u> in the bm product, GMRES at 1e-12 both ways, on
    seeded pairs about a uniform flow, 8 steps a period (the reference's
    own check stops at 1.065e-3 against its 1e-3 gate: its fixed-iteration
    solve)."""
    mesh, _, _, sem, ns = small_box
    base = drift(sem)
    op = ResolventOperator(ns, base, OMEGA_C, steps_per_period=8, gmres_kdim=20,
                           gmres_tol=1e-12)
    rng = np.random.default_rng(3)
    x, y = ([torch.as_tensor(rng.standard_normal(tuple(base.shape))) for _ in range(2)]
            for _ in range(2))
    a1 = cdot(sem, op.matvec(x), y)
    a2 = cdot(sem, x, op.rmatvec(y))
    assert abs(a1 - a2) <= 1e-8 * abs(a1), (a1, a2)

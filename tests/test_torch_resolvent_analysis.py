"""The port's ``resolvent_analysis`` (``algorithms/resolvent.py``) on the
Stokes resolvent of a periodic box (2 x 2 elements at order 4), f64,
solves at 1e-12.

JAX's ``resolvent_analysis`` is not run: its transposable fixed-iteration
``matvec_pure`` does not compile for the CPU (LLVM runs out of section
memory even at 2 x 2 elements and 8 steps a period).  The port's gain is
held to JAX's ``matvec`` applied to the port's optimal forcing (a
Golub-Kahan Ritz pair satisfies R v = sigma u exactly, converged or not)
and to the gain of the continuous problem's optimal forcing, which it must
not fall below."""

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
from nekstab_next_tpu_torch.algorithms import resolvent_analysis
from nekstab_next_tpu_torch.algorithms.resolvent import ResolventOperator
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes


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


def periodic_box(nu: float, dt: float):
    """Both packages' steppers on the periodic 2 x 2 box at order 4."""
    mesh = box_mesh_2d(2, 2, order=4, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    jsem = JaxSEM(mesh)
    cfg = JaxSolverConfig(pressure_tol=1e-12, velocity_tol=1e-12)
    jns = JaxNavierStokes(jsem, viscosity=nu, dt=dt, solver=cfg)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=nu, dt=dt, solver=SolverConfig(**dataclasses.asdict(cfg)))
    return mesh, jsem, jns, sem, ns


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def cdot(sem, a, b) -> float:
    """<a, b> in the energy product over (re, im) pairs."""
    return float(sum(sem.inner(x[..., d], y[..., d]) for x, y in zip(a, b) for d in range(2)))


def test_resolvent_analysis_gain():
    """resolvent_analysis of the Stokes resolvent at omega = 1 (8 steps a
    period, four Golub-Kahan steps, one pass at svds tolerance 0.1): JAX's
    ``matvec`` on the port's optimal forcing returns the port's gain and
    response mode (1e-8), and the gain is no less than that of the shear
    mode fhat = (0, e^{i x}), the continuous problem's optimal forcing."""
    mesh, jsem, jns, sem, ns = periodic_box(0.5, 0.01)
    base = np.zeros(tuple(sem.bm.shape) + (2,))
    res = resolvent_analysis(ns, torch.as_tensor(base), 1.0, nsv=1, k_dim=4, tol=0.1,
                             steps_per_period=8)
    sigma = float(res.sigma[0])
    f = res.forcing_modes[0]
    jop = JaxResolventOperator(jns, jnp.asarray(base), 1.0, steps_per_period=8,
                               gmres_kdim=20, gmres_tol=1e-12)
    r = tuple(torch.as_tensor(np.asarray(x))
              for x in jop.matvec(tuple(jnp.asarray(x.numpy()) for x in f)))
    gain = np.sqrt(cdot(sem, r, r) / cdot(sem, f, f))
    assert abs(gain - sigma) <= 1e-8 * sigma, (gain, sigma)
    for a, b in zip(res.response_modes[0], r):
        assert rel(a.numpy(), (b / sigma).numpy()) <= 1e-6
    x = torch.as_tensor(mesh.x)
    zero = torch.zeros_like(x)
    shear = (torch.stack([zero, torch.cos(x)], -1), torch.stack([zero, torch.sin(x)], -1))
    op = ResolventOperator(ns, torch.as_tensor(base), 1.0, steps_per_period=8,
                           gmres_kdim=20, gmres_tol=1e-12)
    u = op.matvec(shear)
    g_shear = np.sqrt(cdot(sem, u, u) / cdot(sem, shear, shear))
    assert sigma >= g_shear * (1 - 1e-8), (sigma, g_shear)

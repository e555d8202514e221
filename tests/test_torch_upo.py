"""The port's Newton for forced periodic orbits (``algorithms/newton.py``,
``forced=True``) against the JAX package's, and the period helpers of
``utils/diagnostics.py`` on the TPU run's lift series.  f64, at the
reference test's own solver settings (the defaults, 1e-8 / 1e-9): the
80-step period and its Newton take about 1,700 steps, the port's CPU step
is host-bound, and the file must stay under a minute."""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms import newton_krylov as jax_newton_krylov
from nekstab_next_tpu.config import NewtonConfig as JaxNewtonConfig
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.utils.diagnostics import periods_from_signal as jax_periods
from nekstab_next_tpu_torch.algorithms import newton_krylov
from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.utils import periods_from_signal, zero_crossings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_forced_periodic_orbit_matches_jax():
    """tests/test_forced_upo.py:55 on the port: two forced shear modes
    coupled by convection, the period fixed at the forcing's, 80 steps a
    period (the amplitude gate needs them; the box is cut to 2 x 2
    elements for the test's time).  Gates: residual < 1e-9, the orbit is
    periodic, the quadrature amplitude within 1 % of the analytic linear
    response, and the first three residuals within 1e-8 of JAX's."""
    mesh = box_mesh_2d(2, 2, order=4, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    nu, Tf, A, nsteps = 0.1, 1.0, 0.4, 80
    om = 2 * np.pi / Tf
    f1 = np.stack([np.sin(mesh.y), np.zeros_like(mesh.y)], -1)
    f2 = np.stack([np.zeros_like(mesh.x), np.sin(mesh.x)], -1)
    jsem = JaxSEM(mesh)
    cfg = JaxSolverConfig()
    jf1, jf2 = jnp.asarray(f1), jnp.asarray(f2)
    jns = JaxNavierStokes(jsem, viscosity=nu, dt=Tf / nsteps, solver=cfg,
                          forcing=lambda u, t: A * jnp.cos(om * t) * jf1
                          + A * jnp.sin(om * t) * jf2)
    ref = jax_newton_krylov(jns, jnp.zeros_like(jf1), horizon=Tf, nsteps=nsteps, forced=True,
                            cfg=JaxNewtonConfig(tol=1e-10, max_iter=3), k_dim=30)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    tf1, tf2 = torch.as_tensor(f1), torch.as_tensor(f2)
    ns = NavierStokes(sem, viscosity=nu, dt=Tf / nsteps,
                      solver=SolverConfig(**dataclasses.asdict(cfg)),
                      forcing=lambda u, t: A * math.cos(om * t) * tf1 + A * math.sin(om * t) * tf2)
    res = newton_krylov(ns, torch.zeros_like(tf1), horizon=Tf, nsteps=nsteps, forced=True,
                        cfg=NewtonConfig(tol=1e-10, max_iter=12), k_dim=30)
    assert res.converged and res.residual < 1e-9, res.history
    assert res.period == Tf
    for (i, r, T), (ji, jr, jT) in zip(res.history[:3], ref.history):
        assert i == ji and T == jT and abs(r - jr) <= 1e-8, (r, jr)
    phi = ns.propagator(res.u, nsteps, dt=Tf / nsteps)
    assert float(sem.norm(phi - res.u)) < 1e-9
    # the quadrature amplitude a(T/4) = A w / (nu^2 + w^2) of mode f1
    uq = ns.propagator(res.u, nsteps // 4, dt=Tf / nsteps)
    aq = float(sum(sem.inner(uq[..., d], tf1[..., d]) for d in range(2))
               / sum(sem.inner(tf1[..., d], tf1[..., d]) for d in range(2)))
    aq_lin = A * om / (nu ** 2 + om ** 2)
    assert abs(aq - aq_lin) < 0.01 * abs(aq_lin), (aq, aq_lin)


def test_period_of_the_tpu_lift_series():
    """examples/cylinder_upo.py's period estimate from its saved lift
    series: the mean of the last three periods over the last 40 % of the
    signal is the TPU run's 5.946532286312002, and the helpers are JAX's."""
    t, cl = np.loadtxt(os.path.join(ROOT, "upo_out", "lift_series.dat")).T
    i0 = int(0.6 * len(t))
    Ts = periods_from_signal(t[i0:], cl[i0:])
    assert np.array_equal(Ts, jax_periods(t[i0:], cl[i0:]))
    assert float(np.mean(Ts[-3:])) == 5.946532286312002
    # a sampled sine: upward crossings at the zeros of sin(2 pi t / 3)
    tt = np.linspace(0.05, 10.0, 400)
    zc = zero_crossings(tt, np.sin(2 * np.pi * tt / 3.0))
    np.testing.assert_allclose(zc, [3.0, 6.0, 9.0], atol=1e-3)

"""The port's bordered Newton for unstable periodic orbits
(``algorithms/newton.py``, ``upo=True``: the period column, the phase row,
the (velocity, period) space) against the JAX package's on the 32-element
cylinder, f64, solves at 1e-12."""

import dataclasses

import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms import newton_krylov as jax_newton_krylov
from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase
from nekstab_next_tpu.config import NewtonConfig as JaxNewtonConfig
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu_torch.algorithms import newton_krylov
from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
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


def test_bordered_upo_iterations_match_jax():
    """Two bordered UPO iterations on the 32-element cylinder (order 4 for
    the test's time) from a developing wake at a 40-step horizon, with a
    two-vector Krylov space, so neither update reaches the trivial orbit
    T -> 0 that a full solve off any orbit heads for: the residuals, the
    periods, the matvec count and the iterate against JAX's (1e-8)."""
    cfg = JaxSolverConfig(pressure_tol=1e-12, velocity_tol=1e-12, pressure_precond="block")
    jcase = JaxCylinderCase(nr=4, ntheta=8, order=4, solver=cfg)
    jns = jcase.make_ns()
    u0 = jns.propagator(jcase.uniform_flow(), 60)
    kw = dict(horizon=40 * jcase.dt, nsteps=40, upo=True, k_dim=2)
    newton = dict(tol=0.0, max_iter=2, gmres_restarts=1)
    ref = jax_newton_krylov(jns, u0, cfg=JaxNewtonConfig(**newton), **kw)
    sem = sem_from_arrays(sem_arrays(jcase.sem), device="cpu")
    ns = NavierStokes(sem, viscosity=jns.nu, dt=jns.dt,
                      u_bc=torch.as_tensor(np.array(jcase.u_bc)),
                      sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
                      solver=SolverConfig(**dataclasses.asdict(cfg)))
    got = newton_krylov(ns, torch.as_tensor(np.array(u0)), cfg=NewtonConfig(**newton), **kw)
    assert got.n_matvecs == ref.n_matvecs and not got.converged
    assert len(got.history) == len(ref.history) == 2
    for (i, r, T), (ji, jr, jT) in zip(got.history, ref.history):
        assert i == ji and abs(r - jr) <= 1e-8 * jr and abs(T - jT) <= 1e-8 * jT
    assert min(T for _, _, T in got.history) > 0.0 and got.period != kw["horizon"]
    assert abs(got.period - ref.period) <= 1e-8 * abs(ref.period)
    ju = np.asarray(ref.u)
    assert np.linalg.norm(got.u.numpy() - ju) <= 1e-8 * np.linalg.norm(ju)
